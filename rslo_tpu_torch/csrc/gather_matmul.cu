// Gather-GEMM sparse-conv apply for NVIDIA Hopper (sm_90a), over a
// rulebook:
//
//   out[v, :] = sum_k valid[v, k] * f[idx[v, k], :] @ W[k]   (+ bias,
//               then zeroed where out_mask[v] is false)
//
// Replaces the TPU Pallas kernel rslo_tpu/ops/dma_gather.py::
// dma_gather_matmul (_gather_matmul_kernel), which computes the same
// contract as rslo_tpu/ops/sparse_conv.py::sparse_conv_apply.  The plain
// PyTorch version is rslo_tpu_torch/ops/sparse_conv.py::sparse_conv_apply.
//
// The kernel body is csrc/gather_gemm.cuh, shared with the band engine's
// conv (csrc/band_conv.cu); this file holds the rulebook's row-source
// policy and the C entry point.  What bounds it on this card: the random
// row gathers through idx (one 28-256 byte row from L2 per valid (row,
// tap) pair, ~1.6 valid taps of 27 per row at L0 on the synthetic scans)
// and their latency, not the math (16 x 16 to 64 x 64 multiply-adds per
// pair, far below the H100's bf16 ridge point).  What the design does
// about it (gather_gemm.cuh has the whole note): a block reads its
// (64, K) rectangle of idx/valid once, contiguous and coalesced, lists
// the taps its rows use, and gathers the next taps' rows with cp.async
// while mma.sync (bf16) or f32 FMAs (f32) work on the current one.
//
// Modes: 0 f32 operands; 1 bf16 operands (the main path, conv_dtype
// "bf16"); 2 the feature gradient of a bf16 conv,
//   d_f[u] = sum_k valid_t[u,k] * bf16( ct[idx_t[u,k]] @ W_t[k] )
// over the transposed rulebook (idx_t, valid_t), with W_t[k] the
// pre-rounded, transposed (and for a submanifold conv tap-flipped)
// weights: the gathered cotangent rows stay f32 and each tap's Cin-vector
// is rounded to bf16 before it joins the f32 sum, as JAX's autodiff of
// sparse_conv_apply does (each partial from exact hi/mid/lo bf16 pieces
// of the rows on the tensor cores; gather_gemm.cuh says how an entry near
// a bf16 rounding tie is kept on its reference's side).  The plain
// version of mode 2 is
// rslo_tpu_torch/ops/sparse_conv.py::sparse_conv_dgrad.

#include "gather_gemm.cuh"

namespace {

// The rulebook's sources: row v at tap k reads idx[v, k] where valid.
// Rows are in range by construction; the clamp keeps a bad index from
// faulting, as JAX's gather clamps.  (row, tap) order with the tap
// fastest reads the (64, K) rectangle contiguously.
struct RulebookRows {
  const int32_t* idx;
  const uint8_t* valid;
  static constexpr bool kTapFastest = true;
  static constexpr bool kFeatureGradient = true;

  __device__ __forceinline__ int source(int v, int k, int K,
                                        int Vin) const {
    const int64_t e = (int64_t)v * K + k;
    const int s = min(max(idx[e], 0), Vin - 1);   // both loads issued
    return valid[e] ? s : -1;
  }
};

}  // namespace

extern "C" {

int gather_matmul_max_channels() { return gather_gemm::MAX_C; }

// The dynamic shared memory (bytes) a launch over V rows takes, and its
// cp.async stages in *stages; -1 for shapes the kernel does not take.
int gather_matmul_shared_bytes(int V, int K, int Cin, int Cout, int* stages) {
  return gather_gemm::shared_bytes(V, K, Cin, Cout, stages);
}

// All pointers are device pointers; bias and out_mask may be null.
// mode: 0 f32, 1 bf16 operands, 2 bf16 feature gradient (see above).
// Returns cudaGetLastError() after the launch (0 = launched).
int gather_matmul_launch(const void* features, const void* idx,
                         const void* valid, const void* weights,
                         const void* bias, const void* out_mask, void* out,
                         int Vin, int V, int K, int Cin, int Cout, int mode,
                         void* stream) {
  const RulebookRows src{static_cast<const int32_t*>(idx),
                         static_cast<const uint8_t*>(valid)};
  return gather_gemm::launch(
      static_cast<const float*>(features), src,
      static_cast<const float*>(weights), static_cast<const float*>(bias),
      static_cast<const uint8_t*>(out_mask), static_cast<float*>(out), Vin,
      V, K, Cin, Cout, mode, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
