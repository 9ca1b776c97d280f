// Gather-GEMM sparse-conv apply for NVIDIA Hopper (sm_90a).
//
//   out[v, :] = sum_k valid[v, k] * f[idx[v, k], :] @ W[k]   (+ bias,
//               then zeroed where out_mask[v] is false)
//
// Replaces the TPU Pallas kernel rslo_tpu/ops/dma_gather.py::
// dma_gather_matmul (_gather_matmul_kernel), which computes the same
// contract as rslo_tpu/ops/sparse_conv.py::sparse_conv_apply.  The plain
// PyTorch version is rslo_tpu_torch/ops/sparse_conv.py::sparse_conv_apply.
//
// What bounds it on this card: the random row gathers.  An L0
// submanifold conv at KITTI scale reads up to 40000 x 27 ~ 1.1 M rows of
// 28-256 bytes each through idx, against ~0.3 GFLOP of multiply-adds
// (16 x 16 per row), so it is far below the H100's bf16 ridge point and
// is bound by the number of gathered rows and the latency of each.  The
// feature array (<= 2.6 MB at L0) stays resident in the 50 MB L2, so the
// gathers are L2 transactions rather than HBM ones.
//
// What the design does about it:
//   * invalid taps are skipped, not multiplied by 0: their rows are never
//     read (most of the 27 taps of a sparse scan are empty), and a NaN in
//     an unread row cannot leak into the sum;
//   * a tap that no row of the tile uses is skipped by the whole block;
//   * rows are gathered once into shared memory per (tile, tap) and
//     reused by every output column; W[k] is staged in shared memory;
//   * the sums stay in fp32 registers for all K taps, and the bias and
//     out_mask are applied in the epilogue, so the output is written once.
// wgmma/TMA pipelining is left to later work: this is the simple, correct
// design (one block per tile of output rows, a loop over taps).
//
// Operands are rounded to the compute dtype (bf16 round-to-nearest-even,
// or kept f32) and multiplied in fp32: the product of two bf16 values is
// exact in fp32, so the kernel and the plain version differ only in the
// order of their fp32 sums.
//
// The backward mode (MODE_BF16_DGRAD) computes the feature gradient of a
// bf16 sparse conv as JAX's autodiff of sparse_conv_apply does:
//   d_f[u] = sum_k valid_t[u,k] * bf16( ct[idx_t[u,k]] @ W_t[k] )
// over the transposed rulebook (idx_t, valid_t), with W_t[k] the
// pre-rounded, transposed (and for a submanifold conv tap-flipped)
// weights.  The gathered cotangent rows stay f32, and each tap's
// Cin-vector is rounded to bf16 before it joins the f32 sum.  Each
// output row is owned by one block, so no atomics are needed and the
// result is deterministic.  The plain version is
// rslo_tpu_torch/ops/sparse_conv.py::sparse_conv_dgrad.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_V = 64;     // output rows per block
constexpr int THREADS = 256;
constexpr int MAX_C = 64;      // widest Cin / Cout taken
constexpr int ACC = TILE_V * MAX_C / THREADS;   // outputs per thread

// f32 operands; bf16-rounded operands; bf16 feature-gradient mode
enum Mode { MODE_F32 = 0, MODE_BF16 = 1, MODE_BF16_DGRAD = 2 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int MODE>
__device__ __forceinline__ float round_operand(float x) {
  return MODE == MODE_BF16 ? round_bf16(x) : x;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
gather_matmul_kernel(const float* __restrict__ features,
                     const int32_t* __restrict__ idx,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ weights,
                     const float* __restrict__ bias,
                     const uint8_t* __restrict__ out_mask,
                     float* __restrict__ out,
                     int Vin, int V, int K, int Cin, int Cout) {
  __shared__ float g_s[TILE_V * MAX_C];   // gathered rows, [row][cin]
  __shared__ float w_s[MAX_C * MAX_C];    // W[k], [cin][cout]
  __shared__ int src_s[TILE_V];           // source row, -1 = invalid tap

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TILE_V;
  const int rows = min(TILE_V, V - row0);
  const int n_out = rows * Cout;

  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.f;

  for (int k = 0; k < K; ++k) {
    int used = 0;
    if (tid < TILE_V) {
      int s = -1;
      if (tid < rows) {
        const int64_t e = (int64_t)(row0 + tid) * K + k;
        if (valid[e]) {
          // rulebook rows are in range by construction; the clamp keeps a
          // bad index from faulting, as JAX's gather clamps
          s = min(max(idx[e], 0), Vin - 1);
        }
      }
      src_s[tid] = s;
      used = s >= 0;
    }
    if (!__syncthreads_or(used)) continue;   // tap empty for the whole tile

    const float* wk = weights + (int64_t)k * Cin * Cout;
    for (int e = tid; e < Cin * Cout; e += THREADS)
      w_s[e] = round_operand<MODE>(wk[e]);
    for (int e = tid; e < rows * Cin; e += THREADS) {
      const int r = e / Cin;
      const int c = e - r * Cin;
      const int s = src_s[r];
      if (s >= 0) g_s[e] = round_operand<MODE>(features[(int64_t)s * Cin + c]);
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      const int o = tid + j * THREADS;
      if (o < n_out) {
        const int r = o / Cout;
        const int c = o - r * Cout;
        if (src_s[r] >= 0) {
          const float* gr = g_s + r * Cin;
          if (MODE == MODE_BF16_DGRAD) {
            float a = 0.f;   // this tap's partial, rounded on its own
            for (int ci = 0; ci < Cin; ++ci)
              a = fmaf(gr[ci], w_s[ci * Cout + c], a);
            acc[j] += round_bf16(a);
          } else {
            float a = acc[j];
            for (int ci = 0; ci < Cin; ++ci)
              a = fmaf(gr[ci], w_s[ci * Cout + c], a);
            acc[j] = a;
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    const int o = tid + j * THREADS;
    if (o < n_out) {
      const int r = o / Cout;
      const int c = o - r * Cout;
      const int v = row0 + r;
      float y = acc[j];
      if (bias != nullptr) y += bias[c];
      if (out_mask != nullptr && !out_mask[v]) y = 0.f;
      out[(int64_t)v * Cout + c] = y;
    }
  }
}

}  // namespace

extern "C" {

int gather_matmul_max_channels() { return MAX_C; }

// All pointers are device pointers; bias and out_mask may be null.
// mode: 0 f32, 1 bf16 operands, 2 bf16 feature gradient (see above).
// Returns cudaGetLastError() after the launch (0 = launched).
int gather_matmul_launch(const void* features, const void* idx,
                         const void* valid, const void* weights,
                         const void* bias, const void* out_mask, void* out,
                         int Vin, int V, int K, int Cin, int Cout, int mode,
                         void* stream) {
  if (V <= 0 || Vin <= 0 || K <= 0 || Cin <= 0 || Cout <= 0 ||
      Cin > MAX_C || Cout > MAX_C || mode < MODE_F32 ||
      mode > MODE_BF16_DGRAD)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((V + TILE_V - 1) / TILE_V);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(features);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const uint8_t* va = static_cast<const uint8_t*>(valid);
  const float* w = static_cast<const float*>(weights);
  const float* b = static_cast<const float*>(bias);
  const uint8_t* m = static_cast<const uint8_t*>(out_mask);
  float* o = static_cast<float*>(out);
  if (mode == MODE_BF16)
    gather_matmul_kernel<MODE_BF16><<<grid, THREADS, 0, s>>>(
        f, ix, va, w, b, m, o, Vin, V, K, Cin, Cout);
  else if (mode == MODE_BF16_DGRAD)
    gather_matmul_kernel<MODE_BF16_DGRAD><<<grid, THREADS, 0, s>>>(
        f, ix, va, w, b, m, o, Vin, V, K, Cin, Cout);
  else
    gather_matmul_kernel<MODE_F32><<<grid, THREADS, 0, s>>>(
        f, ix, va, w, b, m, o, Vin, V, K, Cin, Cout);
  return (int)cudaGetLastError();
}

}  // extern "C"
