// Banded sparse-conv kernels for NVIDIA Hopper (sm_90a): the band engine's
// conv (B4) and its im2col gather (B5).
//
// A band plan (rslo_tpu_torch/ops/band_conv.py::BandIndex) cuts the Vp
// output rows into blocks of B rows.  For block b and tap k it holds a
// window start base[b, k] and, per row r of the block, the offset
// sel[b, k, r] of the row's input inside the window (-1 when the tap is
// invalid or its input lies outside the window).  Output row v = b*B + r
// at tap k thus reads input row base[b, k] + sel[b, k, r].
//
//   B4  band_matmul:  out[v, :] = sum_k [sel >= 0] rnd(f[base + sel]) @ rnd(W[k])
//       (Vp, Cout) f32.  Replaces the TPU Pallas kernel
//       rslo_tpu/ops/band_conv.py::_windowed_pallas_conv.  The plain
//       PyTorch version is ops/band_conv.py::band_conv_plain.
//   B5  band_gather:  g[v, k*Cin:(k+1)*Cin] = rnd(f[base + sel]), or 0 where
//       sel is -1; (Vp, K*Cin) in the compute dtype.  Replaces
//       _windowed_pallas_gather; plain version band_gather_plain.
//
// rnd() rounds to the compute dtype (bf16 round-to-nearest-even, or keeps
// f32).  The product of two bf16 values is exact in f32, so B4 and its
// plain version differ only in the order (and, on the tensor cores, the
// truncation inside one 16-deep MMA) of their f32 sums; B5 is a copy and
// bit-equal to its plain version.
//
// What bounds them on this card.  B4 reads one feature row per valid
// (row, tap) pair, 28-256 bytes each, against Cin*Cout multiply-adds per
// pair: at most 64 x 64 = 4096 per 256-byte row, far below the H100's
// bf16 ridge point (~295 operations per byte), so the row gathers from L2
// and their latency bound it (the features, <= 10.5 MB at L0 in f32, stay
// in the 50 MB L2).  B5 moves bytes only: the selected rows in, the
// (Vp, K*Cin) im2col out, which is written whole (zeros included) and
// dominates.
//
// What the design does about it.  The TPU kernel double-buffered whole
// (W, Cin) windows into VMEM and selected rows with a one-hot product on
// the MXU, because the TPU gathers slowly.  Hopper gathers rows cheaply,
// and a 1280-row window at 64 channels would take 160 KB of shared memory
// in bf16 and leave one block per SM.  So B4 is the gather-GEMM of
// csrc/gather_gemm.cuh, shared with B1, with the plan's (base, sel) as its
// row-source policy: a block of 64 output rows reads base[b, :] and the
// 64-row slices of sel[b, k, :] once (coalesced; a tile may straddle two
// plan blocks when B is not a multiple of 64), lists the taps its rows
// use, gathers the next taps' selected rows and W[k] with cp.async while
// mma.sync works on the current tap, and writes its rows once.  A row
// behind sel = -1 is never copied, and the math masks its slot to zero,
// so a NaN there cannot reach a sum.  Why mma.sync and not wgmma/TMA is in
// gather_gemm.cuh.  B5 is a grid-stride copy with the output's flat index
// on the threads, so the writes (its bytes) are coalesced.
//
// The submanifold d_features of the band engine is B4 again, run over the
// same plan with the cotangent as the features and the tap-flipped,
// transposed weights (the plan of a submanifold rulebook is its own
// transpose); ops/band_conv.py counts those launches apart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gather_gemm.cuh"

namespace {

constexpr int THREADS = 256;   // threads per block of B5

// Input row of output row v at tap k, or -1 for none.  base and sel come
// from the plan builder, which keeps base + sel inside [0, Vin); the clamp
// only keeps a bad plan from faulting.
__device__ __forceinline__ int band_source(const int32_t* __restrict__ base,
                                           const int32_t* __restrict__ sel,
                                           int v, int k, int K, int B,
                                           int Vin) {
  const int b = v / B;
  const int r = v - b * B;
  const int64_t bk = (int64_t)b * K + k;
  const int s = sel[bk * B + r];
  if (s < 0) return -1;
  return min(max(base[bk] + s, 0), Vin - 1);
}

// B4's row-source policy: the plan's base + sel.  (tap, row) order with
// the row fastest reads each 64-row slice of sel[b, k, :] contiguously.
struct BandRows {
  const int32_t* base;
  const int32_t* sel;
  int B;
  static constexpr bool kTapFastest = false;
  // B4's feature gradient is B4 itself on the rounded cotangent (MODE_BF16)
  static constexpr bool kFeatureGradient = false;

  __device__ __forceinline__ int source(int v, int k, int K, int Vin) const {
    const int b = v / B;
    const int64_t bk = (int64_t)b * K + k;
    const int s = sel[bk * B + (v - b * B)];
    const int row = min(max(base[bk] + s, 0), Vin - 1);   // both loads issued
    return s < 0 ? -1 : row;
  }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
band_gather_kernel(const float* __restrict__ features,
                   const int32_t* __restrict__ base,
                   const int32_t* __restrict__ sel,
                   T* __restrict__ out,
                   int Vin, int Vp, int K, int B, int Cin) {
  const int kc = K * Cin;
  const int n = Vp * kc;                  // < 2^31, checked at launch
  for (int e = blockIdx.x * THREADS + threadIdx.x; e < n;
       e += gridDim.x * THREADS) {
    const int v = e / kc;
    const int rem = e - v * kc;
    const int k = rem / Cin;
    const int c = rem - k * Cin;
    const int s = band_source(base, sel, v, k, K, B, Vin);
    store(out + e, s >= 0 ? features[(int64_t)s * Cin + c] : 0.f);
  }
}

}  // namespace

extern "C" {

int band_matmul_max_channels() { return gather_gemm::MAX_C; }

// All pointers are device pointers.  features (Vin, Cin) f32, base (nB, K)
// int32, sel (nB, K, B) int32, weights (K, Cin, Cout) f32, out (nB*B, Cout)
// f32.  bf16: 1 rounds features and weights to bf16, 0 keeps f32.
// Returns cudaGetLastError() after the launch (0 = launched).
int band_matmul_launch(const void* features, const void* base,
                       const void* sel, const void* weights, void* out,
                       int Vin, int nB, int K, int B, int Cin, int Cout,
                       int bf16, void* stream) {
  const int64_t Vp = (int64_t)nB * B;
  if (nB <= 0 || B <= 0 || Vp > INT32_MAX) return (int)cudaErrorInvalidValue;
  const BandRows src{static_cast<const int32_t*>(base),
                           static_cast<const int32_t*>(sel), B};
  return gather_gemm::launch(
      static_cast<const float*>(features), src,
      static_cast<const float*>(weights), nullptr, nullptr,
      static_cast<float*>(out), Vin, (int)Vp, K, Cin, Cout,
      bf16 ? gather_gemm::MODE_BF16 : gather_gemm::MODE_F32,
      static_cast<cudaStream_t>(stream));
}

// features (Vin, Cin) f32, base (nB, K) int32, sel (nB, K, B) int32; out
// (nB*B, K*Cin) bf16 when bf16 is 1, else f32.
int band_gather_launch(const void* features, const void* base,
                       const void* sel, void* out, int Vin, int nB, int K,
                       int B, int Cin, int bf16, void* stream) {
  const int64_t n = (int64_t)nB * B * K * Cin;
  if (Vin <= 0 || nB <= 0 || K <= 0 || B <= 0 || Cin <= 0 || n > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int64_t want = (n + THREADS - 1) / THREADS;
  const dim3 grid((unsigned)(want < 132 * 32 ? want : 132 * 32));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(features);
  const int32_t* bs = static_cast<const int32_t*>(base);
  const int32_t* sl = static_cast<const int32_t*>(sel);
  const int Vp = nB * B;
  if (bf16)
    band_gather_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        f, bs, sl, static_cast<__nv_bfloat16*>(out), Vin, Vp, K, B, Cin);
  else
    band_gather_kernel<float><<<grid, THREADS, 0, s>>>(
        f, bs, sl, static_cast<float*>(out), Vin, Vp, K, B, Cin);
  return (int)cudaGetLastError();
}

}  // extern "C"
