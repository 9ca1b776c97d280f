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
// plain version differ only in the order of their f32 sums; B5 is a copy
// and bit-equal to its plain version.
//
// What bounds them on this card.  B4 reads one feature row per valid
// (row, tap) pair, 28-256 bytes each, against Cin*Cout multiply-adds per
// pair: at most 64 x 64 = 4096 per 256-byte row, far below the H100's
// bf16 ridge point (~295 operations per byte), so the row reads bound it.
// The features (<= 10.5 MB at L0 in f32) stay in the 50 MB L2.  B5 moves
// bytes only: the selected rows in, the (Vp, K*Cin) im2col out, which is
// written whole (zeros included) and dominates.
//
// What the design does about it.  The TPU kernel double-buffered whole
// (W, Cin) windows into VMEM and selected rows with a one-hot product on
// the MXU, because the TPU gathers slowly.  Hopper gathers rows cheaply,
// and a 1280-row window at 64 channels would take 160 KB of shared memory
// in bf16 and leave one block per SM.  So B4 is the gather-GEMM of
// csrc/gather_matmul.cu with the plan's (base, sel) in place of a
// rulebook: one block per tile of 64 output rows; per tap the block reads
// sel for its rows and skips the tap when no row uses it; only the
// selected rows are gathered into shared memory, with W[k] beside them;
// the f32 sums stay in registers across the K taps; the output is written
// once.  A row behind sel = -1 is never read, so a NaN there cannot reach
// a sum.  B5 is a grid-stride copy with the output's flat index on the
// threads, so the writes (its bytes) are coalesced.  wgmma/TMA
// pipelining, and any use of the band's locality, is later work.
//
// The submanifold d_features of the band engine is B4 again, run over the
// same plan with the cotangent as the features and the tap-flipped,
// transposed weights (the plan of a submanifold rulebook is its own
// transpose); ops/band_conv.py counts those launches apart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_V = 64;     // output rows per block of B4
constexpr int THREADS = 256;
constexpr int MAX_C = 64;      // widest Cin / Cout taken by B4
constexpr int ACC = TILE_V * MAX_C / THREADS;   // outputs per thread

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__device__ __forceinline__ float round_operand(float x) {
  return BF16 ? round_bf16(x) : x;
}

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

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
band_matmul_kernel(const float* __restrict__ features,
                   const int32_t* __restrict__ base,
                   const int32_t* __restrict__ sel,
                   const float* __restrict__ weights,
                   float* __restrict__ out,
                   int Vin, int Vp, int K, int B, int Cin, int Cout) {
  __shared__ float g_s[TILE_V * MAX_C];   // gathered rows, [row][cin]
  __shared__ float w_s[MAX_C * MAX_C];    // W[k], [cin][cout]
  __shared__ int src_s[TILE_V];           // input row, -1 = no pair

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TILE_V;
  const int rows = min(TILE_V, Vp - row0);
  const int n_out = rows * Cout;

  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.f;

  for (int k = 0; k < K; ++k) {
    int used = 0;
    if (tid < TILE_V) {
      const int s = tid < rows
          ? band_source(base, sel, row0 + tid, k, K, B, Vin) : -1;
      src_s[tid] = s;
      used = s >= 0;
    }
    if (!__syncthreads_or(used)) continue;   // tap empty for the whole tile

    const float* wk = weights + (int64_t)k * Cin * Cout;
    for (int e = tid; e < Cin * Cout; e += THREADS)
      w_s[e] = round_operand<BF16>(wk[e]);
    for (int e = tid; e < rows * Cin; e += THREADS) {
      const int r = e / Cin;
      const int c = e - r * Cin;
      const int s = src_s[r];
      if (s >= 0) g_s[e] = round_operand<BF16>(features[(int64_t)s * Cin + c]);
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
          float a = acc[j];
          for (int ci = 0; ci < Cin; ++ci)
            a = fmaf(gr[ci], w_s[ci * Cout + c], a);
          acc[j] = a;
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
      out[(int64_t)(row0 + r) * Cout + c] = acc[j];
    }
  }
}

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

int band_matmul_max_channels() { return MAX_C; }

// All pointers are device pointers.  features (Vin, Cin) f32, base (nB, K)
// int32, sel (nB, K, B) int32, weights (K, Cin, Cout) f32, out (nB*B, Cout)
// f32.  bf16: 1 rounds features and weights to bf16, 0 keeps f32.
// Returns cudaGetLastError() after the launch (0 = launched).
int band_matmul_launch(const void* features, const void* base,
                       const void* sel, const void* weights, void* out,
                       int Vin, int nB, int K, int B, int Cin, int Cout,
                       int bf16, void* stream) {
  const int64_t Vp = (int64_t)nB * B;
  if (Vin <= 0 || nB <= 0 || K <= 0 || B <= 0 || Cin <= 0 || Cout <= 0 ||
      Cin > MAX_C || Cout > MAX_C || Vp > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((Vp + TILE_V - 1) / TILE_V));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(features);
  const int32_t* bs = static_cast<const int32_t*>(base);
  const int32_t* sl = static_cast<const int32_t*>(sel);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  if (bf16)
    band_matmul_kernel<true><<<grid, THREADS, 0, s>>>(
        f, bs, sl, w, o, Vin, (int)Vp, K, B, Cin, Cout);
  else
    band_matmul_kernel<false><<<grid, THREADS, 0, s>>>(
        f, bs, sl, w, o, Vin, (int)Vp, K, B, Cin, Cout);
  return (int)cudaGetLastError();
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
