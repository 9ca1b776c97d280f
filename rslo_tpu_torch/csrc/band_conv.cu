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
//       Fused mode (band_gather_fused_launch), the submanifold conv's d_W
//       operand: the same im2col in f32 (values rounded to the compute
//       dtype and widened), then the plan's overflow pairs added at their
//       (row, tap) slots, rnd(slot + rnd(f[ov_in])), as the JAX custom
//       VJP's _overflow_add_g and astype(f32) do; plain version
//       band_gather_dw_plain.
//
// rnd() rounds to the compute dtype (bf16 round-to-nearest-even, or keeps
// f32).  The product of two bf16 values is exact in f32, so B4 and its
// plain version differ only in the order (and, on the tensor cores, the
// truncation inside one 16-deep MMA) of their f32 sums; B5 is a copy and
// bit-equal to its plain version, in both modes.
//
// What bounds them on this card.  B4 reads one feature row per valid
// (row, tap) pair, 28-256 bytes each, against Cin*Cout multiply-adds per
// pair: at most 64 x 64 = 4096 per 256-byte row, far below the H100's
// bf16 ridge point (~295 operations per byte), so the row gathers from L2
// and their latency bound it (the features, <= 10.5 MB at L0 in f32, stay
// in the 50 MB L2).  B5 moves bytes only: the selected rows in, the
// (Vp, K*Cin) im2col out, which is written whole (zeros included) and
// dominates (35 MB in bf16, 71 MB in the fused mode's f32 at L0).
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
// gather_gemm.cuh.
//
// B5 takes row_gather.cu's design (B2) with the plan as its index:
//   * a block owns GATHER_ROWS consecutive rows of one plan block, whose
//     output is one contiguous run of rows x K segments of Cin values; it
//     first stages each (row, tap) source row in shared memory, reading
//     base[b, k] once per tap and sel[b, k, r] once per (row, tap), along
//     the rows (coalesced), with no division per element;
//   * then a group of LANES lanes per segment (the row's vectors rounded
//     up to a power of two) copies it with 16-byte loads wherever the row
//     is a multiple of 16 bytes and both arrays are 16-byte aligned, else
//     8 or 4 bytes (the first conv's 7-channel rows are 28 bytes);
//   * each thread has UNROLL segments in flight, their sources read
//     before any feature row is;
//   * streaming stores, as the d_W product reads the output once, later;
//   * a segment behind sel = -1 is stored as zeros without reading its
//     feature row, so a NaN there stays out.
// The fused mode writes the rounded values as f32 in that same pass, then
// a second launch on the same stream, after the first, adds the at most
// ov_capacity (4096) overflow pairs, each at its own slot (a plan stores
// a (row, tap) once).  The caller's three passes over the im2col (the
// bf16 copy that index_add_ works on and the widening to f32) are gone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gather_gemm.cuh"

namespace {

constexpr int THREADS = 256;       // threads per block of B5
constexpr int GATHER_ROWS = 32;    // rows per block of B5, a power of 2
constexpr int UNROLL = 4;          // segments per thread in flight

// B4's row-source policy: the plan's base + sel.  (tap, row) order with
// the row fastest reads each 64-row slice of sel[b, k, :] contiguously.
// base and sel come from the plan builder, which keeps base + sel inside
// [0, Vin); the clamp only keeps a bad plan from faulting.
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

// What B5 stores: the compute dtype (bf16 or f32), or in the fused mode's
// bf16 case f32 values rounded to bf16
enum OutMode { OUT_F32 = 0, OUT_BF16 = 1, OUT_ROUNDED_F32 = 2 };

__device__ __forceinline__ uint32_t bf16_bits(uint32_t w) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(w)));
}
__device__ __forceinline__ uint32_t round_word(uint32_t w) {
  return bf16_bits(w) << 16;          // the bf16 value widened to f32
}

// a vector of 1, 2 or 4 f32 words and what each mode stores for it
template <typename Vec> struct Lanes;
template <> struct Lanes<uint32_t> {
  using Bf16 = uint16_t;
  static __device__ __forceinline__ uint32_t zero() { return 0u; }
  static __device__ __forceinline__ uint16_t to_bf16(uint32_t v) {
    return (uint16_t)bf16_bits(v);
  }
  static __device__ __forceinline__ uint32_t rounded(uint32_t v) {
    return round_word(v);
  }
};
template <> struct Lanes<uint2> {
  using Bf16 = uint32_t;
  static __device__ __forceinline__ uint2 zero() {
    return make_uint2(0u, 0u);
  }
  static __device__ __forceinline__ uint32_t to_bf16(uint2 v) {
    return bf16_bits(v.x) | bf16_bits(v.y) << 16;
  }
  static __device__ __forceinline__ uint2 rounded(uint2 v) {
    return make_uint2(round_word(v.x), round_word(v.y));
  }
};
template <> struct Lanes<uint4> {
  using Bf16 = uint2;
  static __device__ __forceinline__ uint4 zero() {
    return make_uint4(0u, 0u, 0u, 0u);
  }
  static __device__ __forceinline__ uint2 to_bf16(uint4 v) {
    return make_uint2(bf16_bits(v.x) | bf16_bits(v.y) << 16,
                      bf16_bits(v.z) | bf16_bits(v.w) << 16);
  }
  static __device__ __forceinline__ uint4 rounded(uint4 v) {
    return make_uint4(round_word(v.x), round_word(v.y), round_word(v.z),
                      round_word(v.w));
  }
};

template <typename Vec, int MODE> struct Stored {
  using T = Vec;
  static __device__ __forceinline__ Vec of(Vec v) {
    return MODE == OUT_ROUNDED_F32 ? Lanes<Vec>::rounded(v) : v;
  }
};
template <typename Vec> struct Stored<Vec, OUT_BF16> {
  using T = typename Lanes<Vec>::Bf16;
  static __device__ __forceinline__ T of(Vec v) {
    return Lanes<Vec>::to_bf16(v);
  }
};

// Block (b, group): rows r0 .. r0 + rows of plan block b.  features rows
// of `vecs` vectors; segment s = j*K + k of the block is row r0 + j, tap
// k; lanes = 1 << lanes_log2 lanes per segment.  Dynamic shared memory:
// GATHER_ROWS * K ints.
template <typename Vec, int MODE>
__global__ void __launch_bounds__(THREADS)
band_gather_kernel(const Vec* __restrict__ features,
                   const int32_t* __restrict__ base,
                   const int32_t* __restrict__ sel,
                   typename Stored<Vec, MODE>::T* __restrict__ out,
                   int Vin, int K, int B, int groups, int vecs,
                   int lanes_log2) {
  extern __shared__ int src_s[];      // source row of segment s, -1 for none
  const int b = blockIdx.x / groups;
  const int r0 = (blockIdx.x - b * groups) * GATHER_ROWS;
  const int rows = min(GATHER_ROWS, B - r0);
  const int n_seg = rows * K;
  for (int i = threadIdx.x; i < GATHER_ROWS * K; i += THREADS) {
    const int k = i / GATHER_ROWS;    // a shift
    const int j = i % GATHER_ROWS;
    if (j < rows) {
      const int64_t bk = (int64_t)b * K + k;
      const int s = __ldg(sel + bk * B + r0 + j);
      src_s[j * K + k] =
          s < 0 ? -1 : min(max(__ldg(base + bk) + s, 0), Vin - 1);
    }
  }
  __syncthreads();
  auto* dst = out + ((int64_t)b * B + r0) * K * vecs;
  const int lanes = 1 << lanes_log2;
  const int segs = THREADS >> lanes_log2;      // segments per pass
  const int lane = threadIdx.x & (lanes - 1);
  for (int s0 = threadIdx.x >> lanes_log2; s0 < n_seg; s0 += segs * UNROLL) {
    int src[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + u * segs;
      src[u] = s < n_seg ? src_s[s] : -1;
    }
    for (int c = lane; c < vecs; c += lanes) {
      Vec v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        v[u] = src[u] >= 0 ? __ldg(features + (int64_t)src[u] * vecs + c)
                           : Lanes<Vec>::zero();
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int s = s0 + u * segs;
        if (s < n_seg)
          __stcs(dst + (int64_t)s * vecs + c, Stored<Vec, MODE>::of(v[u]));
      }
    }
  }
}

// The fused mode's second pass: pair p adds rnd(f[ov_in[p]]) into slot
// (ov_out[p], ov_tap[p]) of the f32 im2col and rounds the sum (round_bf16:
// to bf16 and back, as a bf16 index_add_ does; else f32).  ov_out == Vp
// marks a dropped pair.  One thread per (pair, channel).
__global__ void __launch_bounds__(THREADS)
band_overflow_kernel(const float* __restrict__ features,
                     const int32_t* __restrict__ ov_out,
                     const int32_t* __restrict__ ov_in,
                     const int32_t* __restrict__ ov_tap,
                     float* __restrict__ out, int Vin, int Vp, int K,
                     int Cin, int n_ov, bool round_bf16) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= n_ov * Cin) return;        // < 2^31, checked at launch
  const int p = e / Cin;
  const int c = e - p * Cin;
  const int o = __ldg(ov_out + p);
  const int t = __ldg(ov_tap + p);
  if (o < 0 || o >= Vp || t < 0 || t >= K) return;
  const int i = min(max(__ldg(ov_in + p), 0), Vin - 1);
  float* slot = out + ((int64_t)o * K + t) * Cin + c;
  uint32_t x = __float_as_uint(__ldg(features + (int64_t)i * Cin + c));
  if (round_bf16) x = round_word(x);
  uint32_t y = __float_as_uint(__fadd_rn(*slot, __uint_as_float(x)));
  if (round_bf16) y = round_word(y);
  *slot = __uint_as_float(y);
}

template <typename Vec>
cudaError_t launch_vec(const void* features, const void* base,
                       const void* sel, void* out, int Vin, int nB, int K,
                       int B, int Cin, int mode, cudaStream_t stream) {
  const int vecs = Cin / (int)(sizeof(Vec) / 4);
  int lanes_log2 = 0;                 // lanes: vecs rounded up to 2^n, <= 32
  while (lanes_log2 < 5 && (1 << lanes_log2) < vecs) ++lanes_log2;
  const int groups = (B + GATHER_ROWS - 1) / GATHER_ROWS;
  const dim3 grid((unsigned)((int64_t)nB * groups));
  const size_t smem = (size_t)GATHER_ROWS * K * sizeof(int);
  const Vec* f = static_cast<const Vec*>(features);
  const int32_t* bs = static_cast<const int32_t*>(base);
  const int32_t* sl = static_cast<const int32_t*>(sel);
  if (mode == OUT_BF16)
    band_gather_kernel<Vec, OUT_BF16><<<grid, THREADS, smem, stream>>>(
        f, bs, sl, static_cast<typename Lanes<Vec>::Bf16*>(out), Vin, K, B,
        groups, vecs, lanes_log2);
  else if (mode == OUT_ROUNDED_F32)
    band_gather_kernel<Vec, OUT_ROUNDED_F32><<<grid, THREADS, smem, stream>>>(
        f, bs, sl, static_cast<Vec*>(out), Vin, K, B, groups, vecs,
        lanes_log2);
  else
    band_gather_kernel<Vec, OUT_F32><<<grid, THREADS, smem, stream>>>(
        f, bs, sl, static_cast<Vec*>(out), Vin, K, B, groups, vecs,
        lanes_log2);
  return cudaGetLastError();
}

// The main pass in any mode; returns a CUDA error code (0 = launched).
int launch_gather(const void* features, const void* base, const void* sel,
                  void* out, int Vin, int nB, int K, int B, int Cin,
                  int mode, cudaStream_t s) {
  const int64_t n = (int64_t)nB * B * K * Cin;
  if (Vin <= 0 || nB <= 0 || K <= 0 || B <= 0 || Cin <= 0 || n > INT32_MAX ||
      (int64_t)GATHER_ROWS * K * sizeof(int) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(features) | reinterpret_cast<uintptr_t>(out);
  if (Cin % 4 == 0 && align % 16 == 0)
    return (int)launch_vec<uint4>(features, base, sel, out, Vin, nB, K, B,
                                  Cin, mode, s);
  if (Cin % 2 == 0 && align % 8 == 0)
    return (int)launch_vec<uint2>(features, base, sel, out, Vin, nB, K, B,
                                  Cin, mode, s);
  return (int)launch_vec<uint32_t>(features, base, sel, out, Vin, nB, K, B,
                                   Cin, mode, s);
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
  return launch_gather(features, base, sel, out, Vin, nB, K, B, Cin,
                       bf16 ? OUT_BF16 : OUT_F32,
                       static_cast<cudaStream_t>(stream));
}

// The fused d_W operand: as band_gather_launch, but out is (nB*B, K*Cin)
// f32 (values rounded to bf16 when bf16 is 1), and then the n_ov overflow
// pairs (ov_out, ov_in, ov_tap) (n_ov,) int32 are added, in a second
// launch on the same stream.  Returns cudaGetLastError() after the last
// launch (0 = launched).
int band_gather_fused_launch(const void* features, const void* base,
                             const void* sel, const void* ov_out,
                             const void* ov_in, const void* ov_tap,
                             void* out, int Vin, int nB, int K, int B,
                             int Cin, int n_ov, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_ov < 0 || (int64_t)n_ov * Cin > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int err = launch_gather(features, base, sel, out, Vin, nB, K, B, Cin,
                                bf16 ? OUT_ROUNDED_F32 : OUT_F32, s);
  if (err != 0 || n_ov == 0) return err;
  const int blocks = (n_ov * Cin + THREADS - 1) / THREADS;
  band_overflow_kernel<<<blocks, THREADS, 0, s>>>(
      static_cast<const float*>(features), static_cast<const int32_t*>(ov_out),
      static_cast<const int32_t*>(ov_in), static_cast<const int32_t*>(ov_tap),
      static_cast<float*>(out), Vin, nB * B, K, Cin, n_ov, bf16 != 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
