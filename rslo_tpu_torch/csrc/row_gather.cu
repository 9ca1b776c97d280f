// Row gather for NVIDIA Hopper (sm_90a):  out[n, :] = features[idx[n], :]
//
// Replaces the TPU Pallas kernel rslo_tpu/ops/dma_gather.py::
// dma_row_gather (_gather_kernel).  The plain PyTorch version is
// ``features[idx]`` (rslo_tpu_torch/ops/dma_gather.py::row_gather on a
// CPU tensor).  In the port it builds the im2col of the sparse conv's
// weight gradient: V x K rows of one level's features.
//
// Fused mode (row_gather_fused_launch): the d_W im2col as its caller
// uses it, round(where(valid[n], features[idx[n]], 0)), in one pass.  A
// row whose valid is false is written as +0.0 and its feature row is
// never read; with round_bf16 every value is rounded to bf16 (nearest
// even, __float2bfloat16_rn, as torch's f32 -> bf16 on the card) and
// widened back to f32, as ops/sparse_conv.py::round_operand does.
//
// What bounds it on this card: bytes.  It computes nothing: an L0 im2col
// reads 40960 x 27 indices and rows of 64 B (16 f32) from a feature array
// that stays in L2, and writes 71 MB contiguously, so the output's write
// sets the pace (~23 us at 3.35 TB/s).  The design:
//   * a group of LANES lanes per row (the row's vectors, rounded up to a
//     power of two) loads the row's index once;
//   * 16-byte loads and stores wherever the row is a multiple of 16
//     bytes and both arrays are 16-byte aligned, else 8 or 4 bytes (the
//     first conv's 7-channel rows are 28 bytes);
//   * each thread has UNROLL rows in flight, their index loads issued
//     before any row is read;
//   * streaming stores for the output, which is read once, later, by the
//     d_W product; 32-bit row and lane arithmetic, no division.
// In fused mode the caller's torch.where and two rounding casts, three
// full passes over the im2col, are gone, and ~94% of L0's rows (invalid
// taps) cost a 1-byte read and a store.  A copy of whole words is
// bit-exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;   // rows per thread in flight

__device__ __forceinline__ uint32_t round_word(uint32_t w) {
  return __float_as_uint(
      __bfloat162float(__float2bfloat16_rn(__uint_as_float(w))));
}
__device__ __forceinline__ uint32_t round_vec(uint32_t v) {
  return round_word(v);
}
__device__ __forceinline__ uint2 round_vec(uint2 v) {
  return make_uint2(round_word(v.x), round_word(v.y));
}
__device__ __forceinline__ uint4 round_vec(uint4 v) {
  return make_uint4(round_word(v.x), round_word(v.y), round_word(v.z),
                    round_word(v.w));
}

template <typename Vec> __device__ __forceinline__ Vec zero_vec();
template <> __device__ __forceinline__ uint32_t zero_vec<uint32_t>() {
  return 0u;
}
template <> __device__ __forceinline__ uint2 zero_vec<uint2>() {
  return make_uint2(0u, 0u);
}
template <> __device__ __forceinline__ uint4 zero_vec<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}

// rows of `vecs` vectors of type Vec; valid may be null (every row live)
template <typename Vec, int LANES>
__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const Vec* __restrict__ features,
                  const int32_t* __restrict__ idx,
                  const uint8_t* __restrict__ valid, Vec* __restrict__ out,
                  int N, int vecs, bool round_bf16) {
  constexpr int ROWS = THREADS / LANES;   // rows per pass of the block
  const int lane = threadIdx.x % LANES;
  const int row0 = blockIdx.x * (ROWS * UNROLL) + threadIdx.x / LANES;
  int src[UNROLL];
  bool live[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int n = row0 + u * ROWS;
    src[u] = n < N ? __ldg(idx + n) : 0;
    live[u] = n < N && (valid == nullptr || __ldg(valid + n) != 0);
  }
  for (int c = lane; c < vecs; c += LANES) {
    Vec v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      v[u] = live[u] ? __ldg(features + (int64_t)src[u] * vecs + c)
                     : zero_vec<Vec>();
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int n = row0 + u * ROWS;
      if (n < N)
        __stcs(out + (int64_t)n * vecs + c,
               round_bf16 ? round_vec(v[u]) : v[u]);
    }
  }
}

template <typename Vec, int LANES>
cudaError_t launch_lanes(const void* features, const void* idx,
                         const void* valid, void* out, int N, int vecs,
                         bool round_bf16, cudaStream_t stream) {
  constexpr int per_block = THREADS / LANES * UNROLL;
  const int blocks = (int)(((int64_t)N + per_block - 1) / per_block);
  row_gather_kernel<Vec, LANES><<<blocks, THREADS, 0, stream>>>(
      static_cast<const Vec*>(features), static_cast<const int32_t*>(idx),
      static_cast<const uint8_t*>(valid), static_cast<Vec*>(out), N, vecs,
      round_bf16);
  return cudaGetLastError();
}

template <typename Vec>
cudaError_t launch_vec(const void* features, const void* idx,
                       const void* valid, void* out, int N, int vecs,
                       bool round_bf16, cudaStream_t stream) {
  // lanes per row: the row's vectors rounded up to a power of two, <= 32
  if (vecs <= 1)
    return launch_lanes<Vec, 1>(features, idx, valid, out, N, vecs,
                                round_bf16, stream);
  if (vecs <= 2)
    return launch_lanes<Vec, 2>(features, idx, valid, out, N, vecs,
                                round_bf16, stream);
  if (vecs <= 4)
    return launch_lanes<Vec, 4>(features, idx, valid, out, N, vecs,
                                round_bf16, stream);
  if (vecs <= 8)
    return launch_lanes<Vec, 8>(features, idx, valid, out, N, vecs,
                                round_bf16, stream);
  if (vecs <= 16)
    return launch_lanes<Vec, 16>(features, idx, valid, out, N, vecs,
                                 round_bf16, stream);
  return launch_lanes<Vec, 32>(features, idx, valid, out, N, vecs,
                               round_bf16, stream);
}

int launch(const void* features, const void* idx, const void* valid,
           void* out, int N, int words, bool round_bf16, void* stream) {
  if (N <= 0 || words <= 0) return (int)cudaErrorInvalidValue;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(features) | reinterpret_cast<uintptr_t>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (words % 4 == 0 && align % 16 == 0)
    return (int)launch_vec<uint4>(features, idx, valid, out, N, words / 4,
                                  round_bf16, s);
  if (words % 2 == 0 && align % 8 == 0)
    return (int)launch_vec<uint2>(features, idx, valid, out, N, words / 2,
                                  round_bf16, s);
  return (int)launch_vec<uint32_t>(features, idx, valid, out, N, words,
                                   round_bf16, s);
}

}  // namespace

extern "C" {

// features (Vin, words) and out (N, words) of 4-byte words, idx (N,)
// int32 in [0, Vin); all device pointers.  Returns cudaGetLastError()
// after the launch.
int row_gather_launch(const void* features, const void* idx, void* out,
                      int N, int words, void* stream) {
  return launch(features, idx, nullptr, out, N, words, false, stream);
}

// The fused d_W im2col: features (Vin, words) f32, idx (N,) int32 in
// [0, Vin) where valid, valid (N,) bool or null (every row valid), out
// (N, words) f32 = round(valid[n] ? features[idx[n]] : 0), rounded to
// bf16 and widened back when round_bf16 is not 0.  Returns
// cudaGetLastError() after the launch.
int row_gather_fused_launch(const void* features, const void* idx,
                            const void* valid, void* out, int N, int words,
                            int round_bf16, void* stream) {
  return launch(features, idx, valid, out, N, words, round_bf16 != 0,
                stream);
}

}  // extern "C"
