// Row gather for NVIDIA Hopper (sm_90a):  out[n, :] = features[idx[n], :]
//
// Replaces the TPU Pallas kernel rslo_tpu/ops/dma_gather.py::
// dma_row_gather (_gather_kernel).  The plain PyTorch version is
// ``features[idx]`` (rslo_tpu_torch/ops/dma_gather.py::row_gather on a
// CPU tensor).  In the port it builds the im2col of the sparse conv's
// weight gradient: V x K rows of one level's features.
//
// What bounds it on this card: memory transactions.  It moves bytes and
// computes nothing: an L0 im2col reads 40960 x 27 random rows of 64 B
// (16 f32) from a feature array that stays in L2, and writes 71 MB
// contiguously.  The design: one thread per 4-byte word of the output,
// so a warp reads consecutive words of the same or neighbouring rows
// and writes 128 contiguous bytes; the TPU kernel's ring of in-flight
// row DMAs becomes the many warps in flight on each SM.  Any N (the
// grid covers the ragged end), any row width; indices are checked by
// the wrapper, so the kernel reads only rows in range.  A copy of whole
// words is bit-exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const uint32_t* __restrict__ features,
                  const int32_t* __restrict__ idx,
                  uint32_t* __restrict__ out, int64_t total, int words) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += stride) {
    const int64_t n = e / words;
    const int c = (int)(e - n * words);
    out[e] = features[(int64_t)idx[n] * words + c];
  }
}

}  // namespace

extern "C" {

// features (Vin, words) and out (N, words) of 4-byte words, idx (N,)
// int32 in [0, Vin); all device pointers.  Returns cudaGetLastError()
// after the launch.
int row_gather_launch(const void* features, const void* idx, void* out,
                      int N, int words, void* stream) {
  if (N <= 0 || words <= 0) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)N * words;
  const int64_t want = (total + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  row_gather_kernel<<<blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(features),
      static_cast<const int32_t*>(idx), static_cast<uint32_t*>(out), total,
      words);
  return (int)cudaGetLastError();
}

}  // extern "C"
