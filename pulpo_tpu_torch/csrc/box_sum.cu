// Zero-padded separable box sum for Hopper (sm_90a): the windowed-NCC
// building block.
//
// out[b, d, h, w] = sum over |k_D|, |k_H|, |k_W| <= win / 2 of
//                   x[b, d + k_D, h + k_H, w + k_W], zero outside.
//
// Replaces pulpo_tpu/kernels/box_sum.py:_box_sum_pallas, which keeps a
// whole (H, W) plane in VMEM for the H and W passes and a (D, lanes)
// slab for the D pass. Here one C entry runs three axis passes, H then
// W then D (the TPU kernel's order), x -> out -> tmp -> out; one thread
// per element sums its window along the pass's axis as shifted adds:
// acc = x[i], then acc += x[i + k], acc += x[i - k] for k = 1 .. win/2,
// a term outside the volume skipped (adding zero is exact). That is the
// order of the plain PyTorch version (kernels/box_sum.py), so the two
// agree bit for bit.
//
// The box sum is symmetric and zero-padded, hence self-adjoint: the
// backward is this same function on the cotangent.
//
// 2D: `pulpo_box_sum_2d` runs the H and W passes over (B, H, W) (x ->
// tmp -> out), in the order of _hw_kernel (box_sum.py:42-49). It
// replaces the x.ndim == 3 arm of _box_sum_pallas (box_sum.py:63-74),
// which holds one whole (H, W) slice in VMEM per grid step: the NCC's
// window sums of the 2D configuration.
//
// Bound: memory. The function reads x once and writes out once (8 B
// per element); the three passes move 24 B per element, and the
// window's re-reads come from L1/L2 (neighbouring threads read
// neighbouring elements, the D pass a stride of H*W apart). Fusing the
// passes through shared memory is later speed work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One pass along an axis of size n whose elements are `stride` apart.
__global__ void box_axis_kernel(const float* __restrict__ x, float* __restrict__ y,
                                long long total, long long stride, int n, int p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int pos = (int)((i / stride) % n);
  float acc = x[i];
  for (int k = 1; k <= p; ++k) {
    if (pos + k < n) acc += __ldg(x + i + k * stride);
    if (pos - k >= 0) acc += __ldg(x + i - k * stride);
  }
  y[i] = acc;
}

}  // namespace

// x, out, tmp: (B, D, H, W) float32, contiguous, pairwise distinct.
// Returns the first CUDA error, or 0.
extern "C" int pulpo_box_sum(const void* x, void* out, void* tmp,
                             int B, int D, int H, int W, int win, void* stream) {
  const long long total = (long long)B * D * H * W;
  if (total == 0) return 0;
  const int p = win / 2;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  box_axis_kernel<<<blocks, threads, 0, s>>>((const float*)x, (float*)out, total, W, H, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  box_axis_kernel<<<blocks, threads, 0, s>>>((const float*)out, (float*)tmp, total, 1, W, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  box_axis_kernel<<<blocks, threads, 0, s>>>((const float*)tmp, (float*)out, total,
                                             (long long)H * W, D, p);
  return (int)cudaGetLastError();
}

// x, out, tmp: (B, H, W) float32, contiguous, pairwise distinct: the H
// pass, then the W pass. Returns the first CUDA error, or 0.
extern "C" int pulpo_box_sum_2d(const void* x, void* out, void* tmp,
                                int B, int H, int W, int win, void* stream) {
  const long long total = (long long)B * H * W;
  if (total == 0) return 0;
  const int p = win / 2;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  box_axis_kernel<<<blocks, threads, 0, s>>>((const float*)x, (float*)tmp, total, W, H, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  box_axis_kernel<<<blocks, threads, 0, s>>>((const float*)tmp, (float*)out, total, 1, W, p);
  return (int)cudaGetLastError();
}
