// Backward of one scaling-and-squaring step for Hopper (sm_90a).
//
// Forward (csrc/squaring.cu): out = v + warp(v, v). Its VJP for the
// cotangent g is
//   vbar = g                                   (identity)
//        + dfgrad(v, v, g)                     (coordinate term)
//        + mgrad(v, v, g)                      (data term: the gather's
//                                               transpose, a scatter)
// with the df- and moving-cotangents of csrc/warp_bwd.cu.
//
// Replaces pulpo_tpu/kernels/warp_local.py:_squaring_step_bwd_pallas
// (the 27-tap transpose stencil, exact only while max|v| is sub-voxel)
// and the tiered backward past that bound (warp_local.py:455-485: g +
// the dfgrad cascade + the mgrad cascade). One launch computes the
// function at any displacement.
//
// Design: the caller seeds `out` with g (a device copy in the C entry,
// on the same stream). One thread per voxel then gathers its 8 corners
// for the coordinate term and scatters w_corner * g into them for the
// data term. Both terms go into `out` with float32 atomicAdd: another
// thread may be scattering into this voxel while it adds its own
// coordinate term, so a plain read-modify-write would race. The order
// of the adds is not fixed; the result is held to a tolerance.
//
// Clamp convention, as csrc/warp_bwd.cu: clip'(u) is 1 inside, 1/2 at a
// tie with a bound (jax.grad through jnp.clip), 0 outside.
//
// Bound: memory. The step reads v and g once and writes vbar once
// (36 B per voxel); corners and scatter targets of a smooth field are
// neighbouring voxels, served from L1/L2.
//
// Numerics: built with -fmad=false (coordinates round as the forward's).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void axis_terms(int p, float d, float f, int s,
                                           int* i0, int* i1, float* w,
                                           float* dclip) {
  const float loc = (float)p + d;
  const float u = loc * f - 0.5f;
  const float hi = (float)(s - 1);
  const float lo_clamped = fmaxf(u, 0.0f);
  const float src = fminf(lo_clamped, hi);
  const float dmax = u > 0.0f ? 1.0f : (u == 0.0f ? 0.5f : 0.0f);
  const float dmin = lo_clamped < hi ? 1.0f : (lo_clamped == hi ? 0.5f : 0.0f);
  const float fl = floorf(src);
  *i0 = (int)fl;
  *i1 = min(*i0 + 1, s - 1);
  *w = src - fl;
  *dclip = dmax * dmin;
}

__global__ void squaring_bwd_kernel(const float* __restrict__ vin,
                                    const float* __restrict__ g,
                                    float* __restrict__ out,
                                    int S0, int S1, int S2,
                                    float f0, float f1, float f2,
                                    long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long n = (long long)S0 * S1 * S2;
  const long long b = idx / n;
  const long long v = idx - b * n;
  const int x = (int)(v % S2);
  const int y = (int)((v / S2) % S1);
  const int z = (int)(v / ((long long)S1 * S2));

  const float* row = vin + b * n * 3;
  float* orow = out + b * n * 3;
  const float gv[3] = {g[idx * 3 + 0], g[idx * 3 + 1], g[idx * 3 + 2]};
  const int S[3] = {S0, S1, S2};
  const int p[3] = {z, y, x};
  const float f[3] = {f0, f1, f2};
  int i0[3], i1[3];
  float w[3], dclip[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    axis_terms(p[a], vin[idx * 3 + a], f[a], S[a], &i0[a], &i1[a], &w[a], &dclip[a]);

  float gw[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int h0 = corner & 1, h1 = (corner >> 1) & 1, h2 = (corner >> 2) & 1;
    const long long off =
        ((long long)(h0 ? i1[0] : i0[0]) * S1 + (h1 ? i1[1] : i0[1])) * S2
        + (h2 ? i1[2] : i0[2]);
    const float w0 = h0 ? w[0] : 1.0f - w[0];
    const float w1 = h1 ? w[1] : 1.0f - w[1];
    const float w2 = h2 ? w[2] : 1.0f - w[2];
    const float* m = row + off * 3;
    const float gm = gv[0] * __ldg(m) + gv[1] * __ldg(m + 1) + gv[2] * __ldg(m + 2);
    const float t0 = gm * (w1 * w2);
    const float t1 = gm * (w0 * w2);
    const float t2 = gm * (w0 * w1);
    gw[0] = h0 ? gw[0] + t0 : gw[0] - t0;
    gw[1] = h1 ? gw[1] + t1 : gw[1] - t1;
    gw[2] = h2 ? gw[2] + t2 : gw[2] - t2;
    // data term: the gather's transpose
    const float wc = (w0 * w1) * w2;
    float* o = orow + off * 3;
    atomicAdd(o + 0, wc * gv[0]);
    atomicAdd(o + 1, wc * gv[1]);
    atomicAdd(o + 2, wc * gv[2]);
  }
  // coordinate term, at this voxel
#pragma unroll
  for (int a = 0; a < 3; ++a) atomicAdd(out + idx * 3 + a, gw[a] * (dclip[a] * f[a]));
}

}  // namespace

// vbar (B, S0, S1, S2, 3) = g + dfgrad(v, v, g) + mgrad(v, v, g).
// `out` must not alias v or g. Returns the first CUDA error, or 0.
extern "C" int pulpo_squaring_step_bwd(const void* vin, const void* g, void* out,
                                       int B, int S0, int S1, int S2,
                                       float f0, float f1, float f2,
                                       void* stream) {
  const long long total = (long long)B * S0 * S1 * S2;
  if (total == 0) return 0;
  cudaError_t err = cudaMemcpyAsync(out, g, (size_t)total * 3 * sizeof(float),
                                    cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  squaring_bwd_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)vin, (const float*)g, (float*)out, S0, S1, S2, f0, f1, f2, total);
  return (int)cudaGetLastError();
}
