// The two cotangents of the dense trilinear warp, for Hopper (sm_90a).
//
// Forward (csrc/warp.cu): out[r, p, c] = sum_k W_k(src(p)) m[r % B, n_k, c]
// with src_a = clip(u_a, 0, S_in_a - 1), u_a = (p_a + df_a) * f_a - 0.5,
// f_a = S_in_a / (S_out_a - 1), and W_k the product of the per-axis
// weights (w_a or 1 - w_a, w_a = src_a - floor(src_a)) of corner k.
//
// pulpo_warp_dfgrad replaces pulpo_tpu/kernels/warp_halo.py:
// _warp_halo_dfgrad_pallas (and its repair/XLA cascade): the
// df-cotangent, per output voxel p and axis a,
//   gdf[r, p, a] = sum_k <g[r, p], m[r % B, n_k]> * dW_k/dw_a
//                  * clip'(u_a) * f_a.
// One thread per (df row, output voxel): it gathers its 8 corners, as
// the forward does, and writes its own 3 values; no atomics, so the
// result is deterministic. Moving and df may have different spatial
// shapes (the level_res cross-resolution warp).
//
// pulpo_warp_mgrad replaces _warp_halo_mgrad_pallas (and its cascade):
// the moving-cotangent, the transpose of the gather. One thread per
// (df row, output voxel) scatters W_k * g into its 8 source corners of
// moving row r % B with float32 atomicAdd, which also sums the sample
// rows that share a moving row. The order in which the adds land is
// not fixed, so the result varies from run to run in its last bits;
// it is held to a tolerance, not to bit-equality. (The TPU kernel
// re-expresses the scatter as a bounded halo gather; a thread here has
// no bound on where its corners are, so it scatters.)
//
// Clamp convention: clip'(u) is taken as jax.grad takes it through
// jnp.clip (maximum, then minimum): 1 strictly inside, 1/2 at a tie
// with a bound, 0 outside. The floor is one-sided (derivative 1). The
// plain PyTorch versions (kernels/warp.py) use the same convention.
//
// Bound: memory. dfgrad reads df (12 B) and g (4C B) once per voxel
// and writes 12 B; the corners of a smooth field are the neighbours'
// voxels and come from L1/L2. mgrad reads df and g and scatters into a
// volume that stays in L2 at level-0 sizes; the atomics resolve in L2.
//
// Numerics: built with -fmad=false, so the coordinate arithmetic rounds
// as in the forward (a source coordinate one ulp off can land across a
// voxel boundary).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Axis {
  int i0, i1;
  float w;      // weight of the upper corner
  float dclip;  // clip'(u) in {0, 1/2, 1}
};

__device__ __forceinline__ Axis axis_terms(int p, float d, float f, int s_in) {
  Axis t;
  const float loc = (float)p + d;
  const float u = loc * f - 0.5f;
  const float hi = (float)(s_in - 1);
  const float lo_clamped = fmaxf(u, 0.0f);
  const float src = fminf(lo_clamped, hi);
  const float dmax = u > 0.0f ? 1.0f : (u == 0.0f ? 0.5f : 0.0f);
  const float dmin = lo_clamped < hi ? 1.0f : (lo_clamped == hi ? 0.5f : 0.0f);
  const float fl = floorf(src);
  t.i0 = (int)fl;
  t.i1 = min(t.i0 + 1, s_in - 1);
  t.w = src - fl;
  t.dclip = dmax * dmin;
  return t;
}

struct Voxel {
  long long row_base;  // offset of moving row r % B, in voxels
  Axis ax[3];
};

__device__ __forceinline__ Voxel voxel_terms(const float* __restrict__ df,
                                             long long idx, int B,
                                             int I0, int I1, int I2,
                                             int O0, int O1, int O2,
                                             float f0, float f1, float f2) {
  const long long n_out = (long long)O0 * O1 * O2;
  const long long r = idx / n_out;
  const long long v = idx - r * n_out;
  const int x = (int)(v % O2);
  const int y = (int)((v / O2) % O1);
  const int z = (int)(v / ((long long)O1 * O2));
  const float* d = df + idx * 3;
  Voxel out;
  out.row_base = (r % B) * ((long long)I0 * I1 * I2);
  out.ax[0] = axis_terms(z, d[0], f0, I0);
  out.ax[1] = axis_terms(y, d[1], f1, I1);
  out.ax[2] = axis_terms(x, d[2], f2, I2);
  return out;
}

__device__ __forceinline__ long long corner_offset(const Voxel& vx, int corner,
                                                   int I1, int I2) {
  const Axis* a = vx.ax;
  const int z = (corner & 1) ? a[0].i1 : a[0].i0;
  const int y = (corner & 2) ? a[1].i1 : a[1].i0;
  const int x = (corner & 4) ? a[2].i1 : a[2].i0;
  return vx.row_base + ((long long)z * I1 + y) * I2 + x;
}

__device__ __forceinline__ float axis_weight(const Axis& a, int hi) {
  return hi ? a.w : 1.0f - a.w;
}

__global__ void dfgrad_kernel(const float* __restrict__ mov,
                              const float* __restrict__ df,
                              const float* __restrict__ g,
                              float* __restrict__ out,
                              int B, int C, int I0, int I1, int I2,
                              int O0, int O1, int O2,
                              float f0, float f1, float f2, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const Voxel vx = voxel_terms(df, idx, B, I0, I1, I2, O0, O1, O2, f0, f1, f2);
  const float* gv = g + idx * C;
  float gw[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const float* m = mov + corner_offset(vx, corner, I1, I2) * C;
    float gm = 0.0f;
    for (int ch = 0; ch < C; ++ch) gm += gv[ch] * __ldg(m + ch);
    const int h0 = corner & 1, h1 = (corner >> 1) & 1, h2 = (corner >> 2) & 1;
    const float w0 = axis_weight(vx.ax[0], h0);
    const float w1 = axis_weight(vx.ax[1], h1);
    const float w2 = axis_weight(vx.ax[2], h2);
    const float t0 = gm * (w1 * w2);
    const float t1 = gm * (w0 * w2);
    const float t2 = gm * (w0 * w1);
    gw[0] = h0 ? gw[0] + t0 : gw[0] - t0;
    gw[1] = h1 ? gw[1] + t1 : gw[1] - t1;
    gw[2] = h2 ? gw[2] + t2 : gw[2] - t2;
  }
  const float f[3] = {f0, f1, f2};
  float* o = out + idx * 3;
#pragma unroll
  for (int a = 0; a < 3; ++a) o[a] = gw[a] * (vx.ax[a].dclip * f[a]);
}

__global__ void mgrad_kernel(const float* __restrict__ df,
                             const float* __restrict__ g,
                             float* __restrict__ out,
                             int B, int C, int I0, int I1, int I2,
                             int O0, int O1, int O2,
                             float f0, float f1, float f2, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const Voxel vx = voxel_terms(df, idx, B, I0, I1, I2, O0, O1, O2, f0, f1, f2);
  const float* gv = g + idx * C;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const float w = axis_weight(vx.ax[0], corner & 1)
                    * axis_weight(vx.ax[1], (corner >> 1) & 1)
                    * axis_weight(vx.ax[2], (corner >> 2) & 1);
    float* o = out + corner_offset(vx, corner, I1, I2) * C;
    for (int ch = 0; ch < C; ++ch) atomicAdd(o + ch, w * gv[ch]);
  }
}

unsigned int blocks_for(long long total, int threads) {
  return (unsigned int)((total + threads - 1) / threads);
}

}  // namespace

// gdf (B_df, O0, O1, O2, 3) from moving (B, I0, I1, I2, C), df (B_df, O.., 3)
// and g (B_df, O.., C). Returns cudaGetLastError().
extern "C" int pulpo_warp_dfgrad(const void* mov, const void* df, const void* g,
                                 void* out, int B, int B_df, int C,
                                 int I0, int I1, int I2, int O0, int O1, int O2,
                                 float f0, float f1, float f2, void* stream) {
  const long long total = (long long)B_df * O0 * O1 * O2;
  if (total == 0) return 0;
  const int threads = 256;
  dfgrad_kernel<<<blocks_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (const float*)mov, (const float*)df, (const float*)g, (float*)out,
      B, C, I0, I1, I2, O0, O1, O2, f0, f1, f2, total);
  return (int)cudaGetLastError();
}

// gm (B, I0, I1, I2, C) += scatter of g (B_df, O.., C) by df (B_df, O.., 3).
// The caller zeroes `out`. Returns cudaGetLastError().
extern "C" int pulpo_warp_mgrad(const void* df, const void* g, void* out,
                                int B, int B_df, int C,
                                int I0, int I1, int I2, int O0, int O1, int O2,
                                float f0, float f1, float f2, void* stream) {
  const long long total = (long long)B_df * O0 * O1 * O2;
  if (total == 0) return 0;
  const int threads = 256;
  mgrad_kernel<<<blocks_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (const float*)df, (const float*)g, (float*)out,
      B, C, I0, I1, I2, O0, O1, O2, f0, f1, f2, total);
  return (int)cudaGetLastError();
}
