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
// It walks the forward warp's iteration space, so it takes the forward's
// voxel plan at every C (csrc/gather.cuh, ch = 0; kernels/warp.py:
// dfgrad_plan, over the df's output space): a block takes a tile of one df
// row group's output, decoded from blockIdx by shift and mask plus one 32-bit
// divide for its rows; offsets inside a row are 32-bit, each row's base one
// 64-bit product a block. A thread computes its own voxel: it gathers its 8
// corners of moving row r % B through the read-only path (neighbours share
// them), as the forward does, and writes its own 3 values; df and g are read,
// and gdf written, evict-first; the block walks its group's df rows, loading
// the next row's df while it gathers the current one. C = 1, the training
// step's image, is its own instantiation. C = 36 (the one-hot segmentation
// maps of the OASIS step), where the map and cotangent are 16-byte aligned,
// takes the channels in 16-byte quads: the 9 quads of g are loaded once and
// stay in registers, and a corner's 9 quads are loaded together, a whole slab
// in flight a thread (a loop over the quads, with 9 loads in flight, measured
// slower). Any other C, or a misaligned pointer, takes a runtime loop over
// single channels. The wrapper chooses the body (kernels/warp.py:
// dfgrad_body) and passes it; the entry refuses one that does not fit. The
// first C > 1 body reloaded all C channels of g for each corner with 4-byte
// loads at a 4C-byte lane stride (288 loads of the same 144 bytes a voxel at
// C = 36) and ran at 0.04 of the byte bound, 7.8x the time of
// grid_sample's VJP; 9-lane groups across the channels, a voxel's partial dot
// products summed by shuffles, measured slower than this body at the large
// shapes (PERF.md). No atomics, so the result is deterministic; moving and df
// may have different spatial shapes (the level_res cross-resolution warp).
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
// Bound: memory. dfgrad reads df (12 B) and g (4C B) once per voxel and
// writes 12 B, and the moving map (4C B a voxel) once; the corners of a
// smooth field are the neighbours' voxels and come from L1/L2. mgrad reads df
// and g and scatters into a volume that stays in L2 at level-0 sizes; the
// atomics resolve in L2.
//
// Numerics: built with -fmad=false, so the coordinate arithmetic rounds
// as in the forward (a source coordinate one ulp off can land across a
// voxel boundary); dfgrad's arithmetic (axis_terms, the corner order,
// each corner's channel sum in channel order) is the same in every body.
// At C = 1 it is bit-equal to the plain version; at C > 1 the plain
// version's channel `sum` adds in its own order, so the two agree to
// rounding (1e-5 of scale).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gather.cuh"

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

// 4 channels from a 16-byte aligned p: evict-first (EF, the cotangent g,
// read once) or through the read-only path (the moving corners, read again
// by the neighbours).
template <bool EF>
__device__ __forceinline__ void load_quad(const float* p, float (&q)[4]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
  const float4 t = EF ? __ldcs(p4) : __ldg(p4);
  q[0] = t.x;
  q[1] = t.y;
  q[2] = t.z;
  q[3] = t.w;
}

// One voxel of row r: the 8 corners of moving row `m` (offsets inside
// the row, 32-bit), C channels of g at `gv`, 3 values to `o`. CT = 36
// (the one-hot segmentation maps, 16-byte aligned): g held in registers
// as 9 quads, each corner's quads loaded together, so a thread has a
// corner's whole slab in flight. Else (C = CT = 1, or CT = 0 and the
// runtime C) a loop over the channels, each channel of g taken against
// the same channel of each corner. Each corner's dot product adds its
// channels in order in every body.
template <int CT>
__device__ __forceinline__ void dfgrad_voxel(const float* __restrict__ m,
                                             const float* __restrict__ gv, float* o,
                                             const Axis (&ax)[3], int C, int I1, int I2,
                                             const float (&f)[3]) {
  int off[8];
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int z = (corner & 1) ? ax[0].i1 : ax[0].i0;
    const int y = (corner & 2) ? ax[1].i1 : ax[1].i0;
    const int x = (corner & 4) ? ax[2].i1 : ax[2].i0;
    off[corner] = ((z * I1 + y) * I2 + x) * C;
  }
  float gm[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (CT == 36) {
    constexpr int NQ = CT / 4;
    float gq[NQ][4];
#pragma unroll
    for (int q = 0; q < NQ; ++q) load_quad<true>(gv + q * 4, gq[q]);
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      float mq[NQ][4];
#pragma unroll
      for (int q = 0; q < NQ; ++q) load_quad<false>(m + off[corner] + q * 4, mq[q]);
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) gm[corner] += gq[q][e] * mq[q][e];
    }
  } else {
    for (int ch = 0; ch < C; ++ch) {
      const float g1 = __ldcs(gv + ch);
#pragma unroll
      for (int corner = 0; corner < 8; ++corner) gm[corner] += g1 * __ldg(m + off[corner] + ch);
    }
  }
  float gw[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int h0 = corner & 1, h1 = (corner >> 1) & 1, h2 = (corner >> 2) & 1;
    const float w0 = axis_weight(ax[0], h0);
    const float w1 = axis_weight(ax[1], h1);
    const float w2 = axis_weight(ax[2], h2);
    const float t0 = gm[corner] * (w1 * w2);
    const float t1 = gm[corner] * (w0 * w2);
    const float t2 = gm[corner] * (w0 * w1);
    gw[0] = h0 ? gw[0] + t0 : gw[0] - t0;
    gw[1] = h1 ? gw[1] + t1 : gw[1] - t1;
    gw[2] = h2 ? gw[2] + t2 : gw[2] - t2;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) __stcs(o + a, gw[a] * (ax[a].dclip * f[a]));
}

// CT: C at compile time (1, or 36 with 16-byte aligned map and cotangent),
// or 0 for the runtime `C`.
template <int CT>
__global__ void __launch_bounds__(gather::THREADS)
dfgrad_kernel(const float* __restrict__ mov, const float* __restrict__ df,
              const float* __restrict__ g, float* __restrict__ out, int B,
              int rows_per_moving, int c_rt, int I0, int I1, int I2, int O0, int O1, int O2,
              float f0, float f1, float f2, gather::Plan p) {
  const int C = CT > 0 ? CT : c_rt;
  const gather::Tile t = gather::tile_of<1>(p);
  const int x = t.x0 + threadIdx.x, y = t.y0 + threadIdx.y, z = t.z0 + threadIdx.z;
  if (x >= O2 || y >= O1 || z >= O0) return;  // no barrier follows
  const int n_out = O0 * O1 * O2;
  const int v = (z * O1 + y) * O2 + x;
  const float f[3] = {f0, f1, f2};

  // rows r = mrow + B * (j0 + k), k < nrows: all read moving row mrow
  const int group = blockIdx.z / B;
  const int mrow = blockIdx.z - group * B;
  const int j0 = group * p.rows;
  const int nrows = min(p.rows, rows_per_moving - j0);
  const float* m = mov + (long long)mrow * I0 * I1 * I2 * C;
  const long long row0 = (long long)B * j0 + mrow;

  float d[3];
  const float* dr = df + row0 * 3 * n_out + v * 3;
#pragma unroll
  for (int a = 0; a < 3; ++a) d[a] = __ldcs(dr + a);
  for (int k = 0; k < nrows; ++k) {
    const long long r = row0 + (long long)B * k;
    Axis ax[3];
    ax[0] = axis_terms(z + p.z0, d[0], f0, I0);
    ax[1] = axis_terms(y, d[1], f1, I1);
    ax[2] = axis_terms(x, d[2], f2, I2);
    if (k + 1 < nrows) {
      const float* dn = df + (r + B) * 3 * n_out + v * 3;
#pragma unroll
      for (int a = 0; a < 3; ++a) d[a] = __ldcs(dn + a);
    }
    dfgrad_voxel<CT>(m, g + r * C * n_out + (long long)v * C, out + r * 3 * n_out + v * 3, ax,
                  C, I1, I2, f);
  }
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
// and g (B_df, O.., C); body: the body the caller chose (kernels/warp.py:
// dfgrad_body), 1 (C = 1), 36 (C = 36 in 16-byte quads, map and cotangent
// 16-byte aligned) or 0 (a loop over single channels, any C), refused where
// it does not fit C and the pointers; plan: the forward's tile plan of the
// df's output space, 12 ints (gather::Plan, kernels/gather.py:warp_plan),
// refused unless it covers the output; with a slab (z0, zg: df, g and gdf
// are O0 planes of a whole output of depth zg, the moving volume whole,
// f0 = I0 / (zg - 1)) each voxel takes its global plane, as the forward's
// slab does. Returns cudaGetLastError().
extern "C" int pulpo_warp_dfgrad(const void* mov, const void* df, const void* g,
                                 void* out, int B, int B_df, int C,
                                 int I0, int I1, int I2, int O0, int O1, int O2,
                                 float f0, float f1, float f2, int body, const int* plan,
                                 void* stream) {
  const long long n_out = (long long)O0 * O1 * O2;
  const long long n_in = (long long)I0 * I1 * I2;
  if (B_df == 0 || n_out == 0) return 0;
  if (B < 1 || C < 1 || B_df % B != 0) return (int)cudaErrorInvalidValue;
  const bool fits = body == 0 || (body == 1 && C == 1) ||
                    (body == 36 && C == 36 && gather::aligned16(mov) && gather::aligned16(g));
  if (!fits) return (int)cudaErrorInvalidValue;
  const gather::Plan p = gather::read_plan(plan);
  const long long widest = n_out * (C > 3 ? C : 3);
  if (p.v != 1 || p.ch != 0 || !gather::valid_slab(p, O0) ||
      !gather::valid(p, O2, O1, O0, B_df / B, B, widest > n_in * C ? widest : n_in * C))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = gather::grid(p, B), block = gather::block(p);
  const cudaStream_t s = (cudaStream_t)stream;
  auto launch = [&](auto kernel) {
    kernel<<<grid, block, 0, s>>>((const float*)mov, (const float*)df, (const float*)g,
                                  (float*)out, B, B_df / B, C, I0, I1, I2, O0, O1, O2, f0, f1,
                                  f2, p);
  };
  if (body == 1)
    launch(dfgrad_kernel<1>);
  else if (body == 36)
    launch(dfgrad_kernel<36>);
  else
    launch(dfgrad_kernel<0>);
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
