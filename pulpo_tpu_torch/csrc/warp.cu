// Dense trilinear warp for Hopper (sm_90a).
//
// Replaces pulpo_tpu/kernels/warp_halo.py:_warp_halo_pallas (and the
// cascade, sparse-repair and XLA-gather branches around it, which
// compute the same function): out[r, p] = trilinear(moving[r % B],
// src(p)), with the reference SpatialTransformer's coordinate map
//   src_i = clamp((g_i + df_i) * S_in_i / (S_out_i - 1) - 0.5, 0, S_in_i - 1)
// (grid_sample, border padding, align_corners=False).
//
// Design: one thread per (df row, output voxel). It reads its 3 df
// values, computes the clamped source coordinate, gathers the 8
// corners (i1 = min(i0 + 1, S - 1)) of every channel from moving row
// r % B, and writes C values. A gather is exact at any displacement and
// any input size, so the TPU's halo bound and its fallbacks have no
// counterpart here. The TPU kernel is shaped by the lack of a vector
// gather; on this card the warp is bound by memory: each df value is
// read once, each output written once, and the moving volume (the
// smallest of the three at C = 1) is re-read from L2, where the
// smooth fields of registration keep neighbouring threads' corners.
//
// Numerics: built with -fmad=false, so every multiply and add rounds
// as the plain PyTorch version's separate operations do; weights are
// multiplied along the axes in order and the corners summed in order,
// as in pulpo_tpu/ops/warp.py:warp_image.
//
// Layouts: one kernel body, two instantiations that differ only in the
// addressing (n = voxels of one row):
//   channels-last:  moving (B, *S_in, C), df (B_df, *S_out, 3),
//                   out (B_df, *S_out, C); element (r, v, c) at (r * n + v) * C + c
//   channels-first: moving (B, C, *S_in), df (B_df, 3, *S_out),
//                   out (B_df, C, *S_out); element (r, v, c) at (r * C + c) * n + v
// The channels-first one replaces pulpo_tpu/kernels/warp_halo.py:
// _warp_halo_pallas_cf with its tier ladder, sparse repair and
// terminal fallback (warp_halo.py:1560-1685, 1722-1736), which warp the
// decode's image (C = 1) or field (C = 3) by a df on the TPU's
// tile-padded CF layout. Here the fields are unpadded: a gather needs
// no halo. Same operations in the same order, so the two
// instantiations are bit-equal; at C = 1 the CF output is the CL one
// reshaped. In CF each df component plane and each output plane is
// read or written with unit stride between neighbouring threads.
//
// Dimensions: the body is also templated on the number of spatial axes
// ND. The 2D instantiation (channels-last, 4 bilinear corners) is the
// 2D image and field warp of the 2D configuration, which the JAX
// package computes as an XLA gather (pulpo_tpu/ops/warp.py:154-171,
// "2D fall through to the gather path"): a kernel here, so that no
// plain version runs on the card's forward path. The 3D instantiations
// are the same operations as before the template gained ND.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float src_coord(int g, float d, float f, int s_in) {
  float loc = (float)g + d;
  float src = loc * f - 0.5f;
  return fminf(fmaxf(src, 0.0f), (float)(s_in - 1));
}

// ND spatial axes (3: volumes; 2: the slices of the 2D configuration);
// the df has ND components, the 2^ND corners are gathered. Axis a of an
// output voxel is its a-th row-major index; corner bit a picks the upper
// neighbour along axis a.
template <bool CF, int ND>
__global__ void warp_kernel(const float* __restrict__ mov,
                            const float* __restrict__ df,
                            float* __restrict__ out,
                            int B, int C,
                            int I0, int I1, int I2,
                            int O0, int O1, int O2,
                            float f0, float f1, float f2,
                            long long total) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int S[3] = {I0, I1, I2};
  const int O[3] = {O0, O1, O2};
  const float f[3] = {f0, f1, f2};
  long long n_out = 1, n_in = 1;
#pragma unroll
  for (int a = 0; a < ND; ++a) {
    n_out *= O[a];
    n_in *= S[a];
  }
  const long long r = idx / n_out;
  const long long v = idx - r * n_out;
  int g[ND];
  long long rem = v;
#pragma unroll
  for (int a = ND - 1; a >= 0; --a) {
    g[a] = (int)(rem % O[a]);
    rem /= O[a];
  }

  // df component a of this voxel: d[a * ds]; channel c of a moving or
  // output voxel: p[c * cs_in] / o[c * cs_out]; a moving voxel at
  // offset off: m + off * vs
  const float* d = CF ? df + r * ND * n_out + v : df + idx * ND;
  const long long ds = CF ? n_out : 1;
  float c[ND];
#pragma unroll
  for (int a = 0; a < ND; ++a) c[a] = src_coord(g[a], d[a * ds], f[a], S[a]);
  int i0[ND], i1[ND];
  float w[ND];
  for (int a = 0; a < ND; ++a) {
    float fl = floorf(c[a]);
    i0[a] = (int)fl;
    i1[a] = min(i0[a] + 1, S[a] - 1);
    w[a] = c[a] - fl;
  }
  long long stride[ND];
  stride[ND - 1] = 1;
#pragma unroll
  for (int a = ND - 2; a >= 0; --a) stride[a] = stride[a + 1] * S[a + 1];
  const float* m = mov + (r % B) * n_in * C;
  const long long vs = CF ? 1 : C;
  const long long cs_in = CF ? n_in : 1;
  const long long cs_out = CF ? n_out : 1;
  float* o = CF ? out + r * C * n_out + v : out + idx * C;
  for (int ch = 0; ch < C; ++ch) {
    float acc = 0.0f;
#pragma unroll
    for (int corner = 0; corner < (1 << ND); ++corner) {
      long long off = 0;
      float weight = 1.0f;
#pragma unroll
      for (int a = 0; a < ND; ++a) {
        const int hi = (corner >> a) & 1;
        off += (long long)(hi ? i1[a] : i0[a]) * stride[a];
        const float wa = hi ? w[a] : 1.0f - w[a];
        weight = (a == 0) ? wa : weight * wa;
      }
      const float contrib = __ldg(m + off * vs + ch * cs_in) * weight;
      acc = (corner == 0) ? contrib : acc + contrib;
    }
    o[ch * cs_out] = acc;
  }
}

template <bool CF, int ND>
int launch(const void* mov, const void* df, void* out, int B, int B_df, int C,
           int I0, int I1, int I2, int O0, int O1, int O2,
           float f0, float f1, float f2, void* stream) {
  const long long total = (long long)B_df * O0 * O1 * O2;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  warp_kernel<CF, ND><<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)mov, (const float*)df, (float*)out, B, C, I0, I1, I2,
      O0, O1, O2, f0, f1, f2, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pulpo_warp(const void* mov, const void* df, void* out,
                          int B, int B_df, int C,
                          int I0, int I1, int I2, int O0, int O1, int O2,
                          float f0, float f1, float f2, void* stream) {
  return launch<false, 3>(mov, df, out, B, B_df, C, I0, I1, I2, O0, O1, O2,
                       f0, f1, f2, stream);
}

// The same warp on channels-first tensors: moving (B, C, *S_in),
// df (B_df, 3, *S_out), out (B_df, C, *S_out).
extern "C" int pulpo_warp_cf(const void* mov, const void* df, void* out,
                             int B, int B_df, int C,
                             int I0, int I1, int I2, int O0, int O1, int O2,
                             float f0, float f1, float f2, void* stream) {
  return launch<true, 3>(mov, df, out, B, B_df, C, I0, I1, I2, O0, O1, O2,
                      f0, f1, f2, stream);
}

// The same warp in 2D, channels-last: moving (B, I0, I1, C), df
// (B_df, O0, O1, 2), out (B_df, O0, O1, C).
extern "C" int pulpo_warp_2d(const void* mov, const void* df, void* out,
                             int B, int B_df, int C, int I0, int I1, int O0, int O1,
                             float f0, float f1, void* stream) {
  return launch<false, 2>(mov, df, out, B, B_df, C, I0, I1, 1, O0, O1, 1,
                          f0, f1, 0.0f, stream);
}
