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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float src_coord(int g, float d, float f, int s_in) {
  float loc = (float)g + d;
  float src = loc * f - 0.5f;
  return fminf(fmaxf(src, 0.0f), (float)(s_in - 1));
}

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
  const long long n_out = (long long)O0 * O1 * O2;
  const long long n_in = (long long)I0 * I1 * I2;
  const long long r = idx / n_out;
  const long long v = idx - r * n_out;
  const int x = (int)(v % O2);
  const int y = (int)((v / O2) % O1);
  const int z = (int)(v / ((long long)O1 * O2));

  const float* d = df + idx * 3;
  const float c[3] = {src_coord(z, d[0], f0, I0), src_coord(y, d[1], f1, I1),
                      src_coord(x, d[2], f2, I2)};
  const int S[3] = {I0, I1, I2};
  int i0[3], i1[3];
  float w[3];
  for (int a = 0; a < 3; ++a) {
    float fl = floorf(c[a]);
    i0[a] = (int)fl;
    i1[a] = min(i0[a] + 1, S[a] - 1);
    w[a] = c[a] - fl;
  }
  const long long stride[3] = {(long long)I1 * I2, (long long)I2, 1};
  const float* m = mov + (r % B) * n_in * C;
  float* o = out + idx * C;
  for (int ch = 0; ch < C; ++ch) {
    float acc = 0.0f;
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      long long off = 0;
      float weight = 1.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int hi = (corner >> a) & 1;
        off += (long long)(hi ? i1[a] : i0[a]) * stride[a];
        const float wa = hi ? w[a] : 1.0f - w[a];
        weight = (a == 0) ? wa : weight * wa;
      }
      const float contrib = __ldg(m + off * C + ch) * weight;
      acc = (corner == 0) ? contrib : acc + contrib;
    }
    o[ch] = acc;
  }
}

}  // namespace

extern "C" int pulpo_warp(const void* mov, const void* df, void* out,
                          int B, int B_df, int C,
                          int I0, int I1, int I2, int O0, int O1, int O2,
                          float f0, float f1, float f2, void* stream) {
  const long long total = (long long)B_df * O0 * O1 * O2;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  warp_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)mov, (const float*)df, (float*)out, B, C, I0, I1, I2,
      O0, O1, O2, f0, f1, f2, total);
  return (int)cudaGetLastError();
}
