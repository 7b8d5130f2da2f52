// One scaling-and-squaring step of VecInt for Hopper (sm_90a):
//   out = v + trilinear(v, grid + v)      (v = scale * in)
//
// Replaces pulpo_tpu/kernels/warp_local.py:_squaring_step_pallas (the
// 27-tap halo stencil, exact only while max|v| is sub-voxel) and the
// warp_halo cascade that the tiered step falls back to past that bound
// (warp_local.py:377-422). The TPU has no vector gather, hence the
// stencil and its tiers; here one thread per voxel gathers its 8
// corners directly, which is exact at any displacement.
//
// `scale` multiplies every value read (the centre and the corners): the
// 1/2^nsteps scaling of integrate_svf is a power of two, so folding it
// into the first step is exact and saves one pass over the field.
//
// Bound: memory. Each step reads the field once (the corner re-reads
// hit L1/L2: the corners of a smooth field are the neighbours' own
// voxels) and writes it once. The steps cannot fuse into one launch
// without a grid-wide barrier, because step k+1 gathers from anywhere
// in step k's output; integrate_svf ping-pongs two buffers.
//
// Numerics: built with -fmad=false and summed in the order of
// pulpo_tpu/ops/warp.py:warp_image, so the step matches the plain
// PyTorch version's rounding.
//
// Layouts: one kernel body, two instantiations that differ only in the
// addressing of component ch of voxel v in row b:
//   channels-last  (B, S0, S1, S2, 3):  (b * n + v) * 3 + ch
//   channels-first (B, 3, S0, S1, S2):  (b * 3 + ch) * n + v
// The channels-first one replaces pulpo_tpu/kernels/warp_local.py:
// _squaring_step_cf_pallas (the stencil on the TPU's tile-padded CF
// layout, B x 3 x (S0+2) x r8(S1+2) x r128(S2+2)) and the
// squaring_beyond_cf cascade past its bound (warp_local.py:629-649,
// warp_halo.py:1687): the field here is unpadded, since a gather needs
// no halo and the card no (8, 128) tiles. The arithmetic is the same
// operations in the same order, so the two instantiations are
// bit-equal on the same field. In CF each component plane is read
// with unit stride between neighbouring threads (coalesced), where CL
// reads every third float.
//
// Dimensions: the body is also templated on the number of spatial axes
// ND. The 2D instantiation (channels-last (B, S0, S1, 2), 4 corners x 2
// components) replaces the ndims == 2 arm of _squaring_step_pallas
// (warp_local.py:186-202, _step_kernel_2d: a 3x3 hat-weight stencil
// over the whole padded slice, one grid step per row) and the XLA
// gather that _squaring_step_tiered takes for a 2D field past the
// sub-voxel bound (warp_local.py:397-401). The 3D instantiations are
// the same operations as before the template gained ND.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float src_coord(int g, float d, float f, int s) {
  float loc = (float)g + d;
  float src = loc * f - 0.5f;
  return fminf(fmaxf(src, 0.0f), (float)(s - 1));
}

// One thread per voxel of a field with ND spatial axes (ND = 3: the
// volumes; ND = 2: the slices of the 2D configuration) and ND
// components: it gathers the 2^ND corners around its source coordinate.
// Axis a of voxel v is its a-th row-major index; corner bit a picks the
// upper neighbour along axis a; weights multiply along the axes in
// order and the corners add in order, as the plain version does.
template <bool CF, int ND>
__global__ void squaring_kernel(const float* __restrict__ vin,
                                float* __restrict__ vout,
                                int S0, int S1, int S2,
                                float f0, float f1, float f2, float scale,
                                long long total) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int S[3] = {S0, S1, S2};
  const float f[3] = {f0, f1, f2};
  long long n = 1;
#pragma unroll
  for (int a = 0; a < ND; ++a) n *= S[a];
  const long long b = idx / n;
  const long long v = idx - b * n;
  int g[ND];
  long long rem = v;
#pragma unroll
  for (int a = ND - 1; a >= 0; --a) {
    g[a] = (int)(rem % S[a]);
    rem /= S[a];
  }
  // element (b, voxel, ch) = row + voxel * vs + ch * cs
  const long long vs = CF ? 1 : ND;
  const long long cs = CF ? n : 1;

  const float* row = vin + b * n * ND;
  float d[ND], c[ND];
#pragma unroll
  for (int a = 0; a < ND; ++a) {
    d[a] = row[v * vs + a * cs] * scale;
    c[a] = src_coord(g[a], d[a], f[a], S[a]);
  }
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
  float acc[ND];
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
    const float* p = row + off * vs;
#pragma unroll
    for (int ch = 0; ch < ND; ++ch) {
      const float contrib = (__ldg(p + ch * cs) * scale) * weight;
      acc[ch] = (corner == 0) ? contrib : acc[ch] + contrib;
    }
  }
  float* o = vout + b * n * ND + v * vs;
#pragma unroll
  for (int ch = 0; ch < ND; ++ch) o[ch * cs] = d[ch] + acc[ch];
}

template <bool CF, int ND>
int launch(const void* vin, void* vout, int B, int S0, int S1, int S2,
           float f0, float f1, float f2, float scale, void* stream) {
  const long long total = (long long)B * S0 * S1 * S2;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  squaring_kernel<CF, ND><<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)vin, (float*)vout, S0, S1, S2, f0, f1, f2, scale, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pulpo_squaring_step(const void* vin, void* vout, int B,
                                   int S0, int S1, int S2,
                                   float f0, float f1, float f2, float scale,
                                   void* stream) {
  return launch<false, 3>(vin, vout, B, S0, S1, S2, f0, f1, f2, scale, stream);
}

// The same step on a channels-first field (B, 3, S0, S1, S2).
extern "C" int pulpo_squaring_step_cf(const void* vin, void* vout, int B,
                                      int S0, int S1, int S2,
                                      float f0, float f1, float f2, float scale,
                                      void* stream) {
  return launch<true, 3>(vin, vout, B, S0, S1, S2, f0, f1, f2, scale, stream);
}

// The same step on a 2D channels-last field (B, S0, S1, 2): the 4
// bilinear corners of each pixel.
extern "C" int pulpo_squaring_step_2d(const void* vin, void* vout, int B,
                                      int S0, int S1, float f0, float f1,
                                      float scale, void* stream) {
  return launch<false, 2>(vin, vout, B, S0, S1, 1, f0, f1, 0.0f, scale, stream);
}
