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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float src_coord(int g, float d, float f, int s) {
  float loc = (float)g + d;
  float src = loc * f - 0.5f;
  return fminf(fmaxf(src, 0.0f), (float)(s - 1));
}

template <bool CF>
__global__ void squaring_kernel(const float* __restrict__ vin,
                                float* __restrict__ vout,
                                int S0, int S1, int S2,
                                float f0, float f1, float f2, float scale,
                                long long total) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long n = (long long)S0 * S1 * S2;
  const long long b = idx / n;
  const long long v = idx - b * n;
  const int x = (int)(v % S2);
  const int y = (int)((v / S2) % S1);
  const int z = (int)(v / ((long long)S1 * S2));
  // element (b, voxel, ch) = row + voxel * vs + ch * cs
  const long long vs = CF ? 1 : 3;
  const long long cs = CF ? n : 1;

  const float* row = vin + b * n * 3;
  const float d[3] = {row[v * vs] * scale, row[v * vs + cs] * scale,
                      row[v * vs + 2 * cs] * scale};
  const float c[3] = {src_coord(z, d[0], f0, S0), src_coord(y, d[1], f1, S1),
                      src_coord(x, d[2], f2, S2)};
  const int S[3] = {S0, S1, S2};
  int i0[3], i1[3];
  float w[3];
  for (int a = 0; a < 3; ++a) {
    float fl = floorf(c[a]);
    i0[a] = (int)fl;
    i1[a] = min(i0[a] + 1, S[a] - 1);
    w[a] = c[a] - fl;
  }
  const long long stride[3] = {(long long)S1 * S2, (long long)S2, 1};
  float acc[3];
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
    const float* p = row + off * vs;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float contrib = (__ldg(p + ch * cs) * scale) * weight;
      acc[ch] = (corner == 0) ? contrib : acc[ch] + contrib;
    }
  }
  float* o = vout + b * n * 3 + v * vs;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) o[ch * cs] = d[ch] + acc[ch];
}

template <bool CF>
int launch(const void* vin, void* vout, int B, int S0, int S1, int S2,
           float f0, float f1, float f2, float scale, void* stream) {
  const long long total = (long long)B * S0 * S1 * S2;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  squaring_kernel<CF><<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)vin, (float*)vout, S0, S1, S2, f0, f1, f2, scale, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pulpo_squaring_step(const void* vin, void* vout, int B,
                                   int S0, int S1, int S2,
                                   float f0, float f1, float f2, float scale,
                                   void* stream) {
  return launch<false>(vin, vout, B, S0, S1, S2, f0, f1, f2, scale, stream);
}

// The same step on a channels-first field (B, 3, S0, S1, S2).
extern "C" int pulpo_squaring_step_cf(const void* vin, void* vout, int B,
                                      int S0, int S1, int S2,
                                      float f0, float f1, float f2, float scale,
                                      void* stream) {
  return launch<true>(vin, vout, B, S0, S1, S2, f0, f1, f2, scale, stream);
}
