// One scaling-and-squaring step of VecInt for Hopper (sm_90a):
//   out = v + trilinear(v, grid + v)      (v = scale * in)
//
// Replaces:
//   - pulpo_tpu/kernels/warp_local.py:142 _squaring_step_pallas, 3D
//     (:167, the 27-tap halo stencil, exact only while max|v| is
//     sub-voxel) and 2D (:190, _step_kernel_2d, a 3x3 hat-weight stencil
//     over the padded slice), with the warp_halo cascade and the XLA
//     gather that the tiered step takes past that bound
//     (warp_local.py:377-422, 397-401);
//   - pulpo_tpu/kernels/warp_local.py:603 _squaring_step_cf_pallas (the
//     stencil on the TPU's tile-padded CF layout, B x 3 x (S0+2) x
//     r8(S1+2) x r128(S2+2)) and the squaring_beyond_cf cascade past its
//     bound (warp_local.py:629-649, warp_halo.py:1687): the channels-first
//     instantiation, on an unpadded field.
// The TPU has no vector gather, hence the stencils and their tiers; here
// each voxel gathers its 2^ND corners, exact at any displacement.
//
// `scale` multiplies every value read (the centre and the corners): the
// 1/2^nsteps scaling of integrate_svf is a power of two, so folding it
// into the first step is exact and saves one pass over the field.
//
// What bounds it on this card: device memory on a large launch, the
// latency of its dependent loads on a small one. A step reads the field
// once and writes it once (the corners of a smooth field are the
// neighbours' own voxels, read again from L1 and L2); the steps cannot
// fuse into one launch without a grid-wide barrier, because step k+1
// gathers from anywhere in step k's output. The first version (one
// voxel a thread of a flat 1D grid, its index split by 64-bit divides
// and modulos, 64-bit offsets) ran at under half of the byte bound
// (PERF.md). This design keeps one voxel a thread, each thread's own
// from registers, and takes its voxel from a tile (csrc/gather.cuh):
// planes x lines x a strip of up to 128 voxels of the innermost axis,
// derived from blockIdx by shift and mask, so no thread divides and
// offsets in a row are 32-bit. Two heavier designs were measured slower
// at every launched shape and are not built (PERF.md,
// scripts/bench_gather.py): 4 voxels a thread moved as 16-byte quads
// through the tile in shared memory (a thread waits on its 4 voxels'
// gathers in turn, and the launch has a quarter of the threads to hide
// them), and that tile staged with a halo so that corners read shared
// memory (each tile reads its halo again, and the shared memory cuts
// the resident blocks).
//
// Numerics: built with -fmad=false and summed in the order of
// pulpo_tpu/ops/warp.py:warp_image, so the step matches the plain
// PyTorch version's rounding. The arithmetic per voxel is the first
// version's; only the addressing changed.
//
// Slab launch (the depth-sharded model, parallel/spatial.py; every
// instantiation): the input is the whole field, all-gathered along its
// first axis (depth, or a 2D field's H: the plan's zg), and the launch
// computes the output planes (2D: lines) z0 .. z0 + S0 - 1 (S0 the slab's
// extent): a voxel reads its own displacement at its global plane or line
// and gathers its corners from the whole field, so the slab is bit-equal
// to the matching planes of the whole step. In the channels-first layout
// a component's stride differs between the two: the whole field's voxel
// count in the input, the slab's in the output.
//
// Layouts: one kernel body, instantiated for the layout of component ch
// of voxel v in row b:
//   channels-last  (B, *S, ND):  (b * n + v) * ND + ch
//   channels-first (B, ND, *S):  (b * ND + ch) * n + v
// the same operations in the same order, so the two are bit-equal; and
// for ND = 3 (volumes) and ND = 2 (the 2D configuration's slices,
// channels-last, 4 corners x 2 components).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gather.cuh"

namespace {

template <bool CF, int ND>
__global__ void __launch_bounds__(gather::THREADS)
squaring_kernel(const float* __restrict__ vin, float* __restrict__ vout,
                int S0, int S1, int S2, float f0, float f1, float f2, float scale,
                gather::Plan p) {
  const int s3[3] = {S0, S1, S2};
  const float f3[3] = {f0, f1, f2};
  int s[ND];
  float f[ND];
#pragma unroll
  for (int a = 0; a < ND; ++a) {
    s[a] = s3[a];
    f[a] = f3[a];
  }
  // the output's (slab's) planes Z (2D: lines Y); the input's first axis,
  // s[0], is the whole field's
  const int X = s[ND - 1], Y = s[ND - 2], Z = ND == 3 ? s[0] : 1;
  s[0] = p.zg;
  const gather::Tile t = gather::tile_of<1>(p);
  const int x = t.x0 + threadIdx.x, y = t.y0 + threadIdx.y, z = t.z0 + threadIdx.z;
  if (x >= X || y >= Y || z >= Z) return;
  const int n = X * Y * Z;
  const int n_in = n / gather::slab_axis<ND>(Y, Z) * p.zg;
  // a voxel's element offset along each axis, and a component's
  int st[ND];
  st[ND - 1] = CF ? 1 : ND;
#pragma unroll
  for (int a = ND - 2; a >= 0; --a) st[a] = st[a + 1] * s[a + 1];
  // a component's stride: the whole field's voxels in the input, the slab's in the output
  const int cs_in = CF ? n_in : 1, cs_out = CF ? n : 1;
  const float* row = vin + (long long)blockIdx.z * ND * n_in;
  const int v = (z * Y + y) * X + x;
  int zg, yg;  // the voxel's plane and line in the whole field
  gather::global_zy<ND>(p, z, y, zg, yg);
  const int vg = (zg * Y + yg) * X + x;

  const int g3[3] = {zg, yg, x};
  float d[ND], c[ND];
#pragma unroll
  for (int a = 0; a < ND; ++a) {
    d[a] = __ldg(row + vg * st[ND - 1] + a * cs_in) * scale;
    c[a] = gather::src_coord(g3[a + 3 - ND], d[a], f[a], s[a]);
  }
  const gather::Corners<ND> k = gather::corners<ND>(c, s);
  float acc[ND];
#pragma unroll
  for (int corner = 0; corner < (1 << ND); ++corner) {
    const float* pc = row + gather::corner_offset<ND>(k, corner, st);
    const float weight = gather::corner_weight<ND>(k, corner);
#pragma unroll
    for (int ch = 0; ch < ND; ++ch) {
      const float contrib = (__ldg(pc + ch * cs_in) * scale) * weight;
      acc[ch] = (corner == 0) ? contrib : acc[ch] + contrib;
    }
  }
  float* o = vout + (long long)blockIdx.z * ND * n + v * st[ND - 1];
#pragma unroll
  for (int ch = 0; ch < ND; ++ch) o[ch * cs_out] = d[ch] + acc[ch];
}

template <bool CF, int ND>
int launch(const void* vin, void* vout, int B, int S0, int S1, int S2,
           float f0, float f1, float f2, float scale, const int* plan, void* stream) {
  const int X = ND == 3 ? S2 : S1, Y = ND == 3 ? S1 : S0, Z = ND == 3 ? S0 : 1;
  const long long n = (long long)X * Y * Z;
  if (B == 0 || n == 0) return 0;
  const gather::Plan p = gather::read_plan(plan);
  // a slab's input row is the whole field's
  const int E = gather::slab_axis<ND>(Y, Z);
  if (p.v != 1 || !gather::valid_slab(p, E) ||
      !gather::valid(p, X, Y, Z, 1, B, n / E * p.zg * ND))
    return (int)cudaErrorInvalidValue;
  squaring_kernel<CF, ND><<<gather::grid(p, B), gather::block(p), 0, (cudaStream_t)stream>>>(
      (const float*)vin, (float*)vout, S0, S1, S2, f0, f1, f2, scale, p);
  return (int)cudaGetLastError();
}

}  // namespace

// plan: the launch's tile plan, 12 ints (gather::Plan) from
// kernels/gather.py:squaring_plan. S0 is the output's depth: the whole
// field's, or the slab's (plan z0, zg: vin holds the whole field of
// depth zg, vout the slab, f0 = zg / (zg - 1)).
extern "C" int pulpo_squaring_step(const void* vin, void* vout, int B,
                                   int S0, int S1, int S2,
                                   float f0, float f1, float f2, float scale,
                                   const int* plan, void* stream) {
  return launch<false, 3>(vin, vout, B, S0, S1, S2, f0, f1, f2, scale, plan, stream);
}

// The same step on a channels-first field (B, 3, S0, S1, S2); a slab as
// above (vin (B, 3, zg, S1, S2), vout (B, 3, S0, S1, S2)).
extern "C" int pulpo_squaring_step_cf(const void* vin, void* vout, int B,
                                      int S0, int S1, int S2,
                                      float f0, float f1, float f2, float scale,
                                      const int* plan, void* stream) {
  return launch<true, 3>(vin, vout, B, S0, S1, S2, f0, f1, f2, scale, plan, stream);
}

// The same step on a 2D channels-last field (B, S0, S1, 2): the 4
// bilinear corners of each pixel; a slab as above along S0 (vin (B, zg,
// S1, 2), vout (B, S0, S1, 2), f0 = zg / (zg - 1)).
extern "C" int pulpo_squaring_step_2d(const void* vin, void* vout, int B,
                                      int S0, int S1, float f0, float f1,
                                      float scale, const int* plan, void* stream) {
  return launch<false, 2>(vin, vout, B, S0, S1, 1, f0, f1, 0.0f, scale, plan, stream);
}
