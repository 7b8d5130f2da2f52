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
// Bound: memory. The step reads v and g once and writes vbar once (36 B
// per voxel). What costs is the scatter: each voxel adds 8 corners x 3
// components of its data term, and one global atomic for each queues in
// the L2. The design sends fewer of them:
// - a block's tile of source voxels (tx x ty of a plane, from blockIdx
//   by shift and mask, csrc/gather.cuh; the plan from
//   kernels/gather.py:squaring_bwd_plan) marches along z through a
//   chunk of tz planes, one thread a column, with no barrier
//   (csrc/fixed.cuh, March);
// - a thread keeps its upper-z corners' terms, and the v it gathered
//   there, in registers until the next plane, whose lower-z corners are
//   the same cells where the field is smooth (the floor of z + v_z moves
//   by one): it adds the terms there and gathers only the upper corners;
// - a lane takes the next lane's lower-x corners' terms where they are
//   its upper-x corners' cells (the next voxel of the line), by shuffles;
// - every remaining term goes to an int64 buffer with a fire-and-forget
//   64-bit integer atomic (RED).
// The data term is summed order-free (csrc/fixed.cuh): each term w * g
// is quantized to a 64-bit fixed-point integer at the launch's scale,
// merged and added as an integer, so the sum does not depend on the
// order of the adds and the output repeats itself bit for bit; its
// quantization is warp_mgrad_plain's (kernels/warp.py). The voxel's own
// terms (identity and coordinate) are float32, stored into its cell of
// `out`; the last pass adds the data term's sum to them in double and
// rounds the total to float32 once (the plain version adds them the
// same way: bit-equal). A launch is
// four operations on the stream: the buffer zeroed, the max |g| pass,
// the march and the convert pass; no host sync.
// A shared-memory window that took the scatter first (the tile plus a
// halo) was built for the float32 design and measured slower at every
// launched shape: sm_90 has no native shared-memory float add, so each
// add was a compare-and-swap loop (ATOMS.CAST.SPIN in the SASS); see
// PERF.md.
//
// Slab launch (the depth-sharded model's step, parallel/spatial.py): the
// forward slab's source voxels are planes z0 .. z0 + S0 - 1 of a whole
// field of depth zg; the block marches those planes at their global index,
// reads v from the whole field and sends into a whole-field cotangent.
//
// Clamp convention, as csrc/warp_bwd.cu: clip'(u) is 1 inside, 1/2 at a
// tie with a bound (jax.grad through jnp.clip), 0 outside.
//
// Numerics: built with -fmad=false (coordinates round as the forward's).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed.cuh"
#include "gather.cuh"

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

__global__ void __launch_bounds__(gather::THREADS)
squaring_bwd_kernel(const float* __restrict__ vin, const float* __restrict__ g,
                    unsigned long long* __restrict__ acc, float* __restrict__ out,
                    const unsigned* __restrict__ top, int clog, int S0, int S1, int S2,
                    float f0, float f1, float f2, gather::Plan p) {
  const gather::Tile t = gather::tile_of<1>(p);
  // v, out and acc are whole fields (depth p.zg), g the slab of S0 planes from z0
  const int n3 = S0 * S1 * S2 * 3, n3_whole = p.zg * S1 * S2 * 3;
  const float* vrow = vin + (long long)blockIdx.z * n3_whole;
  const float* grow = g + (long long)blockIdx.z * n3;
  float* orow = out + (long long)blockIdx.z * n3_whole;
  unsigned long long* arow = acc + (long long)blockIdx.z * n3_whole;
  const int x = t.x0 + threadIdx.x, y = t.y0 + threadIdx.y;
  const bool mine = x < S2 && y < S1;
  const int z1 = min(t.z0 + p.tz, S0);
  const int S[3] = {p.zg, S1, S2};
  const float f[3] = {f0, f1, f2};
  // the data terms' scale; 0 where nothing is added (a zero or non-finite
  // max |g|: the convert pass then writes the own terms, or NaN)
  double up = 0.0, down = 0.0;
  if (!fixed::scale_of(*top, clog, &up, &down)) up = 0.0;

  auto send = [&](int cz, int cy, int cx, const long long (&v3)[3]) {
    unsigned long long* o = arow + ((cz * S1 + cy) * S2 + cx) * 3;
#pragma unroll
    for (int a = 0; a < 3; ++a) fixed::add(o + a, v3[a]);
  };

  __shared__ fixed::Lines<3> lines;
  fixed::March<3> march(p.tx, p.ty);
  float held_v[4][3];  // v at the held upper-z corners
  // g and v at the voxel of plane z, loaded while the plane before is merged
  float gn[3] = {0.0f, 0.0f, 0.0f}, vn[3] = {0.0f, 0.0f, 0.0f};
  auto load = [&](int z) {
    if (z < z1 && mine) {
      const int o = ((z * S1 + y) * S2 + x) * 3;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        gn[a] = grow[o + a];
        vn[a] = vrow[o + p.z0 * S1 * S2 * 3 + a];
      }
    }
  };
  load(t.z0);
  // iteration z: the voxel of source plane z (z < z1), then what is held
  for (int z = t.z0; z <= z1; ++z) {  // the same for the whole block
    const bool have = z < z1 && mine;
    const float gv[3] = {gn[0], gn[1], gn[2]}, vv[3] = {vn[0], vn[1], vn[2]};
    load(z + 1);
    long long val[8][3];
    int i0[3] = {-1, -1, -1}, i1[3] = {-1, -1, -1};
#pragma unroll
    for (int k = 0; k < 8; ++k) val[k][0] = val[k][1] = val[k][2] = 0;
    if (have) {
      const int og = ((z + p.z0) * S1 + y) * S2 * 3 + x * 3;  // the voxel in the whole field
      const int pos[3] = {z + p.z0, y, x};
      float w[3], dclip[3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
        axis_terms(pos[a], vv[a], f[a], S[a], &i0[a], &i1[a], &w[a], &dclip[a]);
      // the lower-z corners are the held upper-z ones: their v is at hand
      const bool same = march.continues(i0);

      float gw[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int corner = 0; corner < 8; ++corner) {
        const int h0 = corner & 1, h1 = (corner >> 1) & 1, h2 = (corner >> 2) & 1;
        const int cz = h0 ? i1[0] : i0[0], cy = h1 ? i1[1] : i0[1], cx = h2 ? i1[2] : i0[2];
        const float w0 = h0 ? w[0] : 1.0f - w[0];
        const float w1 = h1 ? w[1] : 1.0f - w[1];
        const float w2 = h2 ? w[2] : 1.0f - w[2];
        const float* m = vrow + ((cz * S1 + cy) * S2 + cx) * 3;
        float vc[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) vc[a] = !h0 && same ? held_v[corner >> 1][a] : __ldg(m + a);
        if (h0)
#pragma unroll
          for (int a = 0; a < 3; ++a) held_v[corner >> 1][a] = vc[a];
        const float gm = gv[0] * vc[0] + gv[1] * vc[1] + gv[2] * vc[2];
        const float t0 = gm * (w1 * w2);
        const float t1 = gm * (w0 * w2);
        const float t2 = gm * (w0 * w1);
        gw[0] = h0 ? gw[0] + t0 : gw[0] - t0;
        gw[1] = h1 ? gw[1] + t1 : gw[1] - t1;
        gw[2] = h2 ? gw[2] + t2 : gw[2] - t2;
        // data term: the gather's transpose, quantized
        const float wc = (w0 * w1) * w2;
#pragma unroll
        for (int a = 0; a < 3; ++a) val[corner][a] = fixed::quantize(wc * gv[a], up);
      }
      // identity and coordinate terms, this voxel's own cell (float32)
#pragma unroll
      for (int a = 0; a < 3; ++a) orow[og + a] = gv[a] + gw[a] * (dclip[a] * f[a]);
    }
    march.plane(have, i0, i1, val, S, lines, send);
  }
}

}  // namespace

// vbar (B, S0, S1, S2, 3) = g + dfgrad(v, v, g) + mgrad(v, v, g); work:
// B * zg * S1 * S2 * 3 + 1 int64 (the data term's fixed-point targets and
// the header, csrc/fixed.cuh); plan: 12 ints, gather::Plan with tz the
// planes a block marches (kernels/gather.py:squaring_bwd_plan). With a
// slab (plan z0, zg; the depth-sharded model's step): v and vbar are
// whole fields of depth zg, g the cotangent of the forward slab's S0
// planes from z0 (f0 = zg / (zg - 1)); vbar is then the slab's share of
// the whole cotangent. phases: a bit mask of the launch's three steps, 7
// for a whole launch: 1 zeroes `work` and writes max|g| into its header,
// 2 the march (the data terms into `work`, the own terms into `out`), 4
// the convert pass into `out`. A sharded step runs them apart: the
// column's max goes into the header after 1, and the other ranks' sums
// of the slab's planes are added into the targets after 2, so that its
// slab is the whole launch's (kernels/squaring.py:squaring_step_bwd's
// `column`). `out` must not alias v or g. Returns the
// first CUDA error, or 0 (cudaErrorInvalidValue for a plan the kernel
// cannot walk).
extern "C" int pulpo_squaring_step_bwd(const void* vin, const void* g, void* out, void* work,
                                       int B, int S0, int S1, int S2,
                                       float f0, float f1, float f2, const int* plan,
                                       int phases, void* stream) {
  if ((long long)B * S0 * S1 * S2 == 0) return 0;
  const gather::Plan p = gather::read_plan(plan);
  const long long row = (long long)p.zg * S1 * S2 * 3;
  if (!fixed::valid_march(p, B, S0, S1, S2, row) || phases < 1 || phases > 7)
    return (int)cudaErrorInvalidValue;
  const long long n = B * row, plane = (long long)S1 * S2 * 3;
  const int clog = fixed::ceil_log2((long long)B * p.zg * S1 * S2);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (phases & 1) err = fixed::begin(work, n, (const float*)g, (long long)B * S0 * plane, s);
  if (err == cudaSuccess && (phases & 2)) {
    squaring_bwd_kernel<<<fixed::march_grid(p, B), dim3(p.tx, p.ty), 0, s>>>(
        (const float*)vin, (const float*)g, (unsigned long long*)work, (float*)out,
        fixed::header(work, n), clog, S0, S1, S2, f0, f1, f2, p);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && (phases & 4))
    err = fixed::finish(work, (float*)out, n, clog, row, p.z0 * plane, (p.z0 + S0) * plane, s);
  return (int)err;
}
