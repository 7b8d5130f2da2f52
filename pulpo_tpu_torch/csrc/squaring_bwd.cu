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
// components and its own cell's 3, and global float atomics for each
// (27 a voxel) queue in the L2. The design sends fewer of them:
// - a block's tile of source voxels (tx x ty of a plane, from blockIdx
//   by shift and mask, csrc/gather.cuh; the plan from
//   kernels/gather.py:squaring_bwd_plan) marches along z through a
//   chunk of tz planes, one thread a column, with no barrier;
// - a thread keeps its upper-z corners' terms, and the v it gathered
//   there, in registers until the next plane, whose lower-z corners are
//   the same cells where the field is smooth (the floor of z + v_z moves
//   by one): it adds the terms there and gathers only the upper corners;
// - a lane takes the next lane's lower-x corners' terms where they are
//   its upper-x corners' cells (the next voxel of the line), by shuffles;
// - every remaining term goes to `out` with a fire-and-forget float
//   atomic (RED), onto `out` cleared by cudaMemsetAsync in the C entry
//   (12 B a voxel written; the parent kernel copied g, 24 B).
// A shared-memory window that took the scatter first (the tile plus a
// halo, flushed with 16-byte atomics) was built and measured slower at
// every launched shape: sm_90 has no native shared-memory float add, so
// each add was a compare-and-swap loop (ATOMS.CAST.SPIN in the SASS);
// see PERF.md. The order of the adds is not fixed; the result is held
// to a tolerance.
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
                    float* __restrict__ out, int S0, int S1, int S2, float f0, float f1,
                    float f2, gather::Plan p) {
  const gather::Tile t = gather::tile_of<1>(p);
  const int nthreads = p.tx * p.ty;
  const int tid = threadIdx.y * p.tx + threadIdx.x;
  // v and out are whole fields (depth p.zg), g the slab of S0 planes from z0
  const int n3 = S0 * S1 * S2 * 3, n3_whole = p.zg * S1 * S2 * 3;
  const float* vrow = vin + (long long)blockIdx.z * n3_whole;
  const float* grow = g + (long long)blockIdx.z * n3;
  float* orow = out + (long long)blockIdx.z * n3_whole;
  const int x = t.x0 + threadIdx.x, y = t.y0 + threadIdx.y;
  const bool mine = x < S2 && y < S1;
  const int z1 = min(t.z0 + p.tz, S0);
  const int S[3] = {p.zg, S1, S2};
  const float f[3] = {f0, f1, f2};
  const int lane = tid & 31;
  const int lanes = min(32, nthreads - (tid - lane));  // threads of this warp
  const unsigned mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;

  // adds 3 floats to cell (cz, cy, cx); nothing for zeros (a term merged
  // into another's)
  auto send = [&](int cz, int cy, int cx, const float (&v3)[3]) {
    if (v3[0] == 0.0f && v3[1] == 0.0f && v3[2] == 0.0f) return;
    float* o = orow + ((cz * S1 + cy) * S2 + cx) * 3;
#pragma unroll
    for (int a = 0; a < 3; ++a) atomicAdd(o + a, v3[a]);
  };
  auto upper = [&](int lo, int a) { return min(lo + 1, S[a] - 1); };

  // The data terms of a voxel's 8 corners: bit 0 of a corner picks the
  // upper z, bit 1 the upper y, bit 2 the upper x.
  float held[4][3];    // upper-z corners' terms (y, x bits) of the previous source plane
  float held_v[4][3];  // and v at those corners
  int held_z = -1, held_y = 0, held_x = 0;  // their plane, lower y and x; held_z < 0: none
  // iteration z: the voxel of source plane z (z < z1), then what is held
  for (int z = t.z0; z <= z1; ++z) {  // the same for the whole block
    const bool have = z < z1 && mine;
    float val[8][3];
    int i0[3] = {-1, -1, -1}, i1[3] = {-1, -1, -1};
#pragma unroll
    for (int k = 0; k < 8; ++k) val[k][0] = val[k][1] = val[k][2] = 0.0f;
    if (have) {
      const int o = ((z * S1 + y) * S2 + x) * 3;
      const int og = o + p.z0 * S1 * S2 * 3;  // the voxel in the whole field
      const float gv[3] = {grow[o], grow[o + 1], grow[o + 2]};
      const int pos[3] = {z + p.z0, y, x};
      float w[3], dclip[3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
        axis_terms(pos[a], vrow[og + a], f[a], S[a], &i0[a], &i1[a], &w[a], &dclip[a]);
      // the lower-z corners are the held upper-z ones: their v is at hand
      const bool same = held_z >= 0 && i0[0] == held_z && i0[1] == held_y && i0[2] == held_x;

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
        // data term: the gather's transpose
        const float wc = (w0 * w1) * w2;
#pragma unroll
        for (int a = 0; a < 3; ++a) val[corner][a] = wc * gv[a];
      }
      // identity and coordinate terms, into this voxel's cell
      const float own[3] = {gv[0] + gw[0] * (dclip[0] * f[0]),
                            gv[1] + gw[1] * (dclip[1] * f[1]),
                            gv[2] + gw[2] * (dclip[2] * f[2])};
      send(z + p.z0, y, x, own);
    }
    // the upper-z corners held from plane z - 1: merged into this plane's
    // lower-z corners where the cells are the same, else sent
    if (held_z >= 0) {
      if (have && i0[0] == held_z && i0[1] == held_y && i0[2] == held_x) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int a = 0; a < 3; ++a) val[2 * k][a] += held[k][a];
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          send(held_z, k & 1 ? upper(held_y, 1) : held_y, k & 2 ? upper(held_x, 2) : held_x,
               held[k]);
      }
      held_z = -1;
    }
    // the next lane's lower-x corners join this lane's upper-x ones where
    // they are the same cells (the next voxel of the line)
    const int key = have ? i0[0] * S1 + i0[1] : -1;
    const int key_r = __shfl_down_sync(mask, key, 1);
    const int x0_r = __shfl_down_sync(mask, i0[2], 1);
    const bool take = have && lane + 1 < lanes && threadIdx.x + 1 < p.tx && key_r == key &&
                      x0_r == i1[2];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float r = __shfl_down_sync(mask, val[k][a], 1);
        if (take) val[4 + k][a] += r;
      }
    if (__shfl_up_sync(mask, (int)take, 1) && lane > 0)
#pragma unroll
      for (int k = 0; k < 4; ++k) val[k][0] = val[k][1] = val[k][2] = 0.0f;
    if (have) {
      // send the lower-z corners, hold the upper-z ones
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        send(i0[0], k & 1 ? i1[1] : i0[1], k & 2 ? i1[2] : i0[2], val[2 * k]);
#pragma unroll
        for (int a = 0; a < 3; ++a) held[k][a] = val[2 * k + 1][a];
      }
      held_z = i1[0];
      held_y = i0[1];
      held_x = i0[2];
    }
  }
}

// Whether plan p walks B rows of S0 x S1 x S2 voxels: blocks of tx x ty
// threads (at most gather::THREADS), tiles covering each plane, chunks of
// tz planes covering z, within the launch limits, the slab inside the
// whole field, and offsets of a whole row's 3 n floats in 32 bits.
bool valid(const gather::Plan& p, int B, int S0, int S1, int S2) {
  if (!gather::valid_slab(p, S0)) return false;
  if (p.v != 1 || p.ch != 0 || p.tx < 1 || p.ty < 1 || p.tz < 1 || p.log_strips < 0 ||
      p.log_strips > 20 || p.tiles_y < 1 || p.tiles_z < 1 || p.groups != 1 || p.rows != 1)
    return false;
  const long long strips = 1LL << p.log_strips;
  return (long long)p.tx * p.ty <= gather::THREADS && p.tx * strips >= S2 &&
         (long long)p.ty * p.tiles_y >= S1 && (long long)p.tz * p.tiles_z >= S0 &&
         p.tiles_y * strips < (1LL << 31) && p.tiles_z <= 65535 && B <= 65535 &&
         (long long)p.zg * S1 * S2 * 3 < (1LL << 31);
}

}  // namespace

// vbar (B, S0, S1, S2, 3) = g + dfgrad(v, v, g) + mgrad(v, v, g); plan:
// 12 ints, gather::Plan with tz the planes a block marches
// (kernels/gather.py:squaring_bwd_plan). With a slab (plan z0, zg; the
// depth-sharded model's step): v and vbar are whole fields of depth zg, g
// the cotangent of the forward slab's S0 planes from z0 (f0 = zg / (zg -
// 1)); vbar is then the slab's share of the whole cotangent, which the
// caller sums over the slabs. `out` must not alias v or g.
// Returns the first CUDA error, or 0 (cudaErrorInvalidValue for a plan
// the kernel cannot walk).
extern "C" int pulpo_squaring_step_bwd(const void* vin, const void* g, void* out,
                                       int B, int S0, int S1, int S2,
                                       float f0, float f1, float f2, const int* plan,
                                       void* stream) {
  if ((long long)B * S0 * S1 * S2 == 0) return 0;
  const gather::Plan p = gather::read_plan(plan);
  if (!valid(p, B, S0, S1, S2)) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * p.zg * S1 * S2;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)total * 3 * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)p.tiles_y << p.log_strips, p.tiles_z, B);
  squaring_bwd_kernel<<<grid, dim3(p.tx, p.ty), 0, s>>>(
      (const float*)vin, (const float*)g, (float*)out, S0, S1, S2, f0, f1, f2, p);
  return (int)cudaGetLastError();
}
