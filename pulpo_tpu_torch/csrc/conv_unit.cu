// One eval ConvUnit for Hopper (sm_90a): a 3^3 SAME conv as an implicit
// GEMM with its whole epilogue fused,
//   UNIT:       round(acc) + bias -> eval BN (f32) -> LeakyReLU(0.2)
//   UNIT_ADD:   (round(acc) + y2[r % B]) + bias -> eval BN -> LeakyReLU
//   UNIT_HEADS: the UNIT epilogue, then the 1x1 mu and sigma heads
//               (zd channels each) with softplus on sigma.
//
// Replaces two TPU kernels, each as a chain of launches of this one:
//   pulpo_tpu/kernels/pos_head.py:272 posterior_head_fused (4 launches:
//     up1 UNIT, up2 UNIT, merge1 UNIT_ADD, merge2 UNIT_HEADS), and
//   pulpo_tpu/attic/conv_chain.py:202 conv_chain_fused (depth launches of
//     UNIT).
//
// Why one launch per ConvUnit, when the TPU kernels keep every
// intermediate on chip: they hold z-ring buffers of whole (S1, 128)-lane
// planes in VMEM (pos_head.py:17-39). One 96-channel plane of the
// flagship's latent level 0 is ~2.4 MB, and a Hopper block has at most
// 227 KB of shared memory; recomputing a 4-deep chain's halo inside a
// small brick would multiply the first conv's work by up to 8x. So the
// intermediates cross device memory here, in the compute type (never
// f32). At level 0 of a 32-sample request that is ~29.5 GB of seams,
// ~8.8 ms at 3.35 TB/s, under the chain's ~31.6 ms operations bound at
// 989 TFLOP/s bf16: the kernel is bound by operations. What the fusion
// removes is the glue: the bias add, the f32 BatchNorm and its casts,
// the LeakyReLU's passes, the tiling of y2 over the samples, the 1x1
// heads and the softplus are all done in the epilogue.
//
// bf16 design (wgmma, a TMA-fed ring, spatial bricks):
//   - A tile is a spatial brick of TZ x 8 x 8 output voxels of one row
//     (TZ = 2 MT: 8, 4 or 2 planes for cout padded to <= 64, <= 128,
//     192) x all NP output channels. A persistent grid (one block of 384
//     threads per SM) walks the tiles of the host's plan
//     (kernels/conv_unit.py:tile_plan), which the launch checks against
//     the template's brick (tc::BrickPlan).
//   - K is walked as (16-channel chunk c, tap plane dz); each step is one
//     stage of a shared-memory ring (4 or 3 stages, 2 at NP = 192):
//       A: input planes z0 + dz - 1 .. + TZ - 1, 10 x 10 positions each
//          (the tile's y-x footprint with its 1-voxel halo), as two
//          planes of 8 channels x positions (16 B a position), by two
//          5D TMA tiled loads; TMA fills everything outside the volume
//          with zeros, which is the SAME padding and the ragged edges;
//       B: the 9 taps of plane dz for chunk c, NP x 16 each, packed on
//          the host as 8-channel core matrices (conv_unit.py:pack_tc),
//          by one bulk copy.
//     One thread of a producer warpgroup (its registers cut to 40 by
//     setmaxnreg) keeps the ring full (mbarriers with transaction
//     counts); two consumer warpgroups (232 registers each) multiply.
//     Every tap of a stage is read from the same A planes: a tap's 8
//     consecutive x positions are one 16 B-aligned core matrix, so a
//     wgmma descriptor addresses the shifted rows in place (LBO = the
//     8-channel plane stride, SBO = the 10-position line stride). Each
//     input voxel is fetched ~1.6 x 3 times per chunk instead of 27, and
//     each weight chunk once per 64 TZ voxels instead of once per 64.
//   - Warpgroup w owns planes w MT .. w MT + MT - 1: MT accumulators of
//     wgmma.m64nNPk16 (bf16 x bf16 -> f32), 9 MT products per stage;
//     with a 4-stage ring, one stage's products stay in flight while the
//     next stage is issued.
//   - An input of fewer than 16 (or of a ragged number of) channels is
//     zero-padded to a multiple of 16 by the wrapper, so the narrow
//     input (#13's 2 channels, the full_res head's 15) shares this loop.
//   - Epilogue: a tile's sums, rounded to bf16 (the first rounding point),
//     go to the warpgroup's staging tile in shared memory; their fused
//     epilogue runs under the NEXT tile's products, one plane at a time
//     spread over its stages, each thread on a fixed 8-channel run (its
//     parameters loaded once a plane) and writing whole 16-byte runs of
//     a voxel's channels (cout % 8 == 0), or, for UNIT_HEADS, the 1x1
//     heads over the staged activations.
//
// f32 design (CUDA cores, unchanged): a block computes BM = 64
// consecutive output voxels (flattened over rows and space) x all cout
// channels (padded to NP). K = 27 * cin, ordered (tap, channel) as the
// wrapper packs the weights: w[n][tap * cin + c], NP x Kp, Kp a multiple
// of 32. Each K chunk of the A tile (BM voxels x KC) is gathered from the
// channels-last input, zeros outside the volume, 16 bytes at a time
// where cin allows it; the weight chunk is copied beside it, both
// through registers. Each thread owns 4 voxels x NP/8 channels of FMAs
// (TF32 would miss a 1e-4 of scale tolerance).
//
// Rounding points (pos_head.py:44-50, conv_chain.py:36-39,
// kernels/activations.py): the f32 sum is rounded to T before anything
// is added; y2 then the bias are added in T; BN computes
// (f32(x) - mean) * (rsqrt(var + eps) * scale) + bias in f32 (no FMA
// contraction) and rounds to T; LeakyReLU takes its sign from the f32
// value and multiplies by 0.2 rounded to T. Each head output is summed
// in f32 over the rounded activations, rounded to T, and gets its bias
// in T; softplus = max(x, 0) + log1p(exp(-|x|)) with each
// transcendental computed in f32 and rounded to T. T is the compute
// type: bf16, or f32, where every rounding is the identity.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc.cuh"

namespace {

constexpr int MAXZD = 4;
enum Mode { UNIT = 0, UNIT_ADD = 1, UNIT_HEADS = 2 };

// ---- f32: the CUDA-core kernel --------------------------------------

constexpr int BM = 64;          // output voxels per block
constexpr int NTHREADS = 128;   // 4 warps
constexpr int KC = 16;          // K chunk
constexpr int VEC = 4;          // floats per 16 B
constexpr int P = KC + VEC;     // smem row, padded

struct Args {
  const float* x;      // (rows, S0, S1, S2, cin), channels-last
  const float* w;      // (NP, kp)
  const float* bias;   // (NP)
  const float* bn;     // (3, NP): mean, mul, add
  const float* y2;     // UNIT_ADD: (b_pair, S0, S1, S2, cout)
  const float* wh;     // UNIT_HEADS: (2 zd, NP)
  const float* bh;     // UNIT_HEADS: (2 zd)
  float* out;          // (rows, S0, S1, S2, cout), or mu (.., zd)
  float* out2;         // UNIT_HEADS: sigma (.., zd)
  int S0, S1, S2, V, cin, cout, kp, b_pair, mode, zd, vec_ok;
  int rv;              // rows * V
};

// The voxel that output row m of this block stands for.
struct Vox {
  int valid, r, z, y, x;
};

__device__ __forceinline__ Vox voxel(const Args& a, int v) {
  Vox o;
  o.valid = v < a.rv;
  if (!o.valid) v = 0;
  o.r = v / a.V;
  const int s = v - o.r * a.V;
  const int plane = a.S1 * a.S2;
  o.z = s / plane;
  const int rem = s - o.z * plane;
  o.y = rem / a.S2;
  o.x = rem - o.y * a.S2;
  return o;
}

// 16 bytes of the A tile: elements k .. k + VEC - 1 of voxel `p`'s row.
__device__ __forceinline__ uint4 gather(const Args& a, const Vox& p, int k) {
  const int K = 27 * a.cin;
  union { uint4 u; float e[VEC]; } out;
  out.u = make_uint4(0u, 0u, 0u, 0u);
  if (!p.valid) return out.u;
  if (a.vec_ok) {  // cin % VEC == 0: the 16 bytes are one tap's channels
    if (k >= K) return out.u;
    const int tap = k / a.cin, c = k - tap * a.cin;
    const int zz = p.z + tap / 9 - 1, yy = p.y + (tap / 3) % 3 - 1, xx = p.x + tap % 3 - 1;
    if (zz < 0 || zz >= a.S0 || yy < 0 || yy >= a.S1 || xx < 0 || xx >= a.S2) return out.u;
    const long long off =
        (((long long)p.r * a.S0 + zz) * a.S1 + yy) * (long long)a.S2 + xx;
    return *reinterpret_cast<const uint4*>(a.x + off * a.cin + c);
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int ke = k + e;
    if (ke >= K) break;
    const int tap = ke / a.cin, c = ke - tap * a.cin;
    const int zz = p.z + tap / 9 - 1, yy = p.y + (tap / 3) % 3 - 1, xx = p.x + tap % 3 - 1;
    if (zz < 0 || zz >= a.S0 || yy < 0 || yy >= a.S1 || xx < 0 || xx >= a.S2) continue;
    const long long off =
        (((long long)p.r * a.S0 + zz) * a.S1 + yy) * (long long)a.S2 + xx;
    out.e[e] = a.x[off * a.cin + c];
  }
  return out.u;
}

// The products of one K chunk: thread (tm, tn) = (tid / 8, tid % 8) owns
// voxels tm + 16 i (i < 4) and channels tn + 8 j; accumulator i * NP/8 + j.
template <int NP> struct Mma {
  static constexpr int NACC = 4 * (NP / 8);
  static __device__ __forceinline__ void compute(const float* As, const float* Bs, float* acc) {
    const int tm = threadIdx.x >> 3, tn = threadIdx.x & 7;
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[(tm + 16 * i) * P + k];
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const float b = Bs[(tn + 8 * j) * P + k];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i * (NP / 8) + j] = fmaf(av[i], b, acc[i * (NP / 8) + j]);
      }
    }
  }
  static __device__ __forceinline__ void coord(int idx, int& m, int& n) {
    m = (threadIdx.x >> 3) + 16 * (idx / (NP / 8));
    n = (threadIdx.x & 7) + 8 * (idx % (NP / 8));
  }
};

template <int NP>
constexpr size_t tile_bytes() {
  return (size_t)(BM + NP) * P * sizeof(float);
}
template <int NP>
constexpr size_t heads_bytes() {
  return ((size_t)BM * (NP + 1) + 2 * MAXZD * NP) * sizeof(float);
}

template <int NP>
__global__ void __launch_bounds__(NTHREADS)
conv_unit_kernel(const Args a) {
  constexpr int QPR = KC / VEC;                                // 16 B units per tile row
  constexpr int AU = BM * QPR / NTHREADS;                      // A units per thread (2)
  constexpr int BU = (NP * QPR + NTHREADS - 1) / NTHREADS;     // B units per thread
  using M = Mma<NP>;

  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + BM * P;

  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * BM;

  Vox rows[AU];
#pragma unroll
  for (int i = 0; i < AU; ++i) rows[i] = voxel(a, v0 + tid / QPR + i * (NTHREADS / QPR));
  const int q = tid % QPR;

  uint4 ra[AU], rb[BU];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < AU; ++i) ra[i] = gather(a, rows[i], k0 + q * VEC);
#pragma unroll
    for (int i = 0; i < BU; ++i) {
      const int u = tid + i * NTHREADS;
      if (u < NP * QPR)
        rb[i] = *reinterpret_cast<const uint4*>(a.w + (size_t)(u / QPR) * a.kp + k0 + (u % QPR) * VEC);
    }
  };

  float acc[M::NACC];
#pragma unroll
  for (int i = 0; i < M::NACC; ++i) acc[i] = 0.0f;

  const int nk = a.kp / KC;
  load(0);
  for (int kc = 0; kc < nk; ++kc) {
#pragma unroll
    for (int i = 0; i < AU; ++i)
      *reinterpret_cast<uint4*>(As + (tid / QPR + i * (NTHREADS / QPR)) * P + q * VEC) = ra[i];
#pragma unroll
    for (int i = 0; i < BU; ++i) {
      const int u = tid + i * NTHREADS;
      if (u < NP * QPR)
        *reinterpret_cast<uint4*>(Bs + (u / QPR) * P + (u % QPR) * VEC) = rb[i];
    }
    __syncthreads();
    if (kc + 1 < nk) load((kc + 1) * KC);
    M::compute(As, Bs, acc);
    __syncthreads();
  }

  // ---- epilogue (float32 is the compute type: no rounding points) ----
  const float c02 = 0.2f;
  float* hs = reinterpret_cast<float*>(smem);  // UNIT_HEADS: [BM][NP + 1]
#pragma unroll
  for (int idx = 0; idx < M::NACC; ++idx) {
    int m, n;
    M::coord(idx, m, n);
    const int v = v0 + m;
    if (n >= a.cout || v >= a.rv) continue;
    float s = acc[idx];
    if (a.mode == UNIT_ADD) {
      const int r = v / a.V;
      const long long src = ((long long)(r % a.b_pair) * a.V + (v - r * a.V)) * a.cout + n;
      s = s + a.y2[src];
    }
    s = s + a.bias[n];
    const float y = __fadd_rn(__fmul_rn(__fsub_rn(s, a.bn[n]), a.bn[NP + n]), a.bn[2 * NP + n]);
    const float act = (y < 0.0f) ? __fmul_rn(c02, y) : y;
    if (a.mode == UNIT_HEADS)
      hs[m * (NP + 1) + n] = act;
    else
      a.out[(long long)v * a.cout + n] = act;
  }
  if (a.mode != UNIT_HEADS) return;

  // 1x1 heads over each voxel's activations, staged in shared memory
  float* ws = hs + BM * (NP + 1);
  const int nh = 2 * a.zd;
  for (int i = tid; i < nh * NP; i += NTHREADS) ws[i] = a.wh[i];
  __syncthreads();
  for (int task = tid; task < BM * nh; task += NTHREADS) {
    const int m = task / nh, j = task - m * nh;
    const int v = v0 + m;
    if (v >= a.rv) continue;
    const float* hr = hs + m * (NP + 1);
    const float* wr = ws + j * NP;
    float h = 0.0f;
    for (int n = 0; n < a.cout; ++n) h = fmaf(hr[n], wr[n], h);
    h = h + a.bh[j];
    if (j < a.zd)
      a.out[(long long)v * a.zd + j] = h;
    else  // softplus = max(h, 0) + log1p(exp(-|h|))
      a.out2[(long long)v * a.zd + (j - a.zd)] = (h >= 0.0f ? h : 0.0f) + log1pf(expf(-fabsf(h)));
  }
}

template <int NP>
int launch(const Args& a, cudaStream_t stream) {
  const size_t most = tile_bytes<NP>() > heads_bytes<NP>() ? tile_bytes<NP>() : heads_bytes<NP>();
  const size_t smem = a.mode == UNIT_HEADS ? most : tile_bytes<NP>();
  cudaError_t e = cudaFuncSetAttribute(conv_unit_kernel<NP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((a.rv + BM - 1) / BM);
  conv_unit_kernel<NP><<<blocks, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- bf16: the wgmma kernel -----------------------------------------

using tc::bf16;

template <int NP> struct Geo {
  static constexpr int MT = NP <= 64 ? 4 : (NP <= 128 ? 2 : 1);  // m64 tiles a warpgroup
  static constexpr int TZ = 2 * MT, TY = 8, TX = 8;               // output brick
  static constexpr int HY = TY + 2, HX = TX + 2;                  // its y-x halo
  static constexpr int PLANE = TZ * HY * HX;                      // positions of a stage
  static constexpr int A_BYTES = 2 * PLANE * 16;                  // two 8-channel planes
  static constexpr int B_BYTES = 9 * 2 * NP * 16;                 // 9 taps x 16 ch x NP
  static constexpr int STAGE = A_BYTES + B_BYTES;                 // a multiple of 128
  static constexpr int STAGES = NP >= 192 ? 2 : (NP >= 64 && NP != 96 ? 3 : 4);
  static constexpr int LAG = STAGES >= 4 ? 1 : 0;  // stages of products left in flight
  static constexpr int EPI_PITCH = NP + 8;                        // staging row, bf16
  static constexpr int EPI = MT * 64 * EPI_PITCH;                 // a warpgroup's staging
  static constexpr size_t SMEM = 128 + (size_t)STAGES * STAGE + 2 * EPI * 2 +
                                 2 * MAXZD * NP * 4 + NP * 16 + 2 * STAGES * 8;
  static_assert(SMEM <= 232448, "shared memory of one block");
};
constexpr int TC_THREADS = 384;  // two consumer warpgroups + one producer warpgroup

struct TcArgs {
  const bf16* w;       // packed (cin / 16, 3, 9, 2, NP, 8)
  const float* bias;   // (NP) values rounded to bf16
  const float* bn;     // (3, NP): mean, mul, add
  const bf16* y2;      // UNIT_ADD: (b_pair, S0, S1, S2, cout)
  const float* wh;     // UNIT_HEADS: (2 zd, NP) values rounded to bf16
  const float* bh;     // UNIT_HEADS: (2 zd) values rounded to bf16
  bf16* out;           // (rows, S0, S1, S2, cout), or mu (.., zd)
  bf16* out2;          // UNIT_HEADS: sigma (.., zd)
  int S0, S1, S2, cin, cout, b_pair, mode, zd;
  int tn_z, tn_y, tn_x, tiles;  // the plan's tiles per axis of a row, tiles in all
};

struct Tile {
  int r, z0, y0, x0;
};
// tile t of the plan, in the order of kernels/_build.py:tile_origin
__device__ __forceinline__ Tile tile_of(const TcArgs& a, int t, int tz) {
  const int per_row = a.tn_z * a.tn_y * a.tn_x;
  Tile o;
  o.r = t / per_row;
  const int rem = t - o.r * per_row;
  const int iz = rem / (a.tn_y * a.tn_x);
  const int iy = (rem / a.tn_x) % a.tn_y;
  const int ix = rem % a.tn_x;
  o.z0 = iz * tz;
  o.y0 = iy * 8;
  o.x0 = ix * 8;
  return o;
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// softplus = max(h, 0) + log1p(exp(-|h|)), each transcendental rounded
// to bf16
__device__ __forceinline__ float softplus_bf16(float h) {
  const float e = tc::rnd_bf16(expf(-fabsf(h)));
  return tc::rnd_bf16((h >= 0.0f ? h : 0.0f) + tc::rnd_bf16(log1pf(e)));
}

// The epilogue of one 64-voxel plane at z of tile `tl`, whose rounded
// conv sums (bf16) are in `st` (64 rows x EPI_PITCH), by one warpgroup
// (wt its thread). Thread wt < THR takes the 8-channel run q = wt % RUNS
// of rows wt / RUNS, + RSTEP, ..., and holds that run's parameters in
// registers where the accumulators leave room (at most 96 of them), else
// reads them for each row: the fused epilogue, then one 16-byte store
// (or, for UNIT_HEADS, the activations back into `st` for the 1x1 heads).
template <int NP>
__device__ __forceinline__ void epilogue_plane(const TcArgs& a, const Tile& tl, int z, bf16* st,
                                               const float4* s_ep, const float* ws, int wt,
                                               int bar, long long V, float c02) {
  using G = Geo<NP>;
  constexpr int RUNS = NP / 8, RSTEP = 128 / RUNS, THR = RUNS * RSTEP;
  constexpr bool EP_REGS = G::MT * NP / 2 <= 96;
  const int q = wt % RUNS, n0 = 8 * q, nv = min(8, a.cout - n0);
  const long long vrow = ((long long)tl.r * a.S0 + z) * a.S1;
  const uint16_t* y2b = reinterpret_cast<const uint16_t*>(a.y2) +
                        (long long)(tl.r % a.b_pair) * V * a.cout;
  if (wt < THR && nv > 0 && z < a.S0) {
    float4 ep[8];  // bias, mean, mul, add of channels n0 .. n0 + 7
    if (EP_REGS)
#pragma unroll
      for (int e = 0; e < 8; ++e) ep[e] = s_ep[n0 + e];
    for (int m = wt / RUNS; m < 64; m += RSTEP) {
      if (!EP_REGS)
#pragma unroll
        for (int e = 0; e < 8; ++e) ep[e] = tc::lds128(s_ep + n0 + e);
      const int y = tl.y0 + (m >> 3), x = tl.x0 + (m & 7);
      if (y >= a.S1 || x >= a.S2) continue;
      const long long v = (vrow + y) * a.S2 + x;
      uint32_t yv[4] = {0u, 0u, 0u, 0u};
      if (a.mode == UNIT_ADD) {
        const uint16_t* src = y2b + (v - (long long)tl.r * V) * a.cout + n0;
        if (nv == 8 && (a.cout & 7) == 0) {
          const uint4 u = *reinterpret_cast<const uint4*>(src);
          yv[0] = u.x; yv[1] = u.y; yv[2] = u.z; yv[3] = u.w;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (e < nv) yv[e >> 1] |= (uint32_t)src[e] << (16 * (e & 1));
        }
      }
      const uint4 sv = *reinterpret_cast<const uint4*>(st + m * G::EPI_PITCH + n0);
      const uint32_t sw[4] = {sv.x, sv.y, sv.z, sv.w};
      float act[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float s = __uint_as_float((e & 1 ? sw[e >> 1] >> 16 : sw[e >> 1] & 0xFFFFu) << 16);
        if (a.mode == UNIT_ADD)
          s = tc::rnd_bf16(s + __uint_as_float((e & 1 ? yv[e >> 1] >> 16 : yv[e >> 1] & 0xFFFFu)
                                               << 16));
        s = tc::rnd_bf16(s + ep[e].x);
        const float yf = __fadd_rn(__fmul_rn(__fsub_rn(s, ep[e].y), ep[e].z), ep[e].w);
        const float o = tc::rnd_bf16(yf);
        act[e] = (yf < 0.0f) ? tc::rnd_bf16(__fmul_rn(c02, o)) : o;
      }
      const uint4 ov = make_uint4(tc::pack_bf16x2(act[0], act[1]),
                                  tc::pack_bf16x2(act[2], act[3]),
                                  tc::pack_bf16x2(act[4], act[5]),
                                  tc::pack_bf16x2(act[6], act[7]));
      if (a.mode == UNIT_HEADS)
        *reinterpret_cast<uint4*>(st + m * G::EPI_PITCH + n0) = ov;
      else if (nv == 8 && (a.cout & 7) == 0)
        *reinterpret_cast<uint4*>(a.out + v * a.cout + n0) = ov;
      else
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (e < nv) a.out[v * a.cout + n0 + e] = __float2bfloat16_rn(act[e]);
    }
  }
  if (a.mode != UNIT_HEADS) return;
  bar_sync(bar, 128);  // the plane's activations are staged
  const int nh = 2 * a.zd;
  for (int task = wt; task < 64 * nh; task += 128) {
    const int m = task / nh, jh = task - m * nh;
    const int y = tl.y0 + (m >> 3), x = tl.x0 + (m & 7);
    if (z >= a.S0 || y >= a.S1 || x >= a.S2) continue;
    const bf16* hr = st + m * G::EPI_PITCH;
    const float* wr = ws + jh * NP;
    float hv = 0.0f;
    if ((a.cout & 7) == 0) {  // 8 channels a step, in order
      for (int n = 0; n < a.cout; n += 8) {
        const uint4 hb = *reinterpret_cast<const uint4*>(hr + n);
        const float4 w0 = *reinterpret_cast<const float4*>(wr + n);
        const float4 w1 = *reinterpret_cast<const float4*>(wr + n + 4);
        const uint32_t hw[4] = {hb.x, hb.y, hb.z, hb.w};
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          hv = fmaf(__uint_as_float((e & 1 ? hw[e >> 1] >> 16 : hw[e >> 1] & 0xFFFFu) << 16),
                    wv[e], hv);
      }
    } else {
      for (int n = 0; n < a.cout; ++n) hv = fmaf(__bfloat162float(hr[n]), wr[n], hv);
    }
    hv = tc::rnd_bf16(tc::rnd_bf16(hv) + a.bh[jh]);
    const long long v = (vrow + y) * a.S2 + x;
    if (jh < a.zd)
      a.out[v * a.zd + jh] = __float2bfloat16_rn(hv);
    else
      a.out2[v * a.zd + (jh - a.zd)] = __float2bfloat16_rn(softplus_bf16(hv));
  }
}

template <int NP>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv_unit_tc(const __grid_constant__ CUtensorMap xmap, const TcArgs a) {
  using G = Geo<NP>;
  constexpr int NACC = NP / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  bf16* epi = reinterpret_cast<bf16*>(smem + (size_t)G::STAGES * G::STAGE);
  float* ws = reinterpret_cast<float*>(epi + 2 * G::EPI);
  float4* s_ep = reinterpret_cast<float4*>(ws + 2 * MAXZD * NP);  // bias, mean, mul, add
  uint64_t* full = reinterpret_cast<uint64_t*>(s_ep + NP);
  uint64_t* empty = full + G::STAGES;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      tc::mbar_init(full + s, 1);
      tc::mbar_init(empty + s, 256);
    }
    tc::mbar_fence_init();
  }
  if (a.mode == UNIT_HEADS)
    for (int i = tid; i < 2 * a.zd * NP; i += TC_THREADS) ws[i] = a.wh[i];
  for (int i = tid; i < NP; i += TC_THREADS)
    s_ep[i] = make_float4(a.bias[i], a.bn[i], a.bn[NP + i], a.bn[2 * NP + i]);
  __syncthreads();
  const int nchunk = a.cin / 16;

  if (tid >= 256) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 256) return;
    int it = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      const Tile tl = tile_of(a, t, G::TZ);
      for (int c = 0; c < nchunk; ++c)
        for (int dz = 0; dz < 3; ++dz, ++it) {
          const int s = it % G::STAGES;
          tc::mbar_wait(empty + s, ((it / G::STAGES) & 1) ^ 1);
          unsigned char* st = smem + (size_t)s * G::STAGE;
          tc::mbar_expect_tx(full + s, G::STAGE);
          for (int cg = 0; cg < 2; ++cg)
            tc::tma_load_5d(st + cg * G::PLANE * 16, &xmap, full + s, c * 16 + cg * 8,
                            tl.x0 - 1, tl.y0 - 1, tl.z0 + dz - 1, tl.r);
          tc::bulk_load(st + G::A_BYTES, a.w + (size_t)(c * 3 + dz) * (G::B_BYTES / 2),
                        G::B_BYTES, full + s);
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // The consumer warpgroups. Warpgroup wg owns planes wg MT .. + MT - 1
    // of each tile. A tile's rounded sums go to the warpgroup's staging
    // tile; their epilogue runs one plane per stage under the next tile's
    // products, so the tensor cores do not wait for it.
    const int wg = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const float c02 = tc::rnd_bf16(0.2f);
    bf16* stage_out = epi + wg * G::EPI;
    const long long V = (long long)a.S0 * a.S1 * a.S2;
    const int nst = nchunk * 3;
    float acc[G::MT][NACC];
    Tile prev;
    bool have_prev = false;
    int it = 0, prev_s = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      const Tile tl = tile_of(a, t, G::TZ);
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc[mt][i] = 0.0f;

      for (int k = 0; k < nst; ++k, ++it) {
        const int s = it % G::STAGES;
        tc::mbar_wait(full + s, (it / G::STAGES) & 1);
        const unsigned char* st = smem + (size_t)s * G::STAGE;
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt) tc::fence_regs(acc[mt]);
        tc::wgmma_fence();
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt) {
          const int zo = wg * G::MT + mt;
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const int dy = tap / 3, dx = tap % 3;
            const uint64_t da = tc::wgmma_desc(st + ((zo * G::HY + dy) * G::HX + dx) * 16,
                                               G::PLANE * 16, G::HX * 16);
            const uint64_t db = tc::wgmma_desc(st + G::A_BYTES + tap * 2 * NP * 16, NP * 16, 128);
            tc::Wgmma<NP>::mma(acc[mt], da, db);
          }
        }
        tc::wgmma_commit();
        // the previous tile's planes, spread over this tile's stages
        if (have_prev)
          for (int pl = 0; pl < G::MT; ++pl)
            if (pl * nst / G::MT == k)
              epilogue_plane<NP>(a, prev, prev.z0 + wg * G::MT + pl,
                                 stage_out + pl * 64 * G::EPI_PITCH, s_ep, ws, wt, 1 + wg, V,
                                 c02);
        // with 4 stages, the previous stage's products are done (this
        // stage's stay in flight); with fewer, this stage's, so that the
        // producer keeps a stage of lookahead
        tc::wgmma_wait<G::LAG>();
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt) tc::fence_regs(acc[mt]);
        if (G::LAG == 0)
          tc::mbar_arrive(empty + s);
        else if (k > 0)
          tc::mbar_arrive(empty + prev_s);
        prev_s = s;
      }
      if (G::LAG) {
        tc::wgmma_wait<0>();
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt) tc::fence_regs(acc[mt]);
        tc::mbar_arrive(empty + prev_s);
      }
      bar_sync(1 + wg, 128);  // the staging tile's last readers are done
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
        for (int j = 0; j < NP / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = mt * 64 + 16 * warp + g + 8 * h;
            *reinterpret_cast<uint32_t*>(stage_out + m * G::EPI_PITCH + 8 * j + 2 * tq) =
                tc::pack_bf16x2(acc[mt][4 * j + 2 * h], acc[mt][4 * j + 2 * h + 1]);
          }
      bar_sync(1 + wg, 128);
      prev = tl;
      have_prev = true;
    }
    if (have_prev)
      for (int k = 0; k < G::MT; ++k)
        epilogue_plane<NP>(a, prev, prev.z0 + wg * G::MT + k, stage_out + k * 64 * G::EPI_PITCH,
                           s_ep, ws, wt, 1 + wg, V, c02);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int NP>
int launch_tc(const void* x, int rows, TcArgs a, const tc::BrickPlan& plan, cudaStream_t stream) {
  using G = Geo<NP>;
  if (!plan.ok(G::TZ, G::TY, G::TX, rows, a.S0, a.S1, a.S2)) return (int)cudaErrorInvalidValue;
  a.tn_z = plan.tn_z; a.tn_y = plan.tn_y; a.tn_x = plan.tn_x; a.tiles = plan.tiles;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t c2 = 2;
  const cuuint64_t dims[5] = {(cuuint64_t)a.cin, (cuuint64_t)a.S2, (cuuint64_t)a.S1,
                              (cuuint64_t)a.S0, (cuuint64_t)rows};
  const cuuint64_t strides[4] = {a.cin * c2, a.cin * c2 * a.S2, a.cin * c2 * a.S2 * a.S1,
                                 a.cin * c2 * a.S2 * a.S1 * a.S0};
  const cuuint32_t box[5] = {8, G::HX, G::HY, (cuuint32_t)G::TZ, 1};
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  CUresult r = enc(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), dims,
                   strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(conv_unit_tc<NP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)G::SMEM);
  if (e != cudaSuccess) return (int)e;
  conv_unit_tc<NP><<<plan.grid, TC_THREADS, G::SMEM, stream>>>(map, a);
  return (int)cudaGetLastError();
}

int dispatch_tc(int np, const void* x, int rows, const TcArgs& a, const tc::BrickPlan& plan,
                cudaStream_t s) {
  switch (np) {
    case 16: return launch_tc<16>(x, rows, a, plan, s);
    case 32: return launch_tc<32>(x, rows, a, plan, s);
    case 64: return launch_tc<64>(x, rows, a, plan, s);
    case 96: return launch_tc<96>(x, rows, a, plan, s);
    case 128: return launch_tc<128>(x, rows, a, plan, s);
    case 192: return launch_tc<192>(x, rows, a, plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_f32(int np, const Args& a, cudaStream_t s) {
  switch (np) {
    case 16: return launch<16>(a, s);
    case 32: return launch<32>(a, s);
    case 64: return launch<64>(a, s);
    case 96: return launch<96>(a, s);
    case 128: return launch<128>(a, s);
    case 192: return launch<192>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16 (plan != NULL): cin a multiple of 16 (the wrapper pads), w packed
// by kernels/conv_unit.py:pack_tc, kp ignored; plan (tc::BrickPlan, 6
// ints) from kernels/conv_unit.py:tile_plan. f32 (plan == NULL): w (np,
// kp) as before.
extern "C" int pulpo_conv_unit(const void* x, const void* w, const void* bias, const void* bn,
                               const void* y2, const void* wh, const void* bh, void* out,
                               void* out2, int rows, int S0, int S1, int S2, int cin, int cout,
                               int np, int kp, int b_pair, int mode, int zd, const int* plan,
                               void* stream) {
  const long long V = (long long)S0 * S1 * S2;
  if (rows < 1 || S0 < 1 || S1 < 1 || S2 < 1 || cin < 1 || cout < 1 || cout > np ||
      (long long)rows * V >= (1LL << 31) || mode < UNIT || mode > UNIT_HEADS ||
      (mode == UNIT_ADD && (b_pair < 1 || rows % b_pair != 0)) ||
      (mode == UNIT_HEADS && (zd < 1 || zd > MAXZD)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (plan != nullptr) {
    if (cin % 16 != 0 || cin > 192) return (int)cudaErrorInvalidValue;
    TcArgs a;
    a.w = (const bf16*)w; a.bias = (const float*)bias; a.bn = (const float*)bn;
    a.y2 = (const bf16*)y2; a.wh = (const float*)wh; a.bh = (const float*)bh;
    a.out = (bf16*)out; a.out2 = (bf16*)out2;
    a.S0 = S0; a.S1 = S1; a.S2 = S2; a.cin = cin; a.cout = cout;
    a.b_pair = b_pair < 1 ? 1 : b_pair; a.mode = mode; a.zd = zd;
    const tc::BrickPlan p = {plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
    return dispatch_tc(np, x, rows, a, p, s);
  }
  if (kp % 32 != 0 || kp < 27 * cin) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const float*)x; a.w = (const float*)w; a.bias = (const float*)bias;
  a.bn = (const float*)bn; a.y2 = (const float*)y2; a.wh = (const float*)wh;
  a.bh = (const float*)bh; a.out = (float*)out; a.out2 = (float*)out2;
  a.S0 = S0; a.S1 = S1; a.S2 = S2; a.V = (int)V; a.cin = cin; a.cout = cout; a.kp = kp;
  a.b_pair = b_pair < 1 ? 1 : b_pair; a.mode = mode; a.zd = zd;
  a.vec_ok = cin % 4 == 0;
  a.rv = (int)(rows * V);
  return dispatch_f32(np, a, s);
}
