// Narrow-input SAME 3x3x3 conv (stride 1, no bias) for Hopper (sm_90a):
//   out[b, p, co] = round_to_T( sum_{tap, ci} x[b, p + tap - 1, ci] * w[tap, ci, co] )
// channels-last x (B, S0, S1, S2, cin), cin <= 4, bf16 or f32; out
// (B, S0, S1, S2, cout) in x's type; the sum in f32, rounded once.
//
// Replaces pulpo_tpu/attic/conv_narrow.py:conv3d_narrow_mxu (an im2col
// of the 27 * cin taps into VMEM and one MXU contraction per z-slice,
// f32 accumulation). Two bodies, chosen by x's type (a routing rule of
// kernels/conv_narrow.py, not a fallback):
//
// bf16: the tensor cores (mma.sync.m16n8k16, bf16 in, f32 accumulators)
// as an implicit GEMM, as the TPU kernel runs the MXU:
//   - M is output voxels: a block of 8 warps takes an output tile of 8
//     lines x 32 voxels of a plane (warp w: line w, as two runs of 16
//     voxels, one m16 tile each) and marches it along z through a chunk
//     of `tz` planes (the plan, kernels/conv_narrow.py:tile_plan);
//   - K is the 27 taps x cin_p channels in (kz, ky, kx, ci) order, cin_p
//     = cin rounded up to even (a zero channel after an odd cin), padded
//     with zero rows to a multiple of 16 (64, 64, 112, 112 for cin =
//     1..4): every A register is then one channel pair of one tap, one
//     aligned 32-bit shared-memory load. (With cin_p = cin, 96 rows at
//     cin = 3, a pair can span two taps and takes two 16-bit loads: the
//     3-channel launches were bound by those shared-memory instructions,
//     PERF.md.) N is cout, padded with zero columns to a multiple of 8,
//     taken 32 channels a pass;
//   - the weights: the wrapper packs the (K_pad, N_pad) bf16 matrix; a
//     warp keeps the B fragments of its pass in registers (loaded once
//     a block when cout <= 32, the training step's case, an instantiation
//     of its own);
//   - the input: a ring of RING planes of the tile with its 1-voxel halo
//     ((8 + 2) x (32 + 2) positions x cin_p bf16, zeros outside the
//     volume, the SAME padding, and in the pad channel), each plane
//     stored twice (slots s and s + RING), so that the three planes an
//     output plane reads are always three consecutive slots and a
//     thread's A offsets stay fixed. A halo plane
//     is loaded once, not three times. The next plane is loaded into
//     registers while the current one is multiplied and stored after it,
//     with one barrier a plane (a position's cin channels are 2 cin
//     bytes at any alignment, and an odd cin gains its zero channel on
//     the way: no cp.async unit fits them);
//   - A fragments: each lane reads, at offsets fixed per lane, its
//     channel pairs of the staged planes, as vel_head.cu's conv1 does; the
//     pad taps are masked to 0;
//   - the output sets the bound (64 of the 68 B a voxel at 2 -> 32):
//     the epilogue rounds each f32 accumulator once to bf16, stages the
//     fragments of a 16-voxel run in shared memory (rows padded to 80 B,
//     no bank conflicts), and writes whole voxel rows with 16-byte
//     stores, consecutive lanes on consecutive addresses (2-byte stores
//     where cout is not a multiple of 8).
// The tensor cores sum the products (exact in f32) in another order than
// the plain version, so a bf16 output may differ from it by one bf16 ulp
// where the f32 sum lies at a rounding boundary. What bounds it, measured
// (PERF.md): the output stream and the shared-memory pipe that the A
// fragments' loads keep busy (at the input size a launch without those
// loads took 0.16 of its 0.23 ms, one without its stores 0.19); not the
// tensor cores (one without its products took the same time).
//
// f32: the CUDA cores, bit-equal to the plain version. One block of 128
// threads per (row, 4 x 4 x 32 output voxels); the input tile with its
// halo (6 x 6 x 34 x cin, zero outside the volume) staged once in shared
// memory, channel-major, so that the 32 lanes of a warp read 32
// consecutive x. Each thread owns one (y, x) column and 4 z voxels; for
// each chunk of 8 output channels it stages the chunk's 27 * cin * 8
// weights in shared memory (every lane reads the same weight: a
// broadcast) and keeps 4 x 8 accumulators in registers. The (kz, ky)
// loops stay rolled and the block asks for 4 resident blocks an SM: with
// them unrolled the compiler hoisted every tap's weights and spilled.
// The taps are summed in the order (kz, ky, kx, ci), each product added
// to an accumulator that starts at 0, as the plain PyTorch version
// (kernels/conv_narrow.py) does; the product and the sum round
// separately (__fmul_rn, __fadd_rn; the file is built with -fmad=false).
// TF32 would miss the f32 path's bit-equality.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc.cuh"

namespace {

// ---- f32: the CUDA cores ---------------------------------------------

constexpr int TX = 32;           // output x per block (one warp)
constexpr int TY = 4;            // output y per block (one per warp)
constexpr int VZ = 4;            // output z per thread
constexpr int CO = 8;            // output channels per register chunk
constexpr int HX = TX + 2, HY = TY + 2, HZ = VZ + 2;
constexpr int THREADS = TX * TY;

template <int CIN>
__global__ void __launch_bounds__(THREADS, 4)
conv_narrow_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int S0, int S1, int S2, int cout,
                   int tiles_x, int tiles_y, int tiles_z) {
  __shared__ float xs[CIN][HZ][HY][HX];
  __shared__ __align__(16) float ws[27 * CIN][CO];

  long long t = blockIdx.x;
  const int tx = (int)(t % tiles_x); t /= tiles_x;
  const int ty = (int)(t % tiles_y); t /= tiles_y;
  const int tz = (int)(t % tiles_z);
  const long long b = t / tiles_z;
  const int x0 = tx * TX, y0 = ty * TY, z0 = tz * VZ;
  const int tid = threadIdx.x, lx = tid % TX, ly = tid / TX;
  const long long n = (long long)S0 * S1 * S2;
  const float* xb = x + b * n * CIN;

  for (int i = tid; i < HZ * HY * HX; i += THREADS) {
    const int hx = i % HX, hy = (i / HX) % HY, hz = i / (HX * HY);
    const int gx = x0 + hx - 1, gy = y0 + hy - 1, gz = z0 + hz - 1;
    const bool in = gx >= 0 && gx < S2 && gy >= 0 && gy < S1 && gz >= 0 && gz < S0;
    const long long off = in ? (((long long)gz * S1 + gy) * S2 + gx) * CIN : 0;
#pragma unroll
    for (int ci = 0; ci < CIN; ++ci) xs[ci][hz][hy][hx] = in ? xb[off + ci] : 0.0f;
  }

  const int gx = x0 + lx, gy = y0 + ly;
  const bool column = gx < S2 && gy < S1;
  const bool vec = (cout % CO) == 0;
  for (int c0 = 0; c0 < cout; c0 += CO) {
    __syncthreads();  // the tile is staged; the last chunk's weights are read
    for (int i = tid; i < 27 * CIN * CO; i += THREADS) {
      const int co = i % CO, k = i / CO;
      ws[k][co] = (c0 + co < cout) ? w[(long long)k * cout + c0 + co] : 0.0f;
    }
    __syncthreads();

    float acc[VZ][CO];
#pragma unroll
    for (int vz = 0; vz < VZ; ++vz)
#pragma unroll
      for (int co = 0; co < CO; ++co) acc[vz][co] = 0.0f;

#pragma unroll 1
    for (int kz = 0; kz < 3; ++kz) {
#pragma unroll 1
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
          for (int ci = 0; ci < CIN; ++ci) {
            const int k = ((kz * 3 + ky) * 3 + kx) * CIN + ci;
            const float4 wa = reinterpret_cast<const float4*>(ws[k])[0];
            const float4 wb = reinterpret_cast<const float4*>(ws[k])[1];
            const float wv[CO] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int vz = 0; vz < VZ; ++vz) {
              const float xv = xs[ci][vz + kz][ly + ky][lx + kx];
#pragma unroll
              for (int co = 0; co < CO; ++co)
                acc[vz][co] = __fadd_rn(acc[vz][co], __fmul_rn(xv, wv[co]));
            }
          }
        }
      }
    }

    if (column) {
      const int nc = min(CO, cout - c0);
#pragma unroll
      for (int vz = 0; vz < VZ; ++vz) {
        const int gz = z0 + vz;
        if (gz < S0) {
          float* o = out + (b * n + ((long long)gz * S1 + gy) * S2 + gx) * cout + c0;
          const float* v = acc[vz];
          if (vec) {
            reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
            reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
          } else {
            for (int c = 0; c < nc; ++c) o[c] = v[c];
          }
        }
      }
    }
  }
}

template <int CIN>
int launch_f32(const void* x, const void* w, void* out, int B, int S0, int S1, int S2,
               int cout, cudaStream_t stream) {
  const int tiles_x = (S2 + TX - 1) / TX, tiles_y = (S1 + TY - 1) / TY,
            tiles_z = (S0 + VZ - 1) / VZ;
  const long long blocks = (long long)B * tiles_x * tiles_y * tiles_z;
  conv_narrow_kernel<CIN><<<(unsigned int)blocks, THREADS, 0, stream>>>(
      (const float*)x, (const float*)w, (float*)out, S0, S1, S2, cout, tiles_x, tiles_y,
      tiles_z);
  return (int)cudaGetLastError();
}

// ---- bf16: the tensor cores ------------------------------------------

using tc::bf16;

constexpr int MX = 32, MY = 8;            // a block's output tile of a plane
constexpr int PX = MX + 2, PY = MY + 2;   // with its 1-voxel halo
constexpr int MT = 256;                   // threads: warp w computes line w
constexpr int RING = 5;                   // input planes kept (3 read, 1 stored, 1 spare)
constexpr int NC = 32;                    // output channels a pass: 4 n8 tiles
constexpr int SROW = NC + 8;              // staging row, bf16 (80 B)

template <int CIN> struct Geo {
  static constexpr int CP = CIN + CIN % 2;         // channels a staged position (even)
  static constexpr int K = 27 * CP;                // GEMM depth: taps x channels
  static constexpr int KS = (K + 15) / 16;         // k16 steps: K_pad / 16
  static constexpr int PLANE = PY * PX * CP;       // bf16 of a staged plane
  static constexpr int NLD = (PLANE + MT - 1) / MT;  // its elements a thread
};

// The plan of kernels/conv_narrow.py:tile_plan, 4 ints: tiles along x and
// y (of MX and MY voxels), planes a block marches, chunks along z.
struct NarrowPlan {
  int tiles_x, tiles_y, tz, chunks;
  bool ok(int B, int S0, int S1, int S2) const {
    return tiles_x >= 1 && tiles_y >= 1 && tz >= 1 && chunks >= 1 &&
           (long long)tiles_x * MX >= S2 && (long long)(tiles_x - 1) * MX < S2 &&
           (long long)tiles_y * MY >= S1 && (long long)(tiles_y - 1) * MY < S1 &&
           (long long)tz * chunks >= S0 && (long long)tz * (chunks - 1) < S0 &&
           (long long)tiles_x * tiles_y <= 0x7FFFFFFF && chunks <= 65535 && B <= 65535;
  }
};

// v, which the compiler must take as changed here: what is computed
// from it is computed after this point, not hoisted out of a loop
template <typename T>
__device__ __forceinline__ T opaque(T v) {
  asm volatile("" : "+r"(v));
  return v;
}

// ONE: cout <= 32, one pass, whose B fragments are loaded once a block
template <int CIN, bool ONE>
__global__ void __launch_bounds__(MT, 2)
conv_narrow_tc(const bf16* __restrict__ x, const bf16* __restrict__ wpk,  // (K_pad, N_pad)
               bf16* __restrict__ out, int S0, int S1, int S2, int cout, int tiles_x,
               int tz) {
  using G = Geo<CIN>;
  constexpr int CP = G::CP;
  __shared__ __align__(16) uint16_t s_x[2 * RING * G::PLANE];
  __shared__ __align__(16) bf16 s_out[MT / 32][16][SROW];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int x0 = (blockIdx.x % tiles_x) * MX, y0 = (blockIdx.x / tiles_x) * MY;
  const int z_begin = blockIdx.y * tz, z_end = min(z_begin + tz, S0);
  const int n_pad = (cout + 7) & ~7, passes = ONE ? 1 : (cout + NC - 1) / NC;
  const int plane_el = S1 * S2 * CIN;             // x's elements a plane
  const long long row = (long long)blockIdx.z * S0 * S1 * S2;
  const uint16_t* xr = reinterpret_cast<const uint16_t*>(x) + row * CIN;
  bf16* outr = out + row * cout;

  // the staged plane's elements this thread moves, e = tid + MT u in
  // (hy, hx, c) order (c < CP; zeros past cin and outside the volume),
  // loaded from input plane iz; their offsets are recomputed each plane
  // (`opaque`: kept across the march, they would take registers the body
  // needs)
  auto load_plane = [&](int iz, uint16_t (&v)[G::NLD]) {
    const bool in = iz >= 0 && iz < S0;
#pragma unroll
    for (int u = 0; u < G::NLD; ++u) {
      const int e = opaque(tid + MT * u);
      const int hy = e / (PX * CP), hx = e / CP % PX, ci = e % CP;
      const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
      v[u] = (in && e < G::PLANE && ci < CIN && gy >= 0 && gy < S1 && gx >= 0 && gx < S2)
                 ? __ldg(xr + iz * plane_el + (gy * S2 + gx) * CIN + ci) : (uint16_t)0;
    }
  };
  auto store_plane = [&](int iz, const uint16_t (&v)[G::NLD]) {
    const int s = (iz + 1) % RING;
#pragma unroll
    for (int u = 0; u < G::NLD; ++u) {
      const int e = tid + MT * u;
      if (e < G::PLANE) {
        s_x[s * G::PLANE + e] = v[u];
        s_x[(s + RING) * G::PLANE + e] = v[u];
      }
    }
  };

  // the A columns of this lane: k = 16 ks + 2 tq + 8 i, with k + 1 the
  // next channel of the same tap (one 32-bit word), at offsets (bf16)
  // from a position of the three-plane window, i = 0 and 1 in the low and
  // high half of kp[ks]; pad taps read offset 0 and are masked to zero
  uint32_t kp[G::KS];
#pragma unroll
  for (int ks = 0; ks < G::KS; ++ks) {
    uint32_t packed = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = 16 * ks + 2 * tq + 8 * i, tap = k / CP, ci = k % CP;
      const int off = k < G::K ? (tap / 9) * G::PLANE + ((tap / 3) % 3 * PX + tap % 3) * CP + ci
                               : 0;
      packed |= (uint32_t)off << (16 * i);
    }
    kp[ks] = packed;
  }
  // whether column 16 (KS - 1) + 2 tq + 8 i is a pad tap
  auto pad = [&](int i) { return 16 * (G::KS - 1) + 2 * tq + 8 * i >= G::K; };

  // B fragments of pass c: rows k = 16 ks + 2 tq (+ 1, + 8, + 9), column
  // n = 32 c + 8 j + g of the packed weights
  uint32_t bw[G::KS][4][2];
  const uint16_t* wu = reinterpret_cast<const uint16_t*>(wpk);
  auto load_b = [&](int c) {
#pragma unroll
    for (int ks = 0; ks < G::KS; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = NC * c + 8 * j + g, k = 16 * ks + 2 * tq + 8 * h;
          bw[ks][j][h] = n < n_pad ? (uint32_t)__ldg(wu + k * n_pad + n) |
                                         ((uint32_t)__ldg(wu + (k + 1) * n_pad + n) << 16)
                                   : 0u;
        }
  };
  if (ONE) load_b(0);

  // planes z_begin - 1 and z_begin to shared memory, z_begin + 1 into
  // registers
  uint16_t pf[G::NLD];
  load_plane(z_begin - 1, pf);
  store_plane(z_begin - 1, pf);
  load_plane(z_begin, pf);
  store_plane(z_begin, pf);
  load_plane(z_begin + 1, pf);

  const int y = y0 + warp;
  const uint16_t* xs16 = s_x;
  const bool vec = (cout % 8) == 0 && (reinterpret_cast<uintptr_t>(outr) & 15) == 0;
  for (int z = z_begin; z < z_end; ++z) {
    store_plane(z + 1, pf);
    __syncthreads();  // planes z - 1 .. z + 1 are staged
    if (z + 1 < z_end) load_plane(z + 2, pf);  // lands while plane z is multiplied
    if (y >= S1) continue;
    const int wb = (z % RING) * G::PLANE;  // the slot of input plane z - 1
    for (int c = 0; c < passes; ++c) {
      if (!ONE) load_b(c);
      const int nt = min(4, (n_pad - NC * c) / 8);  // n8 tiles of this pass
#pragma unroll
      for (int r = 0; r < MX / 16; ++r) {
        const int xr0 = x0 + 16 * r;
        if (xr0 >= S2) break;
        int xb[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) xb[h] = wb + (warp * PX + 16 * r + g + 8 * h) * CP;
        float acc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < G::KS; ++ks) {
          // this k-step's offsets, unpacked where they are used
          // (`opaque`: the sums are not hoisted out of the march)
          const uint32_t o = opaque(kp[ks]);
          const int off[2] = {(int)(o & 0xFFFFu), (int)(o >> 16)};
          auto val = [&](int h, int i) -> uint32_t {
            const uint32_t v = *reinterpret_cast<const uint32_t*>(xs16 + xb[h] + off[i]);
            return ks == G::KS - 1 && pad(i) ? 0u : v;
          };
          const uint32_t a[4] = {val(0, 0), val(1, 0), val(0, 1), val(1, 1)};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < nt) tc::mma_bf16(acc[j], a, bw[ks][j][0], bw[ks][j][1]);
        }
        // epilogue: round once to bf16, stage the run's rows, write them
        // as 16-byte pieces (8 channels), consecutive lanes consecutive
        __syncwarp();
        uint32_t* st = reinterpret_cast<uint32_t*>(&s_out[warp][0][0]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[(g * SROW + 8 * j + 2 * tq) / 2] = tc::pack_bf16x2(acc[j][0], acc[j][1]);
          st[((g + 8) * SROW + 8 * j + 2 * tq) / 2] = tc::pack_bf16x2(acc[j][2], acc[j][3]);
        }
        __syncwarp();
        const int ch0 = NC * c;
#pragma unroll
        for (int q = lane; q < 64; q += 32) {
          const int rr = q >> 2, part = q & 3, xv = xr0 + rr;
          const int nvalid = min(8, cout - ch0 - 8 * part);
          if (part >= nt || nvalid <= 0 || xv >= S2) continue;
          bf16* dst = outr + ((z * S1 + y) * S2 + xv) * cout + ch0 + 8 * part;
          const bf16* src = &s_out[warp][rr][8 * part];
          if (vec) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
          } else {
            for (int e = 0; e < nvalid; ++e) dst[e] = src[e];
          }
        }
      }
    }
  }
}

template <int CIN>
int launch_tc(const void* x, const void* w, void* out, int B, int S0, int S1, int S2,
              int cout, const NarrowPlan& p, cudaStream_t stream) {
  if (!p.ok(B, S0, S1, S2) || (long long)S0 * S1 * S2 * (cout > CIN ? cout : CIN) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.tiles_x * p.tiles_y, p.chunks, B);
  if (cout <= NC)
    conv_narrow_tc<CIN, true><<<grid, MT, 0, stream>>>((const bf16*)x, (const bf16*)w, (bf16*)out,
                                                       S0, S1, S2, cout, p.tiles_x, p.tz);
  else
    conv_narrow_tc<CIN, false><<<grid, MT, 0, stream>>>((const bf16*)x, (const bf16*)w,
                                                        (bf16*)out, S0, S1, S2, cout, p.tiles_x,
                                                        p.tz);
  return (int)cudaGetLastError();
}

template <int CIN>
int launch(const void* x, const void* w, void* out, int bf16in, int B, int S0, int S1,
           int S2, int cout, const int* plan, cudaStream_t stream) {
  if (!bf16in) return launch_f32<CIN>(x, w, out, B, S0, S1, S2, cout, stream);
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  const NarrowPlan p = {plan[0], plan[1], plan[2], plan[3]};
  return launch_tc<CIN>(x, w, out, B, S0, S1, S2, cout, p, stream);
}

}  // namespace

// f32 (bf16_in = 0): w (27, cin, cout) float32, tap-major (kz, ky, kx); plan
// unused. bf16 (bf16_in = 1): w the packed (K_pad, N_pad) bf16 matrix
// (kernels/conv_narrow.py:pack_weights; row k = 27-tap index * cin_p + ci,
// cin_p = cin rounded up to even, K_pad = 27 cin_p rounded up to 16,
// N_pad = cout rounded up to 8, zeros in the pad channel and past them)
// and plan 4 ints (kernels/conv_narrow.py:tile_plan), refused
// unless it tiles the volume. x (B, S0, S1, S2, cin), out (B, S0, S1, S2,
// cout) in x's type.
extern "C" int pulpo_conv_narrow(const void* x, const void* w, void* out, int bf16_in,
                                 int B, int cin, int S0, int S1, int S2, int cout,
                                 const int* plan, void* stream) {
  if (B < 0 || S0 < 0 || S1 < 0 || S2 < 0 || cout < 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * S0 * S1 * S2 * cout == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (cin) {
    case 1: return launch<1>(x, w, out, bf16_in, B, S0, S1, S2, cout, plan, s);
    case 2: return launch<2>(x, w, out, bf16_in, B, S0, S1, S2, cout, plan, s);
    case 3: return launch<3>(x, w, out, bf16_in, B, S0, S1, S2, cout, plan, s);
    case 4: return launch<4>(x, w, out, bf16_in, B, S0, S1, S2, cout, plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
