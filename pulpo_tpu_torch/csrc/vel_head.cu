// The whole eval VelocityField head for Hopper (sm_90a):
//   conv3^3(zdim -> n0) + b1 -> eval BN1 -> LeakyReLU(0.2)
//   -> conv3^3(n0 -> n0) + b2 -> eval BN2 -> LeakyReLU(0.2)
//   -> 1x1(n0 -> 3) + b3
//
// Replaces pulpo_tpu/kernels/vel_head.py:velocity_head_fused. The TPU
// kernel exists to keep the two n0-wide intermediates in VMEM, so that
// only 3-channel tensors cross device memory; this kernel does the same
// with shared memory.
//
// The head is bound by operations: about 60.7 kFLOP per voxel at n0 =
// 32, 91 % of it conv2 (27 n0 n0 MACs), against 6 + 6 bytes of input and
// output a voxel in bf16.
//
// bf16 design (tensor cores, mma.sync.m16n8k16 bf16 -> f32): a
// persistent grid (one block of 256 threads per SM) walks bricks of TZ x
// 8 x 16 output voxels (TZ = 4 at n0 <= 32, 2 at n0 = 64) as the host's
// plan orders them (kernels/vel_head.py:tile_plan), which the launch
// checks against the template's brick (tc::BrickPlan).
//   0. Once per block: conv1's weights (n0 x K1, K1 = 27 taps x 4
//      channels, padded to 112 with zeros) and, at n0 <= 32, all 27 taps
//      of conv2's weights (27 x n0 x n0: 55 KB at n0 = 32) go to shared
//      memory by cp.async and stay there for every brick the block
//      takes. At n0 = 64 they would take 221 KB, so there the taps
//      stream in groups of three through a two-group cp.async ring.
//   1. The input brick with a 2-voxel halo, 4 channels a position (zeros
//      past zdim), zeros outside the volume (conv1's SAME padding); every
//      load of a thread is issued before its first store.
//   2. conv1 as an implicit GEMM over the brick plus a 1-voxel halo
//      ((TZ+2) x 10 x 18 positions, 2.1x / 2.6x the brick): a thread's A
//      fragments are channel pairs of the input brick at offsets fixed
//      per thread (kept in registers), its B fragments come by ldmatrix;
//      the epilogue follows the accumulator fragments, and the
//      activations go to shared memory as bf16 (n0 + 8 channels a
//      position, so that ldmatrix rows fall in distinct banks). Positions
//      outside the volume are stored as ZERO: conv2's SAME padding pads
//      conv1's output, so conv1 must not be evaluated there.
//   3. conv2 as an implicit GEMM read in place: ldmatrix takes a
//      16-position run of the intermediate brick shifted by (dz, dx) (the
//      A fragment), which serves the up to three output lines that read
//      it (dy = 0, 1, 2), each with its tap's weights (B); each warp owns
//      TZ x 8 / 8 lines of 16 output voxels x all n0 channels. The
//      epilogue and the 1x1 head (n0 -> 3, a quad's partial sums joined
//      by shuffles) follow in registers; 3 values per voxel are written.
//
// f32 design (CUDA cores, unchanged): one block of 256 threads per
// 4 x 8 x 8 output tile; the input tile with a 2-voxel halo in shared
// memory; conv1 + epilogue over the tile plus a 1-voxel halo, into
// shared memory channel-major; conv2 one output voxel per thread, all
// n0 output channels in registers, each tap's n0 x n0 weights staged in
// shared memory and read as broadcast float4s; the epilogue and the 1x1
// head in registers. TF32 would miss its 1e-4-of-scale tolerance.
//
// Rounding points (pulpo_tpu/kernels/vel_head.py:222-230, 260-278 and
// kernels/activations.py:28-43): each conv's sum is rounded to the
// compute type before its bias add (in that type); BN computes
// (f32(x) - mean) * (rsqrt(var + eps) * scale) + bias in float32, then
// rounds; LeakyReLU multiplies by 0.2 rounded to the compute type.
//
// n0 is a template parameter (16, 32 or 64); the wrapper pads narrower
// heads with zero channels, which add exact zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc.cuh"

namespace {

constexpr int TZ = 4, TY = 8, TX = 8;
constexpr int NT = TZ * TY * TX;                    // 256 threads
constexpr int AZ = TZ + 2, AY = TY + 2, AX = TX + 2;
constexpr int NA = AZ * AY * AX;                    // conv1 positions
constexpr int XZ = TZ + 4, XY = TY + 4, XX = TX + 4;
constexpr int NX = XZ * XY * XX;                    // input positions
constexpr int MAXZ = 4;

// conv sum -> +bias -> eval BN -> LeakyReLU; BF16: each step rounds to
// bf16 (float32 is the compute type otherwise, and rounds nowhere)
template <bool BF16>
__device__ __forceinline__ float epilogue(float acc, float b, float mean,
                                          float mul, float add, float c02) {
  const auto rnd = [](float v) { return BF16 ? tc::rnd_bf16(v) : v; };
  const float a = rnd(rnd(acc) + b);
  const float y = __fadd_rn(__fmul_rn(__fsub_rn(a, mean), mul), add);
  const float v = rnd(y);
  return (y < 0.0f) ? rnd(__fmul_rn(c02, v)) : v;
}

template <int N0>
__host__ __device__ constexpr int w_floats() {
  return (27 * MAXZ * N0 > N0 * N0) ? 27 * MAXZ * N0 : N0 * N0;
}

template <int N0>
constexpr size_t smem_bytes() {
  return sizeof(float) * (MAXZ * NX + w_floats<N0>() + N0 * NA);
}

template <int N0>
__global__ void __launch_bounds__(NT)
vel_head_f32(const float* __restrict__ z, float* __restrict__ out,
                const float* __restrict__ w1,    // [27][zdim][N0]
                const float* __restrict__ w2,    // [27][N0 in][N0 out]
                const float* __restrict__ w3,    // [N0][3]
                const float* __restrict__ bias,  // [3][N0]: b1, b2, b3
                const float* __restrict__ bn,    // [6][N0]: mean, mul, add x2
                int S0, int S1, int S2, int zdim, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_x = reinterpret_cast<float*>(smem);          // [MAXZ][NX]
  float* s_w = s_x + MAXZ * NX;                          // w1, then w2[tap]
  float* s_a = s_w + w_floats<N0>();                     // [N0][NA]

  const int tid = threadIdx.x;
  const int tx0 = (blockIdx.x % tiles_x) * TX;
  const int ty0 = (blockIdx.x / tiles_x) * TY;
  const int tz0 = blockIdx.y * TZ;
  const long long plane = (long long)S1 * S2;
  const float* zb = z + (long long)blockIdx.z * S0 * plane * zdim;
  const float c02 = 0.2f;

  // 1. input tile + 2-voxel halo, zero outside the volume
  for (int i = tid; i < zdim * NX; i += NT) {
    const int c = i / NX, p = i - c * NX;
    const int gz = tz0 - 2 + p / (XY * XX);
    const int gy = ty0 - 2 + (p / XX) % XY;
    const int gx = tx0 - 2 + p % XX;
    float v = 0.0f;
    if (gz >= 0 && gz < S0 && gy >= 0 && gy < S1 && gx >= 0 && gx < S2)
      v = zb[((long long)gz * plane + (long long)gy * S2 + gx) * zdim + c];
    s_x[c * NX + p] = v;
  }
  for (int i = tid; i < 27 * zdim * N0; i += NT) s_w[i] = w1[i];
  __syncthreads();

  // 2. conv1 + epilogue over the tile + 1-voxel halo
  for (int p = tid; p < NA; p += NT) {
    const int pz = p / (AY * AX), py = (p / AX) % AY, px = p % AX;
    const int gz = tz0 - 1 + pz, gy = ty0 - 1 + py, gx = tx0 - 1 + px;
    if (!(gz >= 0 && gz < S0 && gy >= 0 && gy < S1 && gx >= 0 && gx < S2)) {
#pragma unroll
      for (int co = 0; co < N0; ++co) s_a[co * NA + p] = 0.0f;
      continue;
    }
    float acc[N0];
#pragma unroll
    for (int co = 0; co < N0; ++co) acc[co] = 0.0f;
    for (int tap = 0; tap < 27; ++tap) {
      const int dz = tap / 9, dy = (tap / 3) % 3, dx = tap % 3;
      const int xp = (pz + dz) * (XY * XX) + (py + dy) * XX + (px + dx);
      for (int ci = 0; ci < zdim; ++ci) {
        const float xv = s_x[ci * NX + xp];
        const float4* wr = reinterpret_cast<const float4*>(s_w + (tap * zdim + ci) * N0);
#pragma unroll
        for (int q = 0; q < N0 / 4; ++q) {
          const float4 w = wr[q];
          acc[4 * q + 0] = fmaf(xv, w.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(xv, w.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(xv, w.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(xv, w.w, acc[4 * q + 3]);
        }
      }
    }
#pragma unroll
    for (int co = 0; co < N0; ++co)
      s_a[co * NA + p] = epilogue<false>(acc[co], bias[co], bn[co], bn[N0 + co],
                                         bn[2 * N0 + co], c02);
  }

  // 3. conv2 + epilogue + 1x1 head, one output voxel per thread
  const int tz = tid / (TY * TX), ty = (tid / TX) % TY, tx = tid % TX;
  float acc[N0];
#pragma unroll
  for (int co = 0; co < N0; ++co) acc[co] = 0.0f;
  for (int tap = 0; tap < 27; ++tap) {
    __syncthreads();  // s_a complete (first tap); previous tap's s_w consumed
    const float4* src = reinterpret_cast<const float4*>(w2 + (size_t)tap * N0 * N0);
    float4* dst = reinterpret_cast<float4*>(s_w);
    for (int i = tid; i < N0 * N0 / 4; i += NT) dst[i] = src[i];
    __syncthreads();
    const int dz = tap / 9, dy = (tap / 3) % 3, dx = tap % 3;
    const int ap = (tz + dz) * (AY * AX) + (ty + dy) * AX + (tx + dx);
    for (int ci = 0; ci < N0; ++ci) {
      const float a = s_a[ci * NA + ap];
      const float4* wr = reinterpret_cast<const float4*>(s_w + ci * N0);
#pragma unroll
      for (int q = 0; q < N0 / 4; ++q) {
        const float4 w = wr[q];
        acc[4 * q + 0] = fmaf(a, w.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(a, w.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(a, w.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(a, w.w, acc[4 * q + 3]);
      }
    }
  }

  float o0 = 0.0f, o1 = 0.0f, o2 = 0.0f;
#pragma unroll
  for (int co = 0; co < N0; ++co) {
    const float v = epilogue<false>(acc[co], bias[N0 + co], bn[3 * N0 + co],
                                    bn[4 * N0 + co], bn[5 * N0 + co], c02);
    o0 = fmaf(v, w3[co * 3 + 0], o0);
    o1 = fmaf(v, w3[co * 3 + 1], o1);
    o2 = fmaf(v, w3[co * 3 + 2], o2);
  }
  const int gz = tz0 + tz, gy = ty0 + ty, gx = tx0 + tx;
  if (gz < S0 && gy < S1 && gx < S2) {
    float* o = out + (((long long)blockIdx.z * S0 + gz) * plane + (long long)gy * S2 + gx) * 3;
    o[0] = o0 + bias[2 * N0 + 0];
    o[1] = o1 + bias[2 * N0 + 1];
    o[2] = o2 + bias[2 * N0 + 2];
  }
}

template <int N0>
int launch(const void* z, void* out, const float* w1, const float* w2,
           const float* w3, const float* bias, const float* bn, int B,
           int S0, int S1, int S2, int zdim, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<N0>();
  if (B > 65535) return (int)cudaErrorInvalidValue;  // gridDim.z
  cudaError_t e = cudaFuncSetAttribute(vel_head_f32<N0>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles_x = (S2 + TX - 1) / TX;
  const int tiles_y = (S1 + TY - 1) / TY;
  const dim3 grid(tiles_x * tiles_y, (S0 + TZ - 1) / TZ, B);
  vel_head_f32<N0><<<grid, NT, smem, stream>>>(
      (const float*)z, (float*)out, w1, w2, w3, bias, bn, S0, S1, S2, zdim, tiles_x);
  return (int)cudaGetLastError();
}

// ---- bf16: the tensor-core kernel -----------------------------------

using tc::bf16;

template <int N0> struct VGeo {
  static constexpr bool RESIDENT = N0 <= 32;            // conv2 weights stay in smem
  static constexpr int TZ = N0 <= 32 ? 4 : 2, TY = 8, TX = 16;
  static constexpr int AZ = TZ + 2, AY = TY + 2, AX = TX + 2;
  static constexpr int NA = AZ * AY * AX;               // conv1 positions
  static constexpr int MA = (NA + 15) / 16;             // their m16 tiles
  static constexpr int XZ = TZ + 4, XY = TY + 4, XX = TX + 4;
  static constexpr int NX = XZ * XY * XX;               // input positions
  static constexpr int AP = N0 + 8;                     // activation row, bf16
  static constexpr int KP1 = 112;                       // conv1 K: 27 taps x 4 channels, padded
  static constexpr int W1P = KP1 + 8;                   // conv1 weight row, bf16
  static constexpr int NXI = (NX + 255) / 256;          // input positions a thread
  static constexpr int WSLOTS = RESIDENT ? 27 : 6;      // conv2 weight taps in smem
  static constexpr int LPW = TZ * TY / 8;               // output lines a warp
  static constexpr int NPAR = 11 * N0 + 3;              // b1, bn1, b2, bn2, w3, b3
  static constexpr size_t SMEM = 2 * ((size_t)WSLOTS * N0 * AP + (size_t)NA * AP +
                                      (size_t)N0 * W1P + 4 * (size_t)NX) +
                                 4 * NPAR;
};

template <int N0>
__global__ void __launch_bounds__(256, 1)
vel_head_tc(const bf16* __restrict__ z, bf16* __restrict__ out,
            const bf16* __restrict__ w1,     // [N0][KP1], k = 4 tap + ci
            const bf16* __restrict__ w2,     // [27][N0 out][N0 in]
            const float* __restrict__ w3,    // [N0][3]
            const float* __restrict__ bias,  // [3][N0]: b1, b2, b3
            const float* __restrict__ bn,    // [6][N0]: mean, mul, add x2
            int S0, int S1, int S2, int zdim, int tn_z, int tn_y, int tn_x, int tiles) {
  using G = VGeo<N0>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_w2 = reinterpret_cast<bf16*>(smem);
  bf16* s_a = s_w2 + G::WSLOTS * N0 * G::AP;
  bf16* s_w1 = s_a + G::NA * G::AP;
  bf16* s_x = s_w1 + N0 * G::W1P;                           // [NX][4]
  float* s_par = reinterpret_cast<float*>(s_x + 4 * G::NX);
  const float* p_b1 = s_par;
  const float* p_bn1 = s_par + N0;
  const float* p_b2 = s_par + 4 * N0;
  const float* p_bn2 = s_par + 5 * N0;
  const float* p_w3 = s_par + 8 * N0;
  const float* p_b3 = s_par + 11 * N0;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;

  // 0. weights and parameters, once per block
  for (int i = tid; i < N0 * G::KP1 / 8; i += 256) {
    const int n = i / (G::KP1 / 8), q = i - n * (G::KP1 / 8);
    tc::cp_async16(s_w1 + n * G::W1P + 8 * q, w1 + (size_t)n * G::KP1 + 8 * q);
  }
  if (G::RESIDENT)
    for (int i = tid; i < 27 * N0 * N0 / 8; i += 256) {
      const int row = i / (N0 / 8), q = i - row * (N0 / 8);
      tc::cp_async16(s_w2 + row * G::AP + 8 * q, w2 + (size_t)row * N0 + 8 * q);
    }
  tc::cp_async_commit();
  for (int i = tid; i < N0; i += 256) {
    s_par[i] = bias[i];
    s_par[4 * N0 + i] = bias[N0 + i];
    for (int j = 0; j < 3; ++j) {
      s_par[N0 + j * N0 + i] = bn[j * N0 + i];
      s_par[5 * N0 + j * N0 + i] = bn[(3 + j) * N0 + i];
      s_par[8 * N0 + 3 * i + j] = w3[3 * i + j];
    }
  }
  if (tid < 3) s_par[11 * N0 + tid] = bias[2 * N0 + tid];
  // conv1's A columns of this thread: k = 16 ks + 2 tq (+ 8), a channel
  // pair of tap k / 4 at this offset from a position of the input brick
  // (in bf16 units); past the 27 taps, masked to zero
  int kof[G::KP1 / 16][2];
  uint32_t kmask[G::KP1 / 16][2];
#pragma unroll
  for (int ks = 0; ks < G::KP1 / 16; ++ks)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = 16 * ks + 2 * tq + 8 * i, tap = k >> 2;
      kof[ks][i] = tap < 27 ? ((tap / 9 * G::XY + (tap / 3) % 3) * G::XX + tap % 3) * 4 + (k & 3)
                            : 0;
      kmask[ks][i] = tap < 27 ? 0xFFFFFFFFu : 0u;
    }
  tc::cp_async_wait_all();
  __syncthreads();

  const float c02 = tc::rnd_bf16(0.2f);
  const long long plane = (long long)S1 * S2;
  const uint16_t* xs = reinterpret_cast<const uint16_t*>(s_x);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {  // kernels/_build.py:tile_origin
    const int per_row = tn_z * tn_y * tn_x;
    const int r = t / per_row, rem = t - r * per_row;
    const int z0 = rem / (tn_y * tn_x) * G::TZ;
    const int y0 = (rem / tn_x) % tn_y * G::TY;
    const int x0 = rem % tn_x * G::TX;
    const bf16* zb = z + (long long)r * S0 * plane * zdim;

    // 1. input brick + 2-voxel halo, zero outside the volume (channels
    // past zdim too); every load issued before the first store
    uint32_t xv[G::NXI][4];
#pragma unroll
    for (int i = 0; i < G::NXI; ++i) {
      const int p = tid + 256 * i;
      const int gz = z0 - 2 + p / (G::XY * G::XX);
      const int gy = y0 - 2 + (p / G::XX) % G::XY;
      const int gx = x0 - 2 + p % G::XX;
      const bool in = p < G::NX && gz >= 0 && gz < S0 && gy >= 0 && gy < S1 && gx >= 0 &&
                      gx < S2;
      const uint16_t* src = reinterpret_cast<const uint16_t*>(zb) +
                            ((long long)gz * plane + (long long)gy * S2 + gx) * zdim;
#pragma unroll
      for (int c = 0; c < 4; ++c) xv[i][c] = (in && c < zdim) ? src[c] : 0u;
    }
#pragma unroll
    for (int i = 0; i < G::NXI; ++i) {
      const int p = tid + 256 * i;
      if (p < G::NX)
        *reinterpret_cast<uint2*>(s_x + 4 * p) =
            make_uint2(xv[i][0] | (xv[i][1] << 16), xv[i][2] | (xv[i][3] << 16));
    }
    __syncthreads();

    // 2. conv1 + epilogue over the brick + 1-voxel halo, into s_a
    for (int mt = warp; mt < G::MA; mt += 8) {
      int xb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int p = mt * 16 + g + 8 * h;
        p = p < G::NA ? p : G::NA - 1;
        const int pz = p / (G::AY * G::AX), py = (p / G::AX) % G::AY, px = p % G::AX;
        xb[h] = ((pz * G::XY + py) * G::XX + px) * 4;
      }
      float acc[N0 / 8][4];
#pragma unroll
      for (int j = 0; j < N0 / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < G::KP1 / 16; ++ks) {
        auto val = [&](int h, int i) -> uint32_t {
          return *reinterpret_cast<const uint32_t*>(xs + xb[h] + kof[ks][i]) & kmask[ks][i];
        };
        const uint32_t a[4] = {val(0, 0), val(1, 0), val(0, 1), val(1, 1)};
#pragma unroll
        for (int jj = 0; jj < N0 / 16; ++jj) {
          uint32_t q[4];
          tc::ldmatrix_x4(q, s_w1 + ((2 * jj + (lane >> 4)) * 8 + (lane & 7)) * G::W1P +
                                 ks * 16 + ((lane >> 3) & 1) * 8);
          tc::mma_bf16(acc[2 * jj], a, q[0], q[1]);
          tc::mma_bf16(acc[2 * jj + 1], a, q[2], q[3]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + g + 8 * h;
        if (p >= G::NA) continue;
        const int gz = z0 - 1 + p / (G::AY * G::AX);
        const int gy = y0 - 1 + (p / G::AX) % G::AY;
        const int gx = x0 - 1 + p % G::AX;
        const bool in = gz >= 0 && gz < S0 && gy >= 0 && gy < S1 && gx >= 0 && gx < S2;
#pragma unroll
        for (int j = 0; j < N0 / 8; ++j) {
          const int co = 8 * j + 2 * tq;
          float v[2] = {0.0f, 0.0f};
          if (in)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              v[e] = epilogue<true>(acc[j][2 * h + e], p_b1[co + e], p_bn1[co + e],
                                    p_bn1[N0 + co + e], p_bn1[2 * N0 + co + e], c02);
          *reinterpret_cast<uint32_t*>(s_a + p * G::AP + co) = tc::pack_bf16x2(v[0], v[1]);
        }
      }
    }
    // conv2's 3 taps (dy = 0, 1, 2) of tap group gi = 3 dz + dx, into
    // slots 3 (gi % 2) .. + 2 (the streamed weights at n0 = 64)
    auto stream_group = [&](int gi) {
      constexpr int SLAB = N0 * N0 / 8;
      for (int i = tid; i < 3 * SLAB; i += 256) {
        const int dy = i / SLAB, rem = i - dy * SLAB;
        const int row = rem / (N0 / 8), q = rem - row * (N0 / 8);
        const int tap = gi / 3 * 9 + dy * 3 + gi % 3;
        tc::cp_async16(s_w2 + (((gi & 1) * 3 + dy) * N0 + row) * G::AP + 8 * q,
                       w2 + ((size_t)tap * N0 + row) * N0 + 8 * q);
      }
      tc::cp_async_commit();
    };
    if (!G::RESIDENT) stream_group(0);
    __syncthreads();

    // 3. conv2, read in place from s_a: each warp owns LPW consecutive
    // lines of 16 voxels of one plane. For each tap group (dz, dx), every
    // A fragment (an input line shifted by dx) feeds the up to three
    // output lines that read it (dy = 0, 1, 2).
    float acc[G::LPW][N0 / 8][4];
#pragma unroll
    for (int l = 0; l < G::LPW; ++l)
#pragma unroll
      for (int j = 0; j < N0 / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[l][j][e] = 0.0f;
    const int zo = warp * G::LPW / G::TY, yo0 = warp * G::LPW % G::TY;
    for (int gi = 0; gi < 9; ++gi) {
      const int dz = gi / 3, dx = gi % 3;
      if (!G::RESIDENT) {
        tc::cp_async_wait_all();
        __syncthreads();  // this group's slabs landed; the other slots' readers are done
        if (gi + 1 < 9) stream_group(gi + 1);
      }
#pragma unroll
      for (int ks = 0; ks < N0 / 16; ++ks) {
        uint32_t b[3][N0 / 8][2];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const bf16* wt = s_w2 + (G::RESIDENT ? dz * 9 + dy * 3 + dx : (gi & 1) * 3 + dy) *
                                      N0 * G::AP;
#pragma unroll
          for (int jj = 0; jj < N0 / 16; ++jj) {
            uint32_t q[4];
            tc::ldmatrix_x4(q, wt + ((2 * jj + (lane >> 4)) * 8 + (lane & 7)) * G::AP +
                                   ks * 16 + ((lane >> 3) & 1) * 8);
            b[dy][2 * jj][0] = q[0];
            b[dy][2 * jj][1] = q[1];
            b[dy][2 * jj + 1][0] = q[2];
            b[dy][2 * jj + 1][1] = q[3];
          }
        }
#pragma unroll
        for (int i = 0; i < G::LPW + 2; ++i) {
          const int p = ((zo + dz) * G::AY + yo0 + i) * G::AX + (lane & 15) + dx;
          uint32_t a[4];
          tc::ldmatrix_x4(a, s_a + p * G::AP + ks * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
            if (i - dy >= 0 && i - dy < G::LPW)
#pragma unroll
              for (int j = 0; j < N0 / 8; ++j)
                tc::mma_bf16(acc[i - dy][j], a, b[dy][j][0], b[dy][j][1]);
        }
      }
    }

    // conv2's epilogue and the 1x1 head, in registers
#pragma unroll
    for (int l = 0; l < G::LPW; ++l) {
      const int line = warp * G::LPW + l;
      const int gz = z0 + line / G::TY, gy = y0 + line % G::TY;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float o[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < N0 / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = 8 * j + 2 * tq + e;
            const float v = epilogue<true>(acc[l][j][2 * h + e], p_b2[co], p_bn2[co],
                                           p_bn2[N0 + co], p_bn2[2 * N0 + co], c02);
#pragma unroll
            for (int q = 0; q < 3; ++q) o[q] = fmaf(v, p_w3[3 * co + q], o[q]);
          }
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          o[q] += __shfl_xor_sync(0xffffffffu, o[q], 1);
          o[q] += __shfl_xor_sync(0xffffffffu, o[q], 2);
        }
        const int gx = x0 + g + 8 * h;
        if (tq == 0 && gz < S0 && gy < S1 && gx < S2) {
          bf16* dst = out + (((long long)r * S0 + gz) * plane + (long long)gy * S2 + gx) * 3;
#pragma unroll
          for (int q = 0; q < 3; ++q) dst[q] = __float2bfloat16_rn(tc::rnd_bf16(o[q]) + p_b3[q]);
        }
      }
    }
    __syncthreads();  // s_x and s_a are rewritten by the next brick
  }
}

template <int N0>
int launch_tc(const void* z, void* out, const void* w1, const void* w2, const float* w3,
              const float* bias, const float* bn, int B, int S0, int S1, int S2, int zdim,
              int kp1, const tc::BrickPlan& plan, cudaStream_t stream) {
  using G = VGeo<N0>;
  if (kp1 != G::KP1 || !plan.ok(G::TZ, G::TY, G::TX, B, S0, S1, S2))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(vel_head_tc<N0>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)G::SMEM);
  if (e != cudaSuccess) return (int)e;
  vel_head_tc<N0><<<plan.grid, 256, G::SMEM, stream>>>(
      (const bf16*)z, (bf16*)out, (const bf16*)w1, (const bf16*)w2, w3, bias, bn, S0, S1, S2,
      zdim, plan.tn_z, plan.tn_y, plan.tn_x, plan.tiles);
  return (int)cudaGetLastError();
}

int dispatch_f32(int n0p, const void* z, void* out, const float* w1, const float* w2,
                 const float* w3, const float* bias, const float* bn, int B, int S0, int S1,
                 int S2, int zdim, cudaStream_t s) {
  switch (n0p) {
    case 16: return launch<16>(z, out, w1, w2, w3, bias, bn, B, S0, S1, S2, zdim, s);
    case 32: return launch<32>(z, out, w1, w2, w3, bias, bn, B, S0, S1, S2, zdim, s);
    case 64: return launch<64>(z, out, w1, w2, w3, bias, bn, B, S0, S1, S2, zdim, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_tc(int n0p, const void* z, void* out, const void* w1, const void* w2,
                const float* w3, const float* bias, const float* bn, int B, int S0, int S1,
                int S2, int zdim, int kp1, const tc::BrickPlan& plan, cudaStream_t s) {
  switch (n0p) {
    case 16: return launch_tc<16>(z, out, w1, w2, w3, bias, bn, B, S0, S1, S2, zdim, kp1, plan, s);
    case 32: return launch_tc<32>(z, out, w1, w2, w3, bias, bn, B, S0, S1, S2, zdim, kp1, plan, s);
    case 64: return launch_tc<64>(z, out, w1, w2, w3, bias, bn, B, S0, S1, S2, zdim, kp1, plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// f32 (plan == NULL): w1 [27][zdim][n0p], w2 [27][n0p in][n0p out]
// float32, kp1 ignored, B <= 65535. bf16 (plan != NULL): w1 [n0p][kp1 =
// 112], k = 4 tap + ci, and w2 [27][n0p out][n0p in] bf16; plan
// (tc::BrickPlan, 6 ints) from kernels/vel_head.py:tile_plan. Both: w3
// [n0p][3], bias [3][n0p], bn [6][n0p] float32.
extern "C" int pulpo_vel_head(const void* z, void* out, const void* w1,
                              const void* w2, const void* w3, const void* bias,
                              const void* bn, int B, int S0, int S1, int S2,
                              int zdim, int n0p, int kp1, const int* plan, void* stream) {
  if (zdim < 1 || zdim > MAXZ || B < 1 || S0 < 1 || S1 < 1 || S2 < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float *f3 = (const float*)w3, *fb = (const float*)bias, *fn = (const float*)bn;
  if (plan != nullptr) {
    const tc::BrickPlan p = {plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
    return dispatch_tc(n0p, z, out, w1, w2, f3, fb, fn, B, S0, S1, S2, zdim, kp1, p, s);
  }
  return dispatch_f32(n0p, z, out, (const float*)w1, (const float*)w2, f3, fb, fn, B, S0, S1,
                      S2, zdim, s);
}
