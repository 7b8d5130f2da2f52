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
// Design (first version: right and simple):
//   - A block computes BM = 64 consecutive output voxels (flattened over
//     rows and space, so every S2 is taken without waste) x all cout
//     channels (padded to NP, a template width).
//   - K = 27 * cin, ordered (tap, channel) as the wrapper packs the
//     weights: w[n][tap * cin + c], NP x Kp, Kp a multiple of 32, zeros
//     past K and past cout. Each K chunk of the A tile (BM voxels x KC)
//     is gathered from the channels-last input, zeros outside the volume
//     (SAME padding), 16 bytes at a time where cin allows it; the weight
//     chunk (NP x KC) is copied beside it. Both go through registers:
//     the next chunk's loads are issued before the current chunk's
//     products, so they overlap.
//   - bf16: the tensor cores, mma.sync.m16n8k16 bf16 -> f32, each of the
//     4 warps owning 16 voxels x NP channels of f32 accumulators.
//   - f32: the same tiles with CUDA-core FMAs (TF32 would miss a 1e-4 of
//     scale tolerance); each thread owns 4 voxels x NP/8 channels.
//
// Rounding points (pos_head.py:44-50, conv_chain.py:36-39,
// kernels/activations.py): the f32 sum is rounded to T before anything
// is added; y2 then the bias are added in T; BN computes
// (f32(x) - mean) * (rsqrt(var + eps) * scale) + bias in f32 (no FMA
// contraction) and rounds to T; LeakyReLU takes its sign from the f32
// value and multiplies by 0.2 rounded to T. Each head output is summed
// in f32 over the rounded activations, rounded to T, and gets its bias
// in T; softplus = max(x, 0) + log1p(exp(-|x|)) with each
// transcendental computed in f32 and rounded to T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output voxels per block
constexpr int NTHREADS = 128;   // 4 warps
constexpr int MAXZD = 4;
enum Mode { UNIT = 0, UNIT_ADD = 1, UNIT_HEADS = 2 };

template <typename T> struct Ty;
template <> struct Ty<float> {
  using Bits = uint32_t;
  static constexpr int KC = 16;  // K chunk
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};
template <> struct Ty<__nv_bfloat16> {
  using Bits = uint16_t;
  static constexpr int KC = 32;
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) { return __float2bfloat16_rn(v); }
};

template <typename T> __host__ __device__ constexpr int vec() { return 16 / (int)sizeof(T); }   // elements per 16 B
template <typename T> __host__ __device__ constexpr int pitch() { return Ty<T>::KC + vec<T>(); } // smem row, padded

template <typename T>
__device__ __forceinline__ float rnd(float v) { return Ty<T>::to_f(Ty<T>::from_f(v)); }

struct Args {
  const void* x;       // (rows, S0, S1, S2, cin) T, channels-last
  const void* w;       // (NP, kp) T
  const float* bias;   // (NP) values rounded to T
  const float* bn;     // (3, NP): mean, mul, add
  const void* y2;      // UNIT_ADD: (b_pair, S0, S1, S2, cout) T
  const float* wh;     // UNIT_HEADS: (2 zd, NP) values rounded to T
  const float* bh;     // UNIT_HEADS: (2 zd) values rounded to T
  void* out;           // (rows, S0, S1, S2, cout) T, or mu (.., zd)
  void* out2;          // UNIT_HEADS: sigma (.., zd)
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

// 16 bytes of the A tile: elements k .. k + vec - 1 of voxel `p`'s row.
template <typename T>
__device__ __forceinline__ uint4 gather(const Args& a, const Vox& p, int k) {
  using Bits = typename Ty<T>::Bits;
  constexpr int VEC = vec<T>();
  const T* x = static_cast<const T*>(a.x);
  const int K = 27 * a.cin;
  union { uint4 u; Bits e[VEC]; } out;
  out.u = make_uint4(0u, 0u, 0u, 0u);
  if (!p.valid) return out.u;
  if (a.vec_ok) {  // cin % VEC == 0: the 16 bytes are one tap's channels
    if (k >= K) return out.u;
    const int tap = k / a.cin, c = k - tap * a.cin;
    const int zz = p.z + tap / 9 - 1, yy = p.y + (tap / 3) % 3 - 1, xx = p.x + tap % 3 - 1;
    if (zz < 0 || zz >= a.S0 || yy < 0 || yy >= a.S1 || xx < 0 || xx >= a.S2) return out.u;
    const long long off =
        (((long long)p.r * a.S0 + zz) * a.S1 + yy) * (long long)a.S2 + xx;
    return *reinterpret_cast<const uint4*>(x + off * a.cin + c);
  }
  const Bits* xb = reinterpret_cast<const Bits*>(x);
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int ke = k + e;
    if (ke >= K) break;
    const int tap = ke / a.cin, c = ke - tap * a.cin;
    const int zz = p.z + tap / 9 - 1, yy = p.y + (tap / 3) % 3 - 1, xx = p.x + tap % 3 - 1;
    if (zz < 0 || zz >= a.S0 || yy < 0 || yy >= a.S1 || xx < 0 || xx >= a.S2) continue;
    const long long off =
        (((long long)p.r * a.S0 + zz) * a.S1 + yy) * (long long)a.S2 + xx;
    out.e[e] = xb[off * a.cin + c];
  }
  return out.u;
}

// ---- the products of one K chunk -------------------------------------

template <typename T, int NP> struct Mma;

// bf16: warp w owns voxels 16w .. 16w + 15; accumulator j*4 + e holds
// (row g + 8 (e >= 2), column 8j + 2t + (e & 1)), g = lane / 4, t = lane % 4.
template <int NP> struct Mma<__nv_bfloat16, NP> {
  static constexpr int NACC = NP / 8 * 4;
  static __device__ __forceinline__ void compute(const __nv_bfloat16* As,
                                                 const __nv_bfloat16* Bs, float* acc) {
    constexpr int P = pitch<__nv_bfloat16>();
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < Ty<__nv_bfloat16>::KC; ks += 16) {
      const __nv_bfloat16* ar = As + (16 * w + g) * P + ks + 2 * t;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ar);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ar + 8 * P);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ar + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(ar + 8 * P + 8);
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const __nv_bfloat16* br = Bs + (8 * j + g) * P + ks + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(br);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(br + 8);
        float* c = acc + 4 * j;
        asm(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
  static __device__ __forceinline__ void coord(int idx, int& m, int& n) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int j = idx >> 2, e = idx & 3;
    m = 16 * w + (lane >> 2) + ((e >> 1) << 3);
    n = 8 * j + 2 * (lane & 3) + (e & 1);
  }
};

// f32: thread (tm, tn) = (tid / 8, tid % 8) owns voxels tm + 16 i (i < 4)
// and channels tn + 8 j; accumulator i * NP/8 + j.
template <int NP> struct Mma<float, NP> {
  static constexpr int NACC = 4 * (NP / 8);
  static __device__ __forceinline__ void compute(const float* As, const float* Bs, float* acc) {
    constexpr int P = pitch<float>();
    const int tm = threadIdx.x >> 3, tn = threadIdx.x & 7;
#pragma unroll 4
    for (int k = 0; k < Ty<float>::KC; ++k) {
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

// ---- the kernel ------------------------------------------------------

template <typename T, int NP>
constexpr size_t tile_bytes() {
  return (size_t)(BM + NP) * pitch<T>() * sizeof(T);
}
template <int NP>
constexpr size_t heads_bytes() {
  return ((size_t)BM * (NP + 1) + 2 * MAXZD * NP) * sizeof(float);
}

template <typename T>
__device__ __forceinline__ float softplus_t(float h) {
  const float m = h >= 0.0f ? h : 0.0f;
  const float e = rnd<T>(expf(-fabsf(h)));
  const float l = rnd<T>(log1pf(e));
  return rnd<T>(m + l);
}

template <typename T, int NP>
__global__ void __launch_bounds__(NTHREADS)
conv_unit_kernel(const Args a) {
  constexpr int KC = Ty<T>::KC, VEC = vec<T>(), P = pitch<T>();
  constexpr int QPR = KC / VEC;                                // 16 B units per tile row
  constexpr int AU = BM * QPR / NTHREADS;                      // A units per thread (2)
  constexpr int BU = (NP * QPR + NTHREADS - 1) / NTHREADS;     // B units per thread
  using M = Mma<T, NP>;

  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + BM * P;

  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * BM;
  const T* w = static_cast<const T*>(a.w);

  Vox rows[AU];
#pragma unroll
  for (int i = 0; i < AU; ++i) rows[i] = voxel(a, v0 + tid / QPR + i * (NTHREADS / QPR));
  const int q = tid % QPR;

  uint4 ra[AU], rb[BU];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < AU; ++i) ra[i] = gather<T>(a, rows[i], k0 + q * VEC);
#pragma unroll
    for (int i = 0; i < BU; ++i) {
      const int u = tid + i * NTHREADS;
      if (u < NP * QPR)
        rb[i] = *reinterpret_cast<const uint4*>(w + (size_t)(u / QPR) * a.kp + k0 + (u % QPR) * VEC);
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

  // ---- epilogue ----
  const float c02 = rnd<T>(0.2f);
  const T* y2 = static_cast<const T*>(a.y2);
  T* out = static_cast<T*>(a.out);
  float* hs = reinterpret_cast<float*>(smem);  // UNIT_HEADS: [BM][NP + 1]
#pragma unroll
  for (int idx = 0; idx < M::NACC; ++idx) {
    int m, n;
    M::coord(idx, m, n);
    const int v = v0 + m;
    if (n >= a.cout || v >= a.rv) continue;
    float s = rnd<T>(acc[idx]);
    if (a.mode == UNIT_ADD) {
      const int r = v / a.V;
      const long long src = ((long long)(r % a.b_pair) * a.V + (v - r * a.V)) * a.cout + n;
      s = rnd<T>(s + Ty<T>::to_f(y2[src]));
    }
    s = rnd<T>(s + a.bias[n]);
    const float y = __fadd_rn(__fmul_rn(__fsub_rn(s, a.bn[n]), a.bn[NP + n]), a.bn[2 * NP + n]);
    const float o = rnd<T>(y);
    const float act = (y < 0.0f) ? rnd<T>(__fmul_rn(c02, o)) : o;
    if (a.mode == UNIT_HEADS)
      hs[m * (NP + 1) + n] = act;
    else
      out[(long long)v * a.cout + n] = Ty<T>::from_f(act);
  }
  if (a.mode != UNIT_HEADS) return;

  // 1x1 heads over each voxel's activations, staged in shared memory
  float* ws = hs + BM * (NP + 1);
  const int nh = 2 * a.zd;
  for (int i = tid; i < nh * NP; i += NTHREADS) ws[i] = a.wh[i];
  __syncthreads();
  T* out2 = static_cast<T*>(a.out2);
  for (int task = tid; task < BM * nh; task += NTHREADS) {
    const int m = task / nh, j = task - m * nh;
    const int v = v0 + m;
    if (v >= a.rv) continue;
    const float* hr = hs + m * (NP + 1);
    const float* wr = ws + j * NP;
    float h = 0.0f;
    for (int n = 0; n < a.cout; ++n) h = fmaf(hr[n], wr[n], h);
    h = rnd<T>(rnd<T>(h) + a.bh[j]);
    if (j < a.zd)
      out[(long long)v * a.zd + j] = Ty<T>::from_f(h);
    else
      out2[(long long)v * a.zd + (j - a.zd)] = Ty<T>::from_f(softplus_t<T>(h));
  }
}

template <typename T, int NP>
int launch(const Args& a, cudaStream_t stream) {
  const size_t most = tile_bytes<T, NP>() > heads_bytes<NP>() ? tile_bytes<T, NP>()
                                                              : heads_bytes<NP>();
  const size_t smem = a.mode == UNIT_HEADS ? most : tile_bytes<T, NP>();
  cudaError_t e = cudaFuncSetAttribute(conv_unit_kernel<T, NP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((a.rv + BM - 1) / BM);
  conv_unit_kernel<T, NP><<<blocks, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int np, const Args& a, cudaStream_t s) {
  switch (np) {
    case 16: return launch<T, 16>(a, s);
    case 32: return launch<T, 32>(a, s);
    case 64: return launch<T, 64>(a, s);
    case 96: return launch<T, 96>(a, s);
    case 128: return launch<T, 128>(a, s);
    case 192: return launch<T, 192>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int pulpo_conv_unit(const void* x, const void* w, const void* bias, const void* bn,
                               const void* y2, const void* wh, const void* bh, void* out,
                               void* out2, int rows, int S0, int S1, int S2, int cin, int cout,
                               int np, int kp, int b_pair, int mode, int zd, int is_bf16,
                               void* stream) {
  const long long V = (long long)S0 * S1 * S2;
  if (rows < 1 || S0 < 1 || S1 < 1 || S2 < 1 || cin < 1 || cout < 1 || cout > np ||
      (long long)rows * V >= (1LL << 31) || kp % 32 != 0 || kp < 27 * cin ||
      mode < UNIT || mode > UNIT_HEADS ||
      (mode == UNIT_ADD && (b_pair < 1 || rows % b_pair != 0)) ||
      (mode == UNIT_HEADS && (zd < 1 || zd > MAXZD)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x; a.w = w; a.bias = (const float*)bias; a.bn = (const float*)bn; a.y2 = y2;
  a.wh = (const float*)wh; a.bh = (const float*)bh; a.out = out; a.out2 = out2;
  a.S0 = S0; a.S1 = S1; a.S2 = S2; a.V = (int)V; a.cin = cin; a.cout = cout; a.kp = kp;
  a.b_pair = b_pair < 1 ? 1 : b_pair; a.mode = mode; a.zd = zd;
  a.vec_ok = cin % (is_bf16 ? 8 : 4) == 0;
  a.rv = (int)(rows * V);
  const cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16>(np, a, s) : dispatch<float>(np, a, s);
}
