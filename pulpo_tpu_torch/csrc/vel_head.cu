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
// Design: one block of 256 threads per 4 x 8 x 8 output tile.
//   1. The input tile with a 2-voxel halo (8 x 12 x 12 x zdim) is staged
//      in shared memory, zeros outside the volume (conv1's SAME padding).
//   2. conv1 + bias + BN1 + LeakyReLU runs over the tile plus a 1-voxel
//      halo (6 x 10 x 10 positions), into shared memory, channel-major so
//      that neighbouring threads read neighbouring words. Positions
//      outside the volume are stored as ZERO: conv2's SAME padding pads
//      conv1's output, so conv1 must not be evaluated there (the TPU
//      kernel masks its ghost lanes for the same reason).
//   3. conv2 runs one output voxel per thread, all n0 output channels in
//      registers; each tap's n0 x n0 weights are staged in shared memory
//      and read as broadcast float4s. Its epilogue and the 1x1 head
//      follow in registers, and 3 values per voxel are written.
// Accumulation is float32. The head is bound by operations (about 60.7
// kFLOP per voxel at n0 = 32); this first version runs on the CUDA
// cores, not the tensor cores, so it stays far from that bound.
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

namespace {

constexpr int TZ = 4, TY = 8, TX = 8;
constexpr int NT = TZ * TY * TX;                    // 256 threads
constexpr int AZ = TZ + 2, AY = TY + 2, AX = TX + 2;
constexpr int NA = AZ * AY * AX;                    // conv1 positions
constexpr int XZ = TZ + 4, XY = TY + 4, XX = TX + 4;
constexpr int NX = XZ * XY * XX;                    // input positions
constexpr int MAXZ = 4;

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return Cvt<T>::to_f(Cvt<T>::from_f(v));
}

// conv sum -> +bias -> eval BN -> LeakyReLU, as a value of type T
template <typename T>
__device__ __forceinline__ float epilogue(float acc, float b, float mean,
                                          float mul, float add, float c02) {
  const float a = rnd<T>(rnd<T>(acc) + b);
  const float y = __fadd_rn(__fmul_rn(__fsub_rn(a, mean), mul), add);
  const float v = rnd<T>(y);
  return (y < 0.0f) ? rnd<T>(__fmul_rn(c02, v)) : v;
}

template <int N0>
__host__ __device__ constexpr int w_floats() {
  return (27 * MAXZ * N0 > N0 * N0) ? 27 * MAXZ * N0 : N0 * N0;
}

template <typename T, int N0>
constexpr size_t smem_bytes() {
  return sizeof(float) * (MAXZ * NX + w_floats<N0>()) + sizeof(T) * N0 * NA;
}

template <typename T, int N0>
__global__ void __launch_bounds__(NT)
vel_head_kernel(const T* __restrict__ z, T* __restrict__ out,
                const float* __restrict__ w1,    // [27][zdim][N0]
                const float* __restrict__ w2,    // [27][N0 in][N0 out]
                const float* __restrict__ w3,    // [N0][3]
                const float* __restrict__ bias,  // [3][N0]: b1, b2, b3
                const float* __restrict__ bn,    // [6][N0]: mean, mul, add x2
                int S0, int S1, int S2, int zdim, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_x = reinterpret_cast<float*>(smem);          // [MAXZ][NX]
  float* s_w = s_x + MAXZ * NX;                          // w1, then w2[tap]
  T* s_a = reinterpret_cast<T*>(s_w + w_floats<N0>());   // [N0][NA]

  const int tid = threadIdx.x;
  const int tx0 = (blockIdx.x % tiles_x) * TX;
  const int ty0 = (blockIdx.x / tiles_x) * TY;
  const int tz0 = blockIdx.y * TZ;
  const long long plane = (long long)S1 * S2;
  const T* zb = z + (long long)blockIdx.z * S0 * plane * zdim;
  const float c02 = rnd<T>(0.2f);

  // 1. input tile + 2-voxel halo, zero outside the volume
  for (int i = tid; i < zdim * NX; i += NT) {
    const int c = i / NX, p = i - c * NX;
    const int gz = tz0 - 2 + p / (XY * XX);
    const int gy = ty0 - 2 + (p / XX) % XY;
    const int gx = tx0 - 2 + p % XX;
    float v = 0.0f;
    if (gz >= 0 && gz < S0 && gy >= 0 && gy < S1 && gx >= 0 && gx < S2)
      v = Cvt<T>::to_f(zb[((long long)gz * plane + (long long)gy * S2 + gx) * zdim + c]);
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
      for (int co = 0; co < N0; ++co) s_a[co * NA + p] = Cvt<T>::from_f(0.0f);
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
      s_a[co * NA + p] = Cvt<T>::from_f(epilogue<T>(
          acc[co], bias[co], bn[co], bn[N0 + co], bn[2 * N0 + co], c02));
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
      const float a = Cvt<T>::to_f(s_a[ci * NA + ap]);
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
    const float v = epilogue<T>(acc[co], bias[N0 + co], bn[3 * N0 + co],
                                bn[4 * N0 + co], bn[5 * N0 + co], c02);
    o0 = fmaf(v, w3[co * 3 + 0], o0);
    o1 = fmaf(v, w3[co * 3 + 1], o1);
    o2 = fmaf(v, w3[co * 3 + 2], o2);
  }
  const int gz = tz0 + tz, gy = ty0 + ty, gx = tx0 + tx;
  if (gz < S0 && gy < S1 && gx < S2) {
    T* o = out + (((long long)blockIdx.z * S0 + gz) * plane + (long long)gy * S2 + gx) * 3;
    o[0] = Cvt<T>::from_f(rnd<T>(o0) + bias[2 * N0 + 0]);
    o[1] = Cvt<T>::from_f(rnd<T>(o1) + bias[2 * N0 + 1]);
    o[2] = Cvt<T>::from_f(rnd<T>(o2) + bias[2 * N0 + 2]);
  }
}

template <typename T, int N0>
int launch(const void* z, void* out, const float* w1, const float* w2,
           const float* w3, const float* bias, const float* bn, int B,
           int S0, int S1, int S2, int zdim, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, N0>();
  cudaError_t e = cudaFuncSetAttribute(vel_head_kernel<T, N0>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles_x = (S2 + TX - 1) / TX;
  const int tiles_y = (S1 + TY - 1) / TY;
  const dim3 grid(tiles_x * tiles_y, (S0 + TZ - 1) / TZ, B);
  vel_head_kernel<T, N0><<<grid, NT, smem, stream>>>(
      (const T*)z, (T*)out, w1, w2, w3, bias, bn, S0, S1, S2, zdim, tiles_x);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int n0p, const void* z, void* out, const float* w1,
             const float* w2, const float* w3, const float* bias,
             const float* bn, int B, int S0, int S1, int S2, int zdim,
             cudaStream_t s) {
  switch (n0p) {
    case 16: return launch<T, 16>(z, out, w1, w2, w3, bias, bn, B, S0, S1, S2, zdim, s);
    case 32: return launch<T, 32>(z, out, w1, w2, w3, bias, bn, B, S0, S1, S2, zdim, s);
    case 64: return launch<T, 64>(z, out, w1, w2, w3, bias, bn, B, S0, S1, S2, zdim, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int pulpo_vel_head(const void* z, void* out, const void* w1,
                              const void* w2, const void* w3, const void* bias,
                              const void* bn, int B, int S0, int S1, int S2,
                              int zdim, int n0p, int is_bf16, void* stream) {
  if (zdim < 1 || zdim > MAXZ || B < 1 || B > 65535 || S0 < 1 || S1 < 1 || S2 < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float *f1 = (const float*)w1, *f2 = (const float*)w2, *f3 = (const float*)w3;
  const float *fb = (const float*)bias, *fn = (const float*)bn;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(n0p, z, out, f1, f2, f3, fb, fn, B, S0, S1, S2, zdim, s);
  return dispatch<float>(n0p, z, out, f1, f2, f3, fb, fn, B, S0, S1, S2, zdim, s);
}
