// Narrow-input SAME 3x3x3 conv (stride 1, no bias) for Hopper (sm_90a):
//   out[b, p, co] = round_to_T( sum_{tap, ci} x[b, p + tap - 1, ci] * w[tap, ci, co] )
// channels-last x (B, S0, S1, S2, cin), cin <= 4, bf16 or f32; out
// (B, S0, S1, S2, cout) in x's type; the sum in f32, rounded once.
//
// Replaces pulpo_tpu/attic/conv_narrow.py:conv3d_narrow_mxu (an im2col
// of the 27 * cin taps into VMEM and one MXU contraction per z-slice,
// f32 accumulation). With cin <= 4 a tap-block has at most 108 rows
// against the TPU's 128-wide MXU; the same holds for Hopper's tensor
// cores (a K of 27 * cin, padded, per 32 output channels), so this
// first version computes on the CUDA cores; the tensor cores are later work.
//
// Design: one block of 128 threads per (row, 4 x 4 x 32 output voxels).
// The input tile with its one-voxel halo (6 x 6 x 34 x cin, zero outside
// the volume: SAME padding) is staged once in shared memory as float,
// channel-major so that the 32 lanes of a warp read 32 consecutive x.
// Each thread owns one (y, x) column and 4 z voxels; for each chunk of 8
// output channels it stages the chunk's 27 * cin * 8 weights in shared
// memory (every lane reads the same weight: a broadcast) and keeps
// 4 x 8 f32 accumulators in registers. The (kz, ky) loops stay rolled and
// the block asks for 4 resident blocks an SM (at most 128 registers a
// thread): unrolled, the compiler hoisted every tap's weights and spilled.
//
// Bound: for bf16 the output bytes (cout / cin times the input's), far
// below the operations at bf16 rate; on the CUDA cores the 27 * cin *
// cout multiply-adds per voxel (23.8 GFLOP at 2 -> 32 on 160x192x224)
// take at least 0.36 ms at 67 TFLOP/s, above the 0.14 ms of bytes. The
// output is written 16 or 32 bytes per thread and channel chunk.
//
// Numerics: the taps are summed in the order (kz, ky, kx, ci), each
// product added to an f32 accumulator that starts at 0, as the plain
// PyTorch version (kernels/conv_narrow.py) does. For f32 the product
// and the sum round separately (__fmul_rn, __fadd_rn; the file is also
// built with -fmad=false). For bf16 the product of two bf16 values is
// exact in f32 (8 + 8 significant bits), so a fused multiply-add rounds
// as the separate product and sum do, at half the instructions. So
// the kernel is bit-equal to the plain version in both types.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;           // output x per block (one warp)
constexpr int TY = 4;            // output y per block (one per warp)
constexpr int VZ = 4;            // output z per thread
constexpr int CO = 8;            // output channels per register chunk
constexpr int HX = TX + 2, HY = TY + 2, HZ = VZ + 2;
constexpr int THREADS = TX * TY;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ float mac(float acc, float x, float w);
template <>
__device__ __forceinline__ float mac<float>(float acc, float x, float w) {
  return __fadd_rn(acc, __fmul_rn(x, w));
}
template <>
__device__ __forceinline__ float mac<__nv_bfloat16>(float acc, float x, float w) {
  return __fmaf_rn(x, w, acc);  // exact product: rounds as mul then add
}

// Store CO consecutive channels starting at o (aligned when `vec`).
__device__ __forceinline__ void store_chunk(float* o, const float* v, int n, bool vec) {
  if (vec) {
    reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    for (int c = 0; c < n; ++c) o[c] = v[c];
  }
}
__device__ __forceinline__ void store_chunk(__nv_bfloat16* o, const float* v, int n, bool vec) {
  if (vec) {
    auto pack = [&](int c) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * c], v[2 * c + 1]);
      return *reinterpret_cast<const unsigned*>(&h);
    };
    *reinterpret_cast<uint4*>(o) = make_uint4(pack(0), pack(1), pack(2), pack(3));
  } else {
    for (int c = 0; c < n; ++c) o[c] = __float2bfloat16_rn(v[c]);
  }
}

template <typename T, int CIN>
__global__ void __launch_bounds__(THREADS, 4)
conv_narrow_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   T* __restrict__ out, int S0, int S1, int S2, int cout,
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
  const T* xb = x + b * n * CIN;

  for (int i = tid; i < HZ * HY * HX; i += THREADS) {
    const int hx = i % HX, hy = (i / HX) % HY, hz = i / (HX * HY);
    const int gx = x0 + hx - 1, gy = y0 + hy - 1, gz = z0 + hz - 1;
    const bool in = gx >= 0 && gx < S2 && gy >= 0 && gy < S1 && gz >= 0 && gz < S0;
    const long long off = in ? (((long long)gz * S1 + gy) * S2 + gx) * CIN : 0;
#pragma unroll
    for (int ci = 0; ci < CIN; ++ci) xs[ci][hz][hy][hx] = in ? to_f(xb[off + ci]) : 0.0f;
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
              for (int co = 0; co < CO; ++co) acc[vz][co] = mac<T>(acc[vz][co], xv, wv[co]);
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
          T* o = out + (b * n + ((long long)gz * S1 + gy) * S2 + gx) * cout + c0;
          store_chunk(o, acc[vz], nc, vec);
        }
      }
    }
  }
}

template <typename T, int CIN>
int launch_t(const void* x, const void* w, void* out, int B, int S0, int S1, int S2,
             int cout, void* stream) {
  const int tiles_x = (S2 + TX - 1) / TX, tiles_y = (S1 + TY - 1) / TY,
            tiles_z = (S0 + VZ - 1) / VZ;
  const long long blocks = (long long)B * tiles_x * tiles_y * tiles_z;
  if (blocks == 0 || cout == 0) return 0;
  conv_narrow_kernel<T, CIN><<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)w, (T*)out, S0, S1, S2, cout, tiles_x, tiles_y, tiles_z);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, void* out, int B, int cin, int S0, int S1,
           int S2, int cout, void* stream) {
  switch (cin) {
    case 1: return launch_t<T, 1>(x, w, out, B, S0, S1, S2, cout, stream);
    case 2: return launch_t<T, 2>(x, w, out, B, S0, S1, S2, cout, stream);
    case 3: return launch_t<T, 3>(x, w, out, B, S0, S1, S2, cout, stream);
    case 4: return launch_t<T, 4>(x, w, out, B, S0, S1, S2, cout, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, S0, S1, S2, cin) bf16 (bf16 = 1) or f32; w (27, cin, cout) f32,
// tap-major (kz, ky, kx); out (B, S0, S1, S2, cout) in x's type.
extern "C" int pulpo_conv_narrow(const void* x, const void* w, void* out, int bf16,
                                 int B, int cin, int S0, int S1, int S2, int cout,
                                 void* stream) {
  return bf16 ? launch<__nv_bfloat16>(x, w, out, B, cin, S0, S1, S2, cout, stream)
              : launch<float>(x, w, out, B, cin, S0, S1, S2, cout, stream);
}
