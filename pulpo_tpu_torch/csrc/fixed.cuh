// Order-free accumulation of a scatter's float32 terms, for Hopper
// (sm_90a): the header shared by the moving-cotangent (#7,
// csrc/warp_bwd.cu) and the squaring step's backward (#2,
// csrc/squaring_bwd.cu).
//
// A float32 atomicAdd sums in the order the adds land, which changes from
// run to run: a scatter built on it is not a function of its inputs. Here
// each term is quantized to a 64-bit fixed-point integer at a scale 2^k
// fixed for the launch, the integers are summed (merged in registers, by
// shuffles and through shared memory, then added with 64-bit integer
// atomics into a zeroed buffer: an integer sum does not depend on the
// order of its adds), and a last pass converts each target back to
// float32. A launch runs
// 1. `begin`: zeroes the int64 buffer (its n targets and a header slot
//    after them) and writes the largest |g| of the launch's cotangent into
//    the header, as the bits of a non-negative float (`max_abs_bits`: an
//    integer atomicMax on them; a max does not depend on order);
// 2. the scatter kernel, whose threads read the header and take the
//    scale (`scale_of`): k = 62 - clog - e, where the whole output holds
//    count <= 2^clog source (row, voxel) pairs and max|g| < 2^e (frexp's
//    e). Each term t = w * g (|w| <= 1, formed in float32) is then
//    round-to-nearest-even(t * 2^k) (`quantize`: the product is exact in
//    double), and no target's sum can reach 2^62 (2^63 is the limit),
//    whatever its fan-in. A slab launch takes count of the whole output,
//    so that its terms are quantized as the whole launch's at the same
//    max;
// 3. `finish`: each target's integer times 2^-k (exact in double), plus,
//    in the targets a caller marks, the float32 already in `out` (the
//    squaring backward's own terms), rounded to float32 once.
// No host sync: the scale lives on the device, so a CUDA graph replays
// the launch. The squaring backward's entry runs the three steps apart on
// request (its phase mask), so that a depth-sharded step puts the
// column's max into the header and adds the other ranks' sums of its
// slab's planes into the targets between them (kernels/squaring.py:
// squaring_step_bwd's `column`). A zero max gives zeros; a non-finite max (a NaN or Inf in
// g) adds nothing and makes every target NaN. The plain versions
// (kernels/warp.py:warp_mgrad_plain, fixed_scale) quantize, sum and
// convert the same way, so the kernels are bit-equal to them. Terms are
// resolved to 2^-k, about 2^-(62 - clog) of max|g|: 2^-39 at the
// full-res C = 1 shape, far below float32's rounding of the output.
//
// The march both scatter kernels walk (March): a block of tx x ty
// threads, one source column each (kernels/gather.py:squaring_bwd_plan,
// read by tile_of), walks a chunk of tz planes along z;
// each source voxel has 8 corner cells (bit 0 of a corner picks the upper
// z, bit 1 the upper y, bit 2 the upper x) and CB quantized terms at
// each. A thread keeps its upper-z corners' terms until the next plane,
// whose lower-z corners are the same cells where the field is smooth
// (the floor of the z source coordinate moves by one), and adds them
// there; a lane takes the next lane's lower-x corners' terms where they
// are its upper-x corners' cells (the next voxel of the line), by
// shuffles; a thread takes the next line's lower-y corners' terms where
// they are its upper-y corners' cells, through shared memory (Lines, two
// barriers a plane); what remains goes to the buffer with one 64-bit
// atomic (RED) a term, zeros skipped. In a smooth field a voxel then
// sends one to two cells' terms instead of eight. The adds into shared
// memory are plain stores and loads: sm_90 has a native 32-bit integer
// shared-memory atomic add but a compare-and-swap loop for the 64-bit one
// (ATOMS.CAST.SPIN.64 in the SASS).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gather.cuh"

namespace fixed {

constexpr int THREADS = 256;         // threads a block of the max and convert passes
constexpr int MAX_BLOCKS = 1056;     // blocks of the max pass, at most (one atomic each)
constexpr int CONVERT_BLOCKS = 1 << 20;  // of the convert pass: a thread a target

// ceil(log2(n)) for n >= 1 (0 for n <= 1).
inline int ceil_log2(long long n) {
  int c = 0;
  while (c < 62 && (1LL << c) < n) ++c;
  return c;
}

// frexp's exponent e of the positive finite float whose bits these are:
// x = m * 2^e with m in [0.5, 1), so x < 2^e.
__device__ __forceinline__ int exponent_of(unsigned bits) {
  const int biased = (int)(bits >> 23);
  return biased ? biased - 126 : (32 - __clz((int)bits)) - 149;
}

__device__ __forceinline__ double pow2(int k) {
  return __longlong_as_double((long long)(1023 + k) << 52);
}

// The launch's scale from the header's max |g| bits: up = 2^k and down =
// 2^-k; false where nothing is to be added (a zero or non-finite max).
__device__ __forceinline__ bool scale_of(unsigned bits, int clog, double* up, double* down) {
  if (bits == 0u || bits >= 0x7f800000u) return false;
  const int k = 62 - clog - exponent_of(bits);
  *up = pow2(k);
  *down = pow2(-k);
  return true;
}

__device__ __forceinline__ long long quantize(float t, double up) {
  return __double2ll_rn((double)t * up);
}

// Adds one term to a target; nothing for a zero (a term merged into
// another, or no term). Two's complement: the unsigned add is the signed.
__device__ __forceinline__ void add(unsigned long long* p, long long v) {
  if (v != 0) atomicAdd(p, (unsigned long long)v);
}

__device__ __forceinline__ unsigned abs_bits(float x) { return __float_as_uint(x) & 0x7fffffffu; }

__device__ __forceinline__ unsigned abs_bits(float4 q) {
  return max(max(abs_bits(q.x), abs_bits(q.y)), max(abs_bits(q.z), abs_bits(q.w)));
}

// The largest |g| of n floats into *top: 16-byte loads, four in flight a
// thread, where g is 16-byte aligned; one atomic a block.
__global__ void __launch_bounds__(THREADS)
max_abs_bits(const float* __restrict__ g, long long n, unsigned* __restrict__ top) {
  __shared__ unsigned warps[THREADS / 32];
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = gather::aligned16(g) ? n / 4 : 0;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  unsigned m = 0u;
  long long i = first;
  for (; i + 3 * stride < n4; i += 4 * stride) {
    const float4 a = __ldcs(g4 + i), b = __ldcs(g4 + i + stride);
    const float4 c = __ldcs(g4 + i + 2 * stride), d = __ldcs(g4 + i + 3 * stride);
    m = max(m, max(max(abs_bits(a), abs_bits(b)), max(abs_bits(c), abs_bits(d))));
  }
  for (; i < n4; i += stride) m = max(m, abs_bits(__ldcs(g4 + i)));
  for (long long j = 4 * n4 + first; j < n; j += stride) m = max(m, abs_bits(__ldcs(g + j)));
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = __reduce_max_sync(0xffffffffu, threadIdx.x < THREADS / 32 ? warps[threadIdx.x] : 0u);
    if (threadIdx.x == 0 && m != 0u) atomicMax(top, m);  // one a block
  }
}

// out[i] = the float32 rounding of acc[i] * 2^-k (+ out[i] where i % row
// lies in [lo, hi), added in double before that one rounding); NaN
// everywhere after a non-finite max, 0 (+ out[i]) after a zero one.
__global__ void __launch_bounds__(THREADS)
convert(const long long* __restrict__ acc, float* __restrict__ out, long long n,
        const unsigned* __restrict__ top, int clog, long long row, long long lo,
        long long hi) {
  const unsigned bits = *top;
  double up = 0.0, down = 0.0;
  const bool scaled = scale_of(bits, clog, &up, &down);
  const bool nan = bits >= 0x7f800000u;
  const bool all = lo <= 0 && hi >= row, some = hi > lo && !all;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    double v = scaled ? __ll2double_rn(acc[i]) * down : 0.0;
    bool own = all;
    if (some) {
      const long long o = i % row;
      own = o >= lo && o < hi;
    }
    if (own) v = (double)out[i] + v;
    out[i] = nan ? __int_as_float(0x7fc00000) : __double2float_rn(v);
  }
}

// Blocks of a pass over n items, at most `most` (a grid-stride loop
// takes the rest).
inline unsigned blocks_for(long long n, long long most) {
  const long long b = (n + THREADS - 1) / THREADS;
  return (unsigned)(b < 1 ? 1 : (b > most ? most : b));
}

// The header slot after a buffer of n targets.
inline unsigned* header(void* acc, long long n) {
  return reinterpret_cast<unsigned*>(reinterpret_cast<unsigned long long*>(acc) + n);
}

// Zero the buffer of n targets and its header, then the max |g| of the
// gn floats of g into the header.
inline cudaError_t begin(void* acc, long long n, const float* g, long long gn, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)(n + 1) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return err;
  if (gn > 0) max_abs_bits<<<blocks_for((gn + 15) / 16, MAX_BLOCKS), THREADS, 0, s>>>(g, gn, header(acc, n));
  return cudaGetLastError();
}

// The n targets to float32 `out` (rows of `row` floats whose [lo, hi)
// already hold float32 terms to add).
inline cudaError_t finish(const void* acc, float* out, long long n, int clog, long long row,
                          long long lo, long long hi, cudaStream_t s) {
  convert<<<blocks_for(n, CONVERT_BLOCKS), THREADS, 0, s>>>(reinterpret_cast<const long long*>(acc), out, n,
                                            header(const_cast<void*>(acc), n), clog, row, lo,
                                            hi);
  return cudaGetLastError();
}

// Whether plan p (kernels/gather.py:squaring_bwd_plan) marches `rows`
// rows of S0 x S1 x S2 source voxels: blocks of tx x ty threads (at most
// gather::THREADS), tiles covering each plane, chunks of tz planes
// covering z, within the launch limits, the slab inside the whole output,
// and a row's `row_elements` addressable in 32 bits.
inline bool valid_march(const gather::Plan& p, int rows, int S0, int S1, int S2,
                        long long row_elements) {
  if (!gather::valid_slab(p, S0)) return false;
  if (p.v != 1 || p.ch != 0 || p.tx < 1 || p.ty < 1 || p.tz < 1 || p.log_strips < 0 ||
      p.log_strips > 20 || p.tiles_y < 1 || p.tiles_z < 1 || p.groups != 1 || p.rows != 1)
    return false;
  const long long strips = 1LL << p.log_strips;
  return (long long)p.tx * p.ty <= gather::THREADS && p.tx * strips >= S2 &&
         (long long)p.ty * p.tiles_y >= S1 && (long long)p.tz * p.tiles_z >= S0 &&
         p.tiles_y * strips < (1LL << 31) && p.tiles_z <= 65535 && rows >= 1 &&
         rows <= 65535 && row_elements < (1LL << 31);
}

inline dim3 march_grid(const gather::Plan& p, int rows) {
  return dim3((unsigned)p.tiles_y << p.log_strips, p.tiles_z, rows);
}

// The c-th lower-y corner (0, 1, 4, 5); + 2 is its upper-y twin.
__host__ __device__ constexpr int lower_y(int c) { return (c & 1) | ((c & 2) << 1); }

// The march's exchange between the lines of a tile (shared memory, one
// a block): each thread's lower corner (and upper y) and its lower-y
// corners' terms, structure of arrays (a warp's accesses contiguous).
template <int CB>
struct Lines {
  int key[4][gather::THREADS];
  long long terms[4 * CB][gather::THREADS];
};

// One thread's state in the march: its place in the block, and the
// upper-z corners' terms held from the previous plane (y, x bits of the
// corner), their plane and lower y and x (hz < 0: none held).
template <int CB>
struct March {
  int tid, line, lines, stride;  // thread, its line of the tile, the tile's lines, threads a line
  int lane;                      // lane in the warp
  unsigned mask;                 // the warp's threads
  bool right;                    // the next lane holds the next voxel of this line
  long long held[4][CB];
  int hz = -1, hy = 0, hx = 0;

  // a tile of tx x ty threads, this one at (threadIdx.x, threadIdx.y)
  __device__ __forceinline__ March(int tx, int ty) {
    const int n = tx * ty;
    tid = threadIdx.y * tx + threadIdx.x;
    line = threadIdx.y;
    lines = ty;
    stride = tx;
    lane = tid & 31;
    const int lanes = min(32, n - (tid - lane));  // threads of this warp
    mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
    right = lane + 1 < lanes && threadIdx.x + 1 < tx;
  }

  // whether a voxel with lower corner i0 has the held cells as its
  // lower-z corners
  __device__ __forceinline__ bool continues(const int (&i0)[3]) const {
    return hz >= 0 && i0[0] == hz && i0[1] == hy && i0[2] == hx;
  }

  // One plane: `val` the 8 corners' terms of this thread's voxel (`have`;
  // zeros otherwise), its corners i0 / i1 in a source volume of size S.
  // Merges the held terms (z), the next lane's (x) and the next line's (y,
  // through `sh`), sends the lower-z corners through send(z, y, x, terms)
  // and holds the upper-z ones. Every thread of the block calls it at
  // every plane and once after the last (have = false): the shuffles
  // need the whole warp, the line exchange the whole block.
  template <class Send>
  __device__ __forceinline__ void plane(bool have, const int (&i0)[3], const int (&i1)[3],
                                        long long (&val)[8][CB], const int (&S)[3],
                                        Lines<CB>& sh, Send&& send) {
    if (hz >= 0) {
      if (have && continues(i0)) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int j = 0; j < CB; ++j) val[2 * k][j] += held[k][j];
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          send(hz, k & 1 ? min(hy + 1, S[1] - 1) : hy, k & 2 ? min(hx + 1, S[2] - 1) : hx,
               held[k]);
      }
      hz = -1;
    }
    // x: the next lane's lower-x corners (0..3) join this lane's upper-x
    // ones (4..7) where they are the same cells
    const int key = have ? i0[0] * S[1] + i0[1] : -1;
    const int key_r = __shfl_down_sync(mask, key, 1);
    const int x0_r = __shfl_down_sync(mask, i0[2], 1);
    const bool take = have && right && key_r == key && x0_r == i1[2];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < CB; ++j) {
        const long long r = __shfl_down_sync(mask, val[k][j], 1);
        if (take) val[4 + k][j] += r;
      }
    if (__shfl_up_sync(mask, (int)take, 1) && lane > 0)
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < CB; ++j) val[k][j] = 0;
    // y: the next line's lower-y corners (0, 1, 4, 5) join this thread's
    // upper-y ones (2, 3, 6, 7) where they are the same cells
    sh.key[0][tid] = have ? i0[0] : -1;
    sh.key[1][tid] = i0[1];
    sh.key[2][tid] = i0[2];
    sh.key[3][tid] = i1[1];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int j = 0; j < CB; ++j) sh.terms[c * CB + j][tid] = val[lower_y(c)][j];
    __syncthreads();
    const int up = tid + stride, down = tid - stride;
    if (have && line + 1 < lines && sh.key[0][up] == i0[0] && sh.key[1][up] == i1[1] &&
        sh.key[2][up] == i0[2]) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int j = 0; j < CB; ++j) val[lower_y(c) + 2][j] += sh.terms[c * CB + j][up];
    }
    // given to the line below where it takes them (its test, seen from here)
    const bool given = have && line > 0 && sh.key[0][down] == i0[0] &&
                       sh.key[3][down] == i0[1] && sh.key[2][down] == i0[2];
    __syncthreads();
    if (given)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int j = 0; j < CB; ++j) val[lower_y(c)][j] = 0;
    if (have) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        send(i0[0], k & 1 ? i1[1] : i0[1], k & 2 ? i1[2] : i0[2], val[2 * k]);
#pragma unroll
        for (int j = 0; j < CB; ++j) held[k][j] = val[2 * k + 1][j];
      }
      hz = i1[0];
      hy = i0[1];
      hx = i0[2];
    }
  }
};

}  // namespace fixed
