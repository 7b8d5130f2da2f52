// Shared pieces of the two gather kernels, csrc/warp.cu and
// csrc/squaring.cu: the source coordinate of the reference
// SpatialTransformer, the walk over a voxel's 2^ND corners, the tile
// plan with its block decode, and the quad loads and stores. The
// squaring step's backward, csrc/squaring_bwd.cu, takes the same plan
// and block decode, its tz being the planes a block marches.
//
// The tile plan is computed on the host by kernels/gather.py:make_plan
// (channel_plan for a channel body) and passed to the C entry points as
// 10 ints (Plan); the kernels walk exactly that plan, and the entry
// points refuse one that does not cover the output or breaks a launch
// limit (valid). A block takes a
// tile of one row's output: tz planes x ty lines x W = tx * V voxels
// along the innermost axis, one thread (threadIdx = (i, ly, lz)) per
// V neighbouring voxels. Tiles along x come in a power-of-two count, so
// blockIdx.x = strip + (y tile << log_strips) decodes by shift and mask;
// blockIdx.y is the z tile; blockIdx.z the row (or, in the warp, the
// moving row and a group of df rows: the block's one 32-bit divide).
// Offsets inside a row are 32-bit (valid refuses a row of 2^31
// elements); each row's base is one 64-bit product per block.
//
// V is 1, a thread's own voxel computed from registers, but in a large
// channels-first warp (the plan's choice, kernels/gather.py), where it
// is 4: each thread then moves its quad between device memory and a
// plane of the tile in shared memory with one 16-byte access per
// channel plane, where the quad is whole and its address 16-byte
// aligned (a ragged or misaligned quad goes one voxel at a time); the
// gathers then run on the interleaved voxels x0 + i + tx * j (j < V),
// so the 32 threads of a warp read 32 neighbouring voxels at each
// corner, as with one voxel a thread. A voxel's arithmetic is the same
// at either V.
//
// A channels-last warp of more than 4 channels takes a channel body
// instead (the plan's ch, 4 or 1; 0 in every other plan): there the
// threads run across channels. A voxel's C channels are K = C / ch
// chunks of ch channels (a 16-byte quad, or one channel where C % 4 != 0
// or a pointer is not 16-byte aligned), taken by L = lanes(C, ch)
// neighbouring threads (lane l takes chunks l, l + L, ...). A block
// then takes tx neighbouring voxels of a line (tx * L threads: the
// flattening of (voxel, chunk) in memory order, so a warp's accesses
// are contiguous) and walks ty lines and tz planes of its tile in turn;
// the tile decode is the same.
//
// A slab launch (the depth-sharded model, parallel/spatial.py) computes
// planes z0 .. z0 + Z - 1 of an output whose whole depth is zg: the
// plan's z0 and zg. Its threads walk the slab's Z planes as above, and the
// source coordinate of a voxel of local plane z takes its global grid index
// z + z0, with the axis-0 factor S_in / (zg - 1) passed in by the host, so
// that a slab launch is bit-equal to the matching planes of the whole
// launch. A whole launch has z0 = 0 and zg = Z. The slab runs along the
// field's first spatial axis: in a 2D launch (Z = 1) that is the tile's y
// (the slice's H), so there z0 and zg are the slab's first line and the
// whole output's lines, a local line y taking its global index y + z0 (a
// whole 2D launch: z0 = 0, zg = Y). slab_axis() names the axis.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gather {

constexpr int THREADS = 256;  // threads a block, at most

struct Plan {
  int tx, ty, tz;        // block shape: threads along x (v voxels each), lines, planes
  int log_strips;        // tiles along x: 1 << log_strips
  int tiles_y, tiles_z;  // tiles along y and z
  int groups, rows;      // df row groups per moving row, df rows a group
  int v;                 // voxels a thread along x: 4 or 1
  int ch;                // channels a chunk of a channel body: 4 or 1; 0: a voxel body
  int z0, zg;            // the slab's first plane in the whole output, the whole depth
};

constexpr int PLAN_INTS = 12;

inline Plan read_plan(const int* q) {
  return Plan{q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], q[9], q[10], q[11]};
}

// The extent of a launch's slab axis (gather::Plan's z0, zg): its planes
// Z in 3D, its lines Y in 2D.
template <int ND>
__host__ __device__ constexpr int slab_axis(int Y, int Z) {
  return ND == 3 ? Z : Y;
}

// Whether the plan's slab of E planes (2D: lines; slab_axis) lies in its
// whole output of zg.
inline bool valid_slab(const Plan& p, int E) {
  return p.z0 >= 0 && p.zg >= 1 && (long long)p.z0 + E <= p.zg;
}

// A voxel's global (z, y) grid indices from its local ones in a slab
// launch of ND spatial axes: the slab's offset on the first axis.
template <int ND>
__device__ __forceinline__ void global_zy(const Plan& p, int z, int y, int& zg, int& yg) {
  zg = ND == 3 ? z + p.z0 : z;
  yg = ND == 3 ? y : y + p.z0;
}

// Threads a voxel in a channel body: one a chunk, at most a warp's.
__host__ __device__ inline int lanes(int C, int ch) {
  const int k = C / ch;
  return k < 32 ? k : 32;
}

// Whether plan p tiles an output of Z x Y x X voxels a row whose
// `movings` moving rows are each read by `rows_per_moving` df rows (the
// squaring step: one each), within the launch limits: a block of at
// most THREADS threads, gridDim.y and gridDim.z at most 65535, every
// row group non-empty, and a row's `row_elements` addressable in 32 bits.
// A channel body (ch 4 or 1, one voxel a thread-group) needs the `C`
// channels of the warp, a multiple of ch; a caller without channels
// (C = 0) takes no channel plan.
inline bool valid(const Plan& p, int X, int Y, int Z, int rows_per_moving, int movings,
                  long long row_elements, int C = 0) {
  if ((p.v != 1 && p.v != 4) || p.tx < 1 || p.ty < 1 || p.tz < 1 || p.log_strips < 0 ||
      p.log_strips > 20 || p.rows < 1 || p.tiles_y < 1 || p.tiles_z < 1)
    return false;
  long long threads = (long long)p.tx * p.ty * p.tz;
  if (p.ch != 0) {
    if (C < 1 || (p.ch != 4 && p.ch != 1) || C % p.ch != 0 || p.v != 1) return false;
    threads = (long long)p.tx * lanes(C, p.ch);
  }
  const long long strips = 1LL << p.log_strips;
  return threads <= THREADS && (long long)p.tx * p.v * strips >= X &&
         (long long)p.ty * p.tiles_y >= Y && (long long)p.tz * p.tiles_z >= Z &&
         p.groups == (rows_per_moving + p.rows - 1) / p.rows &&
         (long long)p.tiles_y * strips < (1LL << 31) && p.tiles_z <= 65535 &&
         (long long)movings * p.groups <= 65535 && row_elements < (1LL << 31);
}

inline dim3 grid(const Plan& p, int movings) {
  return dim3((unsigned)p.tiles_y << p.log_strips, p.tiles_z, movings * p.groups);
}

inline dim3 block(const Plan& p) { return dim3(p.tx, p.ty, p.tz); }

// The origin (voxels) of the block's tile.
struct Tile {
  int x0, y0, z0;
};

template <int V>
__device__ __forceinline__ Tile tile_of(const Plan& p) {
  const int bx = blockIdx.x;
  Tile t;
  t.x0 = (bx & ((1 << p.log_strips) - 1)) * p.tx * V;
  t.y0 = (bx >> p.log_strips) * p.ty;
  t.z0 = blockIdx.y * p.tz;
  return t;
}

// The reference SpatialTransformer's source coordinate along one axis:
// clamp((g + d) * f - 0.5, 0, S_in - 1), f = S_in / (S_out - 1) rounded to
// float32 (grid_sample, border padding, align_corners=False).
__device__ __forceinline__ float src_coord(int g, float d, float f, int s_in) {
  float loc = (float)g + d;
  float src = loc * f - 0.5f;
  return fminf(fmaxf(src, 0.0f), (float)(s_in - 1));
}

// A voxel's corners along each axis: lower index i0, upper i1 =
// min(i0 + 1, S - 1), and the upper corner's weight w = c - floor(c).
template <int ND>
struct Corners {
  int i0[ND], i1[ND];
  float w[ND];
};

template <int ND>
__device__ __forceinline__ Corners<ND> corners(const float (&c)[ND], const int (&s)[ND]) {
  Corners<ND> k;
#pragma unroll
  for (int a = 0; a < ND; ++a) {
    const float fl = floorf(c[a]);
    k.i0[a] = (int)fl;
    k.i1[a] = min(k.i0[a] + 1, s[a] - 1);
    k.w[a] = c[a] - fl;
  }
  return k;
}

// Corner `corner` (bit a picks the upper neighbour along axis a): its
// offset sum_a index_a * stride_a and its weight, the axes' factors
// multiplied in axis order (pulpo_tpu/ops/warp.py:warp_image).
template <int ND>
__device__ __forceinline__ int corner_offset(const Corners<ND>& k, int corner,
                                             const int (&stride)[ND]) {
  int off = 0;
#pragma unroll
  for (int a = 0; a < ND; ++a) off += (((corner >> a) & 1) ? k.i1[a] : k.i0[a]) * stride[a];
  return off;
}

template <int ND>
__device__ __forceinline__ float corner_weight(const Corners<ND>& k, int corner) {
  float weight = 1.0f;
#pragma unroll
  for (int a = 0; a < ND; ++a) {
    const float wa = ((corner >> a) & 1) ? k.w[a] : 1.0f - k.w[a];
    weight = (a == 0) ? wa : weight * wa;
  }
  return weight;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// V floats of a plane from p, of which the first `valid` lie in the
// line (the rest read as 0), evict-first: one 16-byte load where the
// quad is whole and aligned.
template <int V>
__device__ __forceinline__ void load_plane(const float* p, int valid, float (&q)[V]) {
  if constexpr (V == 4) {
    if (valid == V && aligned16(p)) {
      const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
      q[0] = t.x;
      q[1] = t.y;
      q[2] = t.z;
      q[3] = t.w;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) q[j] = j < valid ? __ldcs(p + j) : 0.0f;
}

// The first `valid` of V floats to a plane at p, evict-first: one
// 16-byte store where the quad is whole and aligned.
template <int V>
__device__ __forceinline__ void store_plane(float* p, int valid, const float (&q)[V]) {
  if constexpr (V == 4) {
    if (valid == V && aligned16(p)) {
      __stcs(reinterpret_cast<float4*>(p), make_float4(q[0], q[1], q[2], q[3]));
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (j < valid) __stcs(p + j, q[j]);
}

}  // namespace gather
