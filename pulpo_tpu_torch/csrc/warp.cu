// Dense trilinear warp for Hopper (sm_90a).
//
// Replaces, all computing one function, out[r, p] = trilinear(moving[r % B],
// src(p)) with the reference SpatialTransformer's coordinate map
//   src_i = clamp((g_i + df_i) * S_in_i / (S_out_i - 1) - 0.5, 0, S_in_i - 1)
// (grid_sample, border padding, align_corners=False):
//   - pulpo_tpu/kernels/warp_halo.py:322 _warp_halo_pallas, with the
//     cascade, sparse-repair and XLA-gather branches around it;
//   - pulpo_tpu/kernels/warp_halo.py:554 _warp_halo_coarse_pallas (the
//     LungCT tier of large offsets);
//   - pulpo_tpu/kernels/warp_halo.py:1560 _warp_halo_pallas_cf with its
//     tier ladder, sparse repair and terminal fallback (warp_halo.py:
//     1560-1685, 1722-1736): the channels-first instantiation;
//   - pulpo_tpu/ops/warp.py:56 warp_image (the 2D warp, an XLA gather,
//     which warp_image_auto at :154 takes in 2D): the 2D instantiation.
// The TPU has no vector gather, hence its halo stencil, tiers and
// fallbacks; a gather here is exact at any displacement and input size.
//
// What bounds it on this card: device memory on a large launch, the
// latency of its dependent loads on a small one. Per output voxel and df
// row it must read the df (ND floats) and write C floats once; the
// moving volume (one row at C = 1 for every df row of the decode) is read
// again and again, from L2 and L1. The first version (one voxel a
// thread, a flat 64-bit index split by 64-bit divides and modulos, 4-byte
// accesses, each df row sweeping the whole moving row through L2 between
// the streams of df and output) ran at under a third of the byte bound
// (PERF.md). This design:
//   - a block takes a tile of the output (csrc/gather.cuh: planes x
//     lines x a strip of up to 128 voxels of the innermost axis) and
//     derives it from blockIdx by shift and mask, plus one 32-bit divide
//     for its rows; offsets in a row are 32-bit, so no thread divides;
//   - the block walks a group of df rows that read the same moving row
//     (r % B) over its tile, prefetching the next row's df while it
//     gathers the current one, so the tile's moving corners are L1 hits
//     after the first row; the df loads and output stores are evict-first
//     (ld.global.cs / st.global.cs), so the streams do not push the moving
//     volume out of L2; the moving gathers are read-only loads (__ldg);
//   - a thread computes its own voxel from registers; in a large
//     channels-first launch (the plan's V = 4, kernels/gather.py: the
//     full_res request's batched warp) it moves 4 neighbouring voxels of
//     the df and of the output with 16-byte accesses where the quad is
//     whole and aligned (a ragged or misaligned quad goes voxel by
//     voxel), through the tile in shared memory, and computes the
//     interleaved voxels x0 + i + tx * j, so that a warp's gathers stay
//     on neighbouring voxels. The quads measured faster there and slower
//     on every other launch of the paths, where a thread waits on its 4
//     voxels' gathers in turn (PERF.md, scripts/bench_gather.py).
//
// The channel body (C > 4, channels-last: the 36-channel one-hot
// segmentation maps of the OASIS path, 3D and 2D). One voxel a thread
// looping over its channels, as above, ran at 0.03 of the byte bound at
// C = 36 (21.3 ms for the 160x192x224 map, 12x grid_sample's time): each
// of the 8 corner gathers and the store of a channel is a 4-byte access
// at a 4C-byte stride across the warp's lanes, so a warp instruction
// touches 32 sectors for 128 useful bytes, and a warp's corner slabs
// overflow L1 (cutting either its stores or its gathers out of that body
// removed about two thirds of its time: scripts/bench_gather.py's probe
// copies). There the threads run across channels instead (gather.cuh, the
// plan's ch): a voxel's channels are chunks of 4 (one 16-byte access)
// where C % 4 == 0 and the map and output are 16-byte aligned, else of
// one, taken by lanes(C, ch) neighbouring threads (9 at C = 36), so a
// warp's stores are one contiguous run and each corner gather of a
// voxel's lanes one contiguous slab; every lane recomputes its voxel's
// source coordinate and corners (its df load a broadcast among the
// lanes). A block takes tx voxels of a line and walks up to 8 lines of
// its tile and, at each, its group of df rows, so that a line's corner
// slabs, half of which the next line reads, and the moving slabs that
// the rows of a group share, are L1 hits; blocks run plane after plane,
// so the planes in flight stay in L2 while the 991 MB map streams once.
//
// Numerics: built with -fmad=false, so every multiply and add rounds as
// the plain PyTorch version's separate operations do; weights are
// multiplied along the axes in order and the corners summed in order, as
// in pulpo_tpu/ops/warp.py:warp_image. The arithmetic per voxel and
// channel is the first version's in every body; only the addressing and
// the access widths changed, so every body is bit-equal to the plain
// version.
//
// Slab launch (the depth-sharded model, parallel/spatial.py): the df and
// the output are planes z0 .. z0 + O0 - 1 of a whole output of depth zg
// (the plan's), the moving volume is whole (all-gathered along depth): a
// voxel's source coordinate takes its global plane z + z0, and the host
// passes f0 = I0 / (zg - 1), so a slab is bit-equal to the matching planes
// of the whole warp. In 2D the slab runs along the first axis, H: lines
// z0 .. z0 + O0 - 1 of zg, in every body (gather.cuh: global_zy).
//
// Layouts: one kernel body, instantiated for the layout (n = voxels of a
// row):
//   channels-last:  moving (B, *S_in, C), df (B_df, *S_out, ND),
//                   out (B_df, *S_out, C); element (r, v, c) at (r * n + v) * C + c
//   channels-first: moving (B, C, *S_in), df (B_df, ND, *S_out),
//                   out (B_df, C, *S_out); element (r, v, c) at (r * C + c) * n + v
// The same operations in the same order, so the two are bit-equal; at
// C = 1 the CF output is the CL one reshaped. And for the number of
// spatial axes ND: 3 (volumes, 8 corners) and 2 (the slices of the 2D
// configuration, channels-last, 4 corners).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gather.cuh"

namespace {

constexpr int CG = 4;  // output channels a pass over the tile (V = 4)

// Channel `ch` of the moving row `m` at a voxel's corners `k`: the
// weighted corner values summed in corner order.
template <int ND>
__device__ __forceinline__ float interpolate(const float* mc, const gather::Corners<ND>& k,
                                             const int (&mstride)[ND]) {
  float acc = 0.0f;
#pragma unroll
  for (int corner = 0; corner < (1 << ND); ++corner) {
    const float contrib = __ldg(mc + gather::corner_offset<ND>(k, corner, mstride)) *
                          gather::corner_weight<ND>(k, corner);
    acc = (corner == 0) ? contrib : acc + contrib;
  }
  return acc;
}

// The df of the V voxels from flat voxel v of df row `dr` (`valid` of
// them in the line), evict-first: component a in q[a]. Channels-last
// takes V = 1.
template <bool CF, int ND, int V>
__device__ __forceinline__ void load_df(const float* dr, int n, int v, int valid,
                                        float (&q)[ND][V]) {
#pragma unroll
  for (int a = 0; a < ND; ++a) {
    if constexpr (CF)
      gather::load_plane<V>(dr + a * n + v, valid, q[a]);
    else
      q[a][0] = valid > 0 ? __ldcs(dr + v * ND + a) : 0.0f;
  }
}

template <bool CF, int ND, int V>
__global__ void __launch_bounds__(gather::THREADS)
warp_kernel(const float* __restrict__ mov, const float* __restrict__ df, float* __restrict__ out,
            int B, int rows_per_moving, int C, int I0, int I1, int I2, int O0, int O1, int O2,
            float f0, float f1, float f2, gather::Plan p) {
  static_assert(V == 1 || CF, "4 voxels a thread: channels-first only");
  const int in3[3] = {I0, I1, I2};
  const int out3[3] = {O0, O1, O2};
  const float f3[3] = {f0, f1, f2};
  int s_in[ND];
  float f[ND];
#pragma unroll
  for (int a = 0; a < ND; ++a) {
    s_in[a] = in3[a];
    f[a] = f3[a];
  }
  // the tile's axes: z (1 in 2D), y, x = the innermost
  const int X = out3[ND - 1], Y = out3[ND - 2], Z = ND == 3 ? out3[0] : 1;
  const int n_out = X * Y * Z;
  int n_in = 1;
#pragma unroll
  for (int a = 0; a < ND; ++a) n_in *= s_in[a];
  // a moving voxel's element offset along each axis, and a channel's
  int mstride[ND];
  mstride[ND - 1] = CF ? 1 : C;
#pragma unroll
  for (int a = ND - 2; a >= 0; --a) mstride[a] = mstride[a + 1] * s_in[a + 1];
  const int cs_in = CF ? n_in : 1;

  const gather::Tile t = gather::tile_of<V>(p);
  const int W = p.tx * V, TV = p.tz * p.ty * W;
  extern __shared__ float4 smem4[];  // V = 4 only
  float* sdf = reinterpret_cast<float*>(smem4);  // ND planes: the tile's df
  float* sout = sdf + ND * TV;                   // min(C, CG) planes: its output
  const int i = threadIdx.x, ly = threadIdx.y, lz = threadIdx.z;
  const int y = t.y0 + ly, z = t.z0 + lz;
  const bool line_ok = y < Y && z < Z;
  const int line = (z * Y + y) * X;  // flat index of the line's first voxel
  const int tl = (lz * p.ty + ly) * W;
  const int xq = t.x0 + V * i;       // this thread's first voxel
  const int valid = line_ok ? max(0, min(V, X - xq)) : 0;

  // rows r = mrow + B * (j0 + k), k < nrows: all read moving row mrow
  const int group = blockIdx.z / B;
  const int mrow = blockIdx.z - group * B;
  const int j0 = group * p.rows;
  const int nrows = min(p.rows, rows_per_moving - j0);
  const float* m = mov + (long long)mrow * n_in * C;
  const long long row0 = (long long)B * j0 + mrow;

  float dq[ND][V] = {};
  if (valid > 0) load_df<CF, ND, V>(df + row0 * ND * n_out, n_out, line + xq, valid, dq);
  for (int k = 0; k < nrows; ++k) {
    const long long r = row0 + (long long)B * k;
    float* o = out + r * C * n_out;
    if constexpr (V == 1) {
      float d[ND];
#pragma unroll
      for (int a = 0; a < ND; ++a) d[a] = dq[a][0];
      if (k + 1 < nrows && valid > 0)
        load_df<CF, ND, 1>(df + (r + B) * ND * n_out, n_out, line + xq, valid, dq);
      if (valid == 0) continue;
      int gz, gy;
      gather::global_zy<ND>(p, z, y, gz, gy);
      const int g3[3] = {gz, gy, xq};
      float c[ND];
#pragma unroll
      for (int a = 0; a < ND; ++a) c[a] = gather::src_coord(g3[a + 3 - ND], d[a], f[a], s_in[a]);
      const gather::Corners<ND> kk = gather::corners<ND>(c, s_in);
      for (int ch = 0; ch < C; ++ch)
        __stcs(o + (CF ? ch * n_out + line + xq : (line + xq) * C + ch),
               interpolate<ND>(m + ch * cs_in, kk, mstride));
    } else {
      __syncthreads();  // the last row's readers of the tile are done
#pragma unroll
      for (int a = 0; a < ND; ++a)
        *reinterpret_cast<float4*>(sdf + a * TV + tl + V * i) =
            make_float4(dq[a][0], dq[a][1], dq[a][2], dq[a][3]);
      if (k + 1 < nrows && valid > 0)
        load_df<CF, ND, V>(df + (r + B) * ND * n_out, n_out, line + xq, valid, dq);
      __syncthreads();
      for (int c0 = 0; c0 < C; c0 += CG) {
        const int kc = min(CG, C - c0);
#pragma unroll 1
        for (int j = 0; j < V; ++j) {
          const int lx = i + p.tx * j;
          const int x = t.x0 + lx;
          if (!line_ok || x >= X) continue;
          int gz, gy;
          gather::global_zy<ND>(p, z, y, gz, gy);
          const int g3[3] = {gz, gy, x};
          float c[ND];
#pragma unroll
          for (int a = 0; a < ND; ++a)
            c[a] = gather::src_coord(g3[a + 3 - ND], sdf[a * TV + tl + lx], f[a], s_in[a]);
          const gather::Corners<ND> kk = gather::corners<ND>(c, s_in);
#pragma unroll
          for (int cc = 0; cc < CG; ++cc) {
            if (cc >= kc) break;
            sout[cc * TV + tl + lx] = interpolate<ND>(m + (c0 + cc) * cs_in, kk, mstride);
          }
        }
        __syncthreads();
        for (int cc = 0; cc < kc && valid > 0; ++cc) {
          const float4 v4 = *reinterpret_cast<const float4*>(sout + cc * TV + tl + V * i);
          const float q[V] = {v4.x, v4.y, v4.z, v4.w};
          gather::store_plane<V>(o + (c0 + cc) * n_out + line + xq, valid, q);
        }
        if (c0 + CG < C) __syncthreads();
      }
    }
  }
}

// CH channels from p (16-byte aligned where CH = 4) through the
// read-only path, and to p evict-first.
template <int CH>
__device__ __forceinline__ void load_chunk(const float* p, float (&q)[CH]) {
  if constexpr (CH == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    q[0] = t.x;
    q[1] = t.y;
    q[2] = t.z;
    q[3] = t.w;
  } else {
    q[0] = __ldg(p);
  }
}

template <int CH>
__device__ __forceinline__ void store_chunk(float* p, const float (&q)[CH]) {
  if constexpr (CH == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(q[0], q[1], q[2], q[3]));
  else
    __stcs(p, q[0]);
}

// The channel body (plan ch = CH, channels-last, C > 4): L = lanes(C, CH)
// threads a voxel, tx voxels of a line a block (blockDim.x = tx * L),
// thread (j, lane) = threadIdx.x = j * L + lane; the block walks the ty
// lines and tz planes of its tile, and at each line its group of df rows
// (which read one moving row). Each thread recomputes its voxel's corners
// (the df load is a broadcast among the voxel's lanes) and moves chunks
// lane, lane + L, ... of CH channels: 2^ND gathers of CH contiguous
// floats and one store each, so a warp's stores are contiguous and each
// corner's gathers are contiguous slabs of the voxels' channels.
template <int ND, int CH>
__global__ void __launch_bounds__(gather::THREADS)
warp_channels_kernel(const float* __restrict__ mov, const float* __restrict__ df,
                     float* __restrict__ out, int B, int rows_per_moving, int C, int I0, int I1,
                     int I2, int O0, int O1, int O2, float f0, float f1, float f2, gather::Plan p) {
  const int in3[3] = {I0, I1, I2};
  const int out3[3] = {O0, O1, O2};
  const float f3[3] = {f0, f1, f2};
  int s_in[ND];
  float f[ND];
#pragma unroll
  for (int a = 0; a < ND; ++a) {
    s_in[a] = in3[a];
    f[a] = f3[a];
  }
  const int X = out3[ND - 1], Y = out3[ND - 2], Z = ND == 3 ? out3[0] : 1;
  const int n_out = X * Y * Z;
  int n_in = 1;
#pragma unroll
  for (int a = 0; a < ND; ++a) n_in *= s_in[a];
  int mstride[ND];
  mstride[ND - 1] = C;
#pragma unroll
  for (int a = ND - 2; a >= 0; --a) mstride[a] = mstride[a + 1] * s_in[a + 1];

  const int K = C / CH, L = gather::lanes(C, CH);
  const int j = threadIdx.x / L, lane = threadIdx.x - j * L;
  const gather::Tile t = gather::tile_of<1>(p);
  const int x = t.x0 + j;
  if (x >= X) return;  // no barrier follows

  // rows r = mrow + B * (j0 + k), k < nrows: all read moving row mrow
  const int group = blockIdx.z / B;
  const int mrow = blockIdx.z - group * B;
  const int j0 = group * p.rows;
  const int nrows = min(p.rows, rows_per_moving - j0);
  const float* m = mov + (long long)mrow * n_in * C;
  const long long row0 = (long long)B * j0 + mrow;

  for (int lz = 0; lz < p.tz; ++lz) {
    const int z = t.z0 + lz;
    if (z >= Z) break;
    for (int ly = 0; ly < p.ty; ++ly) {
      const int y = t.y0 + ly;
      if (y >= Y) break;
      const int v = (z * Y + y) * X + x;
      int gz, gy;
      gather::global_zy<ND>(p, z, y, gz, gy);
      const int g3[3] = {gz, gy, x};
      for (int k = 0; k < nrows; ++k) {
        const long long rv = (row0 + (long long)B * k) * n_out + v;  // the output voxel
        float c[ND];
#pragma unroll
        for (int a = 0; a < ND; ++a)
          c[a] = gather::src_coord(g3[a + 3 - ND], __ldcs(df + rv * ND + a), f[a], s_in[a]);
        const gather::Corners<ND> kk = gather::corners<ND>(c, s_in);
        int off[1 << ND];
        float w[1 << ND];
#pragma unroll
        for (int corner = 0; corner < (1 << ND); ++corner) {
          off[corner] = gather::corner_offset<ND>(kk, corner, mstride);
          w[corner] = gather::corner_weight<ND>(kk, corner);
        }
        float* o = out + rv * C;
        for (int q = lane; q < K; q += L) {
          float val[1 << ND][CH];
#pragma unroll
          for (int corner = 0; corner < (1 << ND); ++corner)
            load_chunk<CH>(m + off[corner] + q * CH, val[corner]);
          float acc[CH];
#pragma unroll
          for (int corner = 0; corner < (1 << ND); ++corner) {
#pragma unroll
            for (int e = 0; e < CH; ++e) {
              const float contrib = val[corner][e] * w[corner];
              acc[e] = (corner == 0) ? contrib : acc[e] + contrib;
            }
          }
          store_chunk<CH>(o + q * CH, acc);
        }
      }
    }
  }
}

template <bool CF, int ND>
int launch(const void* mov, const void* df, void* out, int B, int B_df, int C,
           int I0, int I1, int I2, int O0, int O1, int O2,
           float f0, float f1, float f2, const int* plan, void* stream) {
  const int X = ND == 3 ? O2 : O1, Y = ND == 3 ? O1 : O0, Z = ND == 3 ? O0 : 1;
  const long long n_out = (long long)X * Y * Z;
  const long long n_in = (long long)I0 * I1 * (ND == 3 ? I2 : 1);
  if (B_df == 0 || n_out == 0) return 0;
  if (B < 1 || B_df % B != 0) return (int)cudaErrorInvalidValue;
  const gather::Plan p = gather::read_plan(plan);
  const long long widest = n_out * (C > ND ? C : ND);
  if ((p.v == 4 && !CF) || (p.ch != 0 && CF) ||
      (p.ch == 4 && !(gather::aligned16(mov) && gather::aligned16(out))) ||
      !gather::valid_slab(p, gather::slab_axis<ND>(Y, Z)) ||
      !gather::valid(p, X, Y, Z, B_df / B, B, widest > n_in * C ? widest : n_in * C, C))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = gather::grid(p, B), block = gather::block(p);
  if constexpr (!CF) {
    if (p.ch != 0) {
      const dim3 lanes_block(p.tx * gather::lanes(C, p.ch));
      if (p.ch == 4)
        warp_channels_kernel<ND, 4><<<grid, lanes_block, 0, (cudaStream_t)stream>>>(
            (const float*)mov, (const float*)df, (float*)out, B, B_df / B, C, I0, I1, I2,
            O0, O1, O2, f0, f1, f2, p);
      else
        warp_channels_kernel<ND, 1><<<grid, lanes_block, 0, (cudaStream_t)stream>>>(
            (const float*)mov, (const float*)df, (float*)out, B, B_df / B, C, I0, I1, I2,
            O0, O1, O2, f0, f1, f2, p);
      return (int)cudaGetLastError();
    }
  }
  if (p.v == 1) {
    warp_kernel<CF, ND, 1><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)mov, (const float*)df, (float*)out, B, B_df / B, C, I0, I1, I2,
        O0, O1, O2, f0, f1, f2, p);
  } else if constexpr (CF) {
    const size_t smem = (size_t)(ND + (C < CG ? C : CG)) * p.tz * p.ty * p.tx * 4 * sizeof(float);
    warp_kernel<CF, ND, 4><<<grid, block, smem, (cudaStream_t)stream>>>(
        (const float*)mov, (const float*)df, (float*)out, B, B_df / B, C, I0, I1, I2,
        O0, O1, O2, f0, f1, f2, p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// plan: the launch's tile plan, 12 ints (gather::Plan) from
// kernels/gather.py:warp_plan; with a slab (z0, zg) the df and output are
// O0 planes of a whole output of depth zg, and f0 = I0 / (zg - 1) (in 2D
// below: O0 lines of zg).
extern "C" int pulpo_warp(const void* mov, const void* df, void* out,
                          int B, int B_df, int C,
                          int I0, int I1, int I2, int O0, int O1, int O2,
                          float f0, float f1, float f2, const int* plan, void* stream) {
  return launch<false, 3>(mov, df, out, B, B_df, C, I0, I1, I2, O0, O1, O2,
                          f0, f1, f2, plan, stream);
}

// The same warp on channels-first tensors: moving (B, C, *S_in),
// df (B_df, 3, *S_out), out (B_df, C, *S_out).
extern "C" int pulpo_warp_cf(const void* mov, const void* df, void* out,
                             int B, int B_df, int C,
                             int I0, int I1, int I2, int O0, int O1, int O2,
                             float f0, float f1, float f2, const int* plan, void* stream) {
  return launch<true, 3>(mov, df, out, B, B_df, C, I0, I1, I2, O0, O1, O2,
                         f0, f1, f2, plan, stream);
}

// The same warp in 2D, channels-last: moving (B, I0, I1, C), df
// (B_df, O0, O1, 2), out (B_df, O0, O1, C).
extern "C" int pulpo_warp_2d(const void* mov, const void* df, void* out,
                             int B, int B_df, int C, int I0, int I1, int O0, int O1,
                             float f0, float f1, const int* plan, void* stream) {
  return launch<false, 2>(mov, df, out, B, B_df, C, I0, I1, 1, O0, O1, 1,
                          f0, f1, 0.0f, plan, stream);
}
