// Zero-padded separable box sum for Hopper (sm_90a): the windowed-NCC
// building block.
//
// out[b, d, h, w] = sum over |k_D|, |k_H|, |k_W| <= win / 2 of
//                   x[b, d + k_D, h + k_H, w + k_W], zero outside.
//
// Replaces pulpo_tpu/kernels/box_sum.py:_box_sum_pallas, which keeps a
// whole (H, W) plane in VMEM for the H and W passes and a (D, lanes)
// slab for the D pass. The sums are the TPU kernel's: the H pass, then
// the W pass, then the D pass, each as shifted adds, acc = x[i], then
// acc += x[i + k], acc += x[i - k] for k = 1 .. win/2, a term outside
// the volume adding the zero padding (+0.0, exact). That is the order of
// the plain PyTorch version (kernels/box_sum.py), whose shifted copies
// are zero-padded, so the two agree bit for bit.
//
// Bound: memory. The function reads x once and writes out once (8 B
// per element). One launch makes one pass over memory:
// - a block owns a TH x TW tile of (H, W) and marches along D through a
//   chunk of planes (the plan, kernels/box_sum.py:box_sum_plan, splits
//   D into chunks so that a launch has enough blocks; a chunk reads
//   win/2 planes more on each side);
// - each plane's tile, with a halo of win/2 rows and columns, is copied
//   into shared memory by cp.async (16 bytes a copy where the rows are
//   16-byte aligned; zero-filled outside the volume, so the passes add
//   without a bounds check), two planes ahead of the one being summed;
//   each thread's copies and H-pass items are the same on every plane
//   and are set up once;
// - the H pass runs down the columns of that tile in registers (RH
//   outputs an item, from RH + win - 1 reads), the W pass along the
//   rows from 16-byte shared reads (4 outputs a thread);
// - each thread keeps the W pass's results of its 4 outputs for the
//   last `win` planes in a register ring, and the D pass sums the ring;
//   each output is written once, 16 bytes at a time where aligned.
// No per-element division: the tile comes from blockIdx.x / .y, the row
// and chunk from blockIdx.z (one 32-bit divide a block). The window is
// a template parameter (win 3 .. 17: the step's 3/5/7/9 and the other
// odd windows up to 17; the wrapper raises for a wider one).
//
// The box sum is symmetric and zero-padded, hence self-adjoint: the
// backward is this same function on the cotangent.
//
// 2D: `pulpo_box_sum_2d` is the same plane kernel without the D ring
// (a (B, H, W) input is B planes of depth 1): the H pass, then the W
// pass, in the order of _hw_kernel (box_sum.py:42-49). It replaces the
// x.ndim == 3 arm of _box_sum_pallas (box_sum.py:63-74), which holds
// one whole (H, W) slice in VMEM per grid step: the NCC's window sums
// of the 2D configuration.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;                  // a tile's outputs along W: 8 quads
constexpr int TH = 32;                  // a tile's outputs along H
constexpr int THREADS = (TW / 4) * TH;  // one thread a quad of outputs: 256
constexpr int NBUF = 3;                 // plane buffers: one summed, two in flight
constexpr int RH = 4;                   // outputs an H-pass item sums down its column
constexpr int MAX_P = 8;                // win / 2, at most

// The plan (kernels/box_sum.py:box_sum_plan), 6 ints: the tile (tw, th,
// which must be TW, TH), tiles along W and H, planes a chunk, chunks.
struct Plan {
  int tw, th, tiles_w, tiles_h, chunk, chunks;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 (4) bytes to shared dst: the first `n` of them from src, the rest zero
__device__ __forceinline__ void copy16(float* dst, const float* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// P = win / 2; D3: march along D with the D ring (else one plane, 2D).
// `quads`: W % 4 == 0 and x, out 16-byte aligned, so every 4-column
// group of a row is wholly inside or outside it and 16-byte aligned.
template <int P, bool D3>
__global__ void __launch_bounds__(THREADS)
box_sum_kernel(const float* __restrict__ x, float* __restrict__ out, int D, int H, int W,
               Plan plan, bool quads) {
  constexpr int PD = D3 ? P : 0;             // the D pass's half window
  constexpr int P4 = (P + 3) / 4 * 4;        // halo columns loaded on each side
  constexpr int XS = TW + 2 * P4;            // loaded columns: w0 - P4 .. w0 + TW + P4
  constexpr int XR = TH + 2 * P;             // loaded rows: h0 - P .. h0 + TH + P
  constexpr int HC = TW + 2 * P;             // H-pass columns: w0 - P .. w0 + TW + P
  constexpr int NQ = (4 + 2 * P + 3) / 4;    // 16-byte reads of a W-pass quad's window
  constexpr int HS = TW + (2 * P + 3) / 4 * 4;  // H-pass row stride, >= 4 * (7 + NQ)
  constexpr int LQ = XS / 4;                 // 4-column groups a loaded row
  constexpr int NL = (XR * LQ + THREADS - 1) / THREADS;            // copies a thread
  constexpr int NH = (HC * (TH / RH) + THREADS - 1) / THREADS;     // H-pass items a thread
  __shared__ __align__(16) float xs[NBUF][XR][XS];
  __shared__ __align__(16) float hs[TH][HS];

  const int tid = threadIdx.x;
  const int w0 = blockIdx.x * TW, h0 = blockIdx.y * TH;
  const int b = blockIdx.z / plan.chunks;
  const int d0 = (blockIdx.z - b * plan.chunks) * plan.chunk;
  const int dend = min(d0 + plan.chunk, D);
  const long long plane = (long long)H * W;
  const float* xb = x + (long long)b * D * plane;
  float* ob = out + (long long)b * D * plane;

  // this thread's copies: 4-column group q of loaded row `row`, at
  // shared offset dst_off, plane offset src_off; bit e of `inside`: column
  // e is in the volume (else zero-filled); bit 4: the copy exists
  int dst_off[NL], src_off[NL];
  unsigned inside[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const int i = tid + k * THREADS;
    const int row = i / LQ, q = i - row * LQ;
    const int h = h0 - P + row, w = w0 - P4 + 4 * q;
    dst_off[k] = row * XS + 4 * q;
    src_off[k] = h * W + w;
    unsigned m = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (h >= 0 && h < H && w + e >= 0 && w + e < W) m |= 1u << e;
    inside[k] = i < XR * LQ ? m | 16u : 0u;
  }
  auto load = [&](int d, int buf) {
    const float* src = xb + d * plane;
    float* base = &xs[buf][0][0];
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      if (!inside[k]) continue;
      if (quads) {
        const bool in = inside[k] & 1u;
        copy16(base + dst_off[k], in ? src + src_off[k] : x, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = (inside[k] >> e) & 1u;
          copy4(base + dst_off[k] + e, in ? src + src_off[k] + e : x, in ? 4 : 0);
        }
      }
    }
  };
  // this thread's H-pass items: column c of the group of RH output rows g,
  // read from loaded rows g RH .. g RH + RH + 2P - 1
  int rd_off[NH], wr_off[NH];
#pragma unroll
  for (int k = 0; k < NH; ++k) {
    const int it = tid + k * THREADS;
    const int g = it / HC, c = it - g * HC;
    rd_off[k] = it < HC * (TH / RH) ? g * RH * XS + c + P4 - P : -1;
    wr_off[k] = g * RH * HS + c;
  }

  const int r = tid >> 3, j = tid & 7;  // this thread's outputs: row h0 + r,
  const int h = h0 + r, w = w0 + 4 * j;  // columns w .. w + 3
  float ring[2 * PD + 1][4];
#pragma unroll
  for (int k = 0; k < 2 * PD + 1; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) ring[k][e] = 0.0f;

  const int lo = max(d0 - PD, 0), hi = min(dend + PD, D);  // the planes read
#pragma unroll
  for (int i = 0; i < NBUF - 1; ++i) {
    if (lo + i < hi) load(lo + i, i);
    copies_commit();
  }
  for (int d = d0 - PD; d < dend + PD; ++d) {
    float res[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // a plane outside the volume: zero padding
    if (d >= lo && d < hi) {  // the same for the whole block
      const int i = d - lo;
      if (lo + i + NBUF - 1 < hi) load(lo + i + NBUF - 1, (i + NBUF - 1) % NBUF);
      copies_commit();
      copies_wait<NBUF - 1>();  // plane d has landed
      __syncthreads();
      const float* xp = &xs[i % NBUF][0][0];
#pragma unroll
      for (int k = 0; k < NH; ++k) {
        if (rd_off[k] < 0) continue;
        float col[RH + 2 * P];
#pragma unroll
        for (int m = 0; m < RH + 2 * P; ++m) col[m] = xp[rd_off[k] + m * XS];
#pragma unroll
        for (int m = 0; m < RH; ++m) {
          float acc = col[m + P];
#pragma unroll
          for (int kk = 1; kk <= P; ++kk) {
            acc += col[m + P + kk];
            acc += col[m + P - kk];
          }
          (&hs[0][0])[wr_off[k] + m * HS] = acc;
        }
      }
      __syncthreads();
      // W pass: this thread's quad, from the H pass's columns w - P .. w + 3 + P
      float row[4 * NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 t = *reinterpret_cast<const float4*>(&hs[r][4 * j + 4 * q]);
        row[4 * q] = t.x;
        row[4 * q + 1] = t.y;
        row[4 * q + 2] = t.z;
        row[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float acc = row[e + P];
#pragma unroll
        for (int k = 1; k <= P; ++k) {
          acc += row[e + P + k];
          acc += row[e + P - k];
        }
        res[e] = acc;
      }
    }
    // the ring holds planes d - 2 PD .. d; its middle is output plane d - PD
#pragma unroll
    for (int k = 0; k < 2 * PD; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) ring[k][e] = ring[k + 1][e];
#pragma unroll
    for (int e = 0; e < 4; ++e) ring[2 * PD][e] = res[e];
    const int dout = d - PD;
    if (dout < d0 || h >= H || w >= W) continue;
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float acc = ring[PD][e];
#pragma unroll
      for (int k = 1; k <= PD; ++k) {
        acc += ring[PD + k][e];
        acc += ring[PD - k][e];
      }
      o[e] = acc;
    }
    float* dst = ob + dout * plane + h * W + w;
    if (quads) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (w + e < W) dst[e] = o[e];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Whether plan p tiles B x D x H x W with the compiled tile, every chunk
// non-empty, within the launch limits and 32-bit in-plane offsets.
bool valid(const Plan& p, int B, int D, int H, int W) {
  return p.tw == TW && p.th == TH && p.tiles_w >= 1 && p.tiles_h >= 1 && p.chunk >= 1 &&
         p.chunks >= 1 && (long long)p.tiles_w * TW >= W && (long long)p.tiles_h * TH >= H &&
         (long long)p.chunk * p.chunks >= D && (long long)p.chunk * (p.chunks - 1) < D &&
         p.tiles_h <= 65535 && (long long)B * p.chunks <= 65535 && (long long)H * W < (1LL << 31);
}

template <bool D3, int P>
void launch(dim3 grid, const float* x, float* out, int D, int H, int W, const Plan& p, bool quads,
            cudaStream_t s) {
  box_sum_kernel<P, D3><<<grid, THREADS, 0, s>>>(x, out, D, H, W, p, quads);
}

template <bool D3>
int box_sum(const void* xv, void* outv, int B, int D, int H, int W, int win, const int* q,
            void* stream) {
  if ((long long)B * D * H * W == 0) return 0;
  const Plan p{q[0], q[1], q[2], q[3], q[4], q[5]};
  if (win % 2 != 1 || win < 3 || win / 2 > MAX_P || !valid(p, B, D, H, W))
    return (int)cudaErrorInvalidValue;
  const float* x = (const float*)xv;
  float* out = (float*)outv;
  const bool quads = W % 4 == 0 && aligned16(x) && aligned16(out);
  const dim3 grid(p.tiles_w, p.tiles_h, B * p.chunks);
  cudaStream_t s = (cudaStream_t)stream;
  switch (win / 2) {
    case 1: launch<D3, 1>(grid, x, out, D, H, W, p, quads, s); break;
    case 2: launch<D3, 2>(grid, x, out, D, H, W, p, quads, s); break;
    case 3: launch<D3, 3>(grid, x, out, D, H, W, p, quads, s); break;
    case 4: launch<D3, 4>(grid, x, out, D, H, W, p, quads, s); break;
    case 5: launch<D3, 5>(grid, x, out, D, H, W, p, quads, s); break;
    case 6: launch<D3, 6>(grid, x, out, D, H, W, p, quads, s); break;
    case 7: launch<D3, 7>(grid, x, out, D, H, W, p, quads, s); break;
    default: launch<D3, 8>(grid, x, out, D, H, W, p, quads, s); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (B, D, H, W) float32, contiguous, distinct; plan: 6 ints
// (kernels/box_sum.py:box_sum_plan). Returns the first CUDA error, or 0
// (cudaErrorInvalidValue for a window or plan the kernel does not take).
extern "C" int pulpo_box_sum(const void* x, void* out, int B, int D, int H, int W, int win,
                             const int* plan, void* stream) {
  return box_sum<true>(x, out, B, D, H, W, win, plan, stream);
}

// x, out: (B, H, W) float32, contiguous, distinct: the H pass, then the
// W pass, on each of the B planes. Returns the first CUDA error, or 0.
extern "C" int pulpo_box_sum_2d(const void* x, void* out, int B, int H, int W, int win,
                                const int* plan, void* stream) {
  return box_sum<false>(x, out, B, 1, H, W, win, plan, stream);
}
