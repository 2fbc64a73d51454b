// K8: the backward (VJP) of the hybrid's residual dense block for Hopper,
// channels-major (B, F, H*W) bf16 as K7 (rdb_cm.cu) keeps it.
//
// Replaces the TPU kernel superresolution_def_tpu/kernels/fused_rdb_cm_bwd.py::
// fused_rdb_cm_bwd (kernel body _make_bwd_kernel). With the forward
//
//   x_k = lrelu(conv_k([x, x1, .., x_{k-1}])) (k = 1..4),  out = conv5([x, .., x4]) * 0.2 + x
//
// and dy = d out, the gradient stack [m1 m2 m3 m4 d5] is d5 = 0.2 dy and
// m_k = lrelu'(x_k) * dx_k, where dx_k is the transposed conv of the stack
// members m_j (j > k) through the weights conv j applies to source k. Then
//
//   dx   = the same transposed conv into source 0, plus dy
//   dW_j = im2col(sources of conv j)^T . m_j over every pixel,  db_j = sum m_j.
//
// Rounding points follow the TPU kernel: the stack is fp32, rounded to bf16
// only where it enters a product (the transposed convs and the weight
// gradients); db sums the fp32 stack; dx = the fp32 sum + dy, then rounded.
// The transposed convs read the flipped taps: tap t of the output reads the
// weight of tap 8 - t.
//
// Stash, not recompute: the TPU kernel re-derives x1..x4 from an 8-row
// halo of x, cheap in the TPU's VMEM. Here K7, when it runs for training,
// writes x, x1..x4 of its output tiles pixel-major ((B, HW, F + 4G) bf16,
// 38 MB per block at B = 2, 256^2), and K8 reads them: the same bits a
// recompute would give, since they are K7's own rounding.
//
// What bounds it on the H100: dx's transposed convs and dW are 2 x 269,568
// FLOP per pixel (70.7 GFLOP at 2 x 256^2), operation-bound at 0.0715 ms
// against 37.7 MB of x, dy and dx. Three launches, no atomics, so two runs
// give the same bits:
//
// 1. stack_kernel: one block of 16 warps per TS x TS tile walks the chain
//    of transposed convs into m4, m3, m2, m1 (implicit GEMM on mma.sync
//    m16n8k16, weight fragments in shared memory in B-fragment order).
//    d5 = bf16(0.2 dy) is staged on the (TS+8)^2 halo, m4 is computed on
//    (TS+6)^2, .., m1 on the tile alone; each m_k is zero outside the image.
//    dx is not in this chain: it is the transposed conv of the whole stack,
//    which kernel 3 reads back from device memory, so every level's halo is
//    one pixel narrower than a chain ending in dx needs (m4 on 22^2, not
//    24^2): the halo recompute of m1..m4 falls from 1.63x to 1.32x of their
//    useful FLOP at TS = 16, and the chain as a whole from 1.34x to 1.17x
//    of the useful FLOP it and dx do. The next
//    level's weight group is staged (cp.async) while the current level
//    computes: two weight buffers, m4/m2 in one and m3/m1 in the other,
//    at TS = 16 (F/G = 48/24: levels 122 KB + weights 91 KB + scratch 3 KB
//    of the 227 KB; 16/8 likewise). At 64/32 two buffers do not fit beside
//    any tile, so one buffer (90 KB) and TS = 12: the next group is staged
//    after the current level. It writes the stack [m1 m2 m3 m4 d5]
//    pixel-major ((B, HW, F + 4G) bf16) for kernels 2 and 3, and per-tile
//    bias partials (m-tile sums in a fixed order).
// 2. wgrad_kernel (TMA + wgmma): dW[tap][c][n] = sum over pixels of
//    src[p + shift(tap)][c] . stack[p][n]. A block owns a slice of dW (a
//    64-channel source tile against an F-wide stack slice, all nine taps)
//    over a chunk of 8 x 16 pixel tiles, so each pixel tile's slice is
//    loaded once for the nine taps (not once per tap). Details below. Its
//    idle producer warps sum the bias partials into db.
// 3. dx_kernel (TMA + wgmma): dx = the transposed conv of the stack into x,
//    plus dy, as an implicit GEMM over 64 x 4 tiles; its idle producer
//    warps sum the weight-gradient partials into dW in chunk order.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "swin_common.cuh"

using namespace swin;

namespace {

constexpr int THREADS8 = 512;
constexpr int WARPS8 = THREADS8 / 32;
constexpr int HALO = 4;  // d5's halo: one pixel per transposed conv into m4 .. m1

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16x8, row) . b (8x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// 16-byte asynchronous global -> shared copy; zero-fills when !valid.
__device__ __forceinline__ void cp_async16z(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// ---------------------------------------------------------------- chain ----

struct ChainParams {
  const bf16* dy;         // (B, F, H*W)
  const bf16* stash;      // (B, H*W, F + 4G): x, x1..x4 from K7
  const uint32_t* wfrag;  // the packed weights: woff[1..4] the B fragments of m1..m4's convs
  bf16* gstack;           // (B, H*W, F + 4G): m1..m4, d5 of every pixel
  float* dbpart;          // (B * tiles, 4G + F): per-tile bias sums
  int h, w, ts, tiles_x, tiles;
  int woff[5];            // word offset of each output level's fragments
  int ps[6];              // shared-memory pixel stride (bf16) of levels 2..5
  int soff[6];            // byte offset of each level's buffer
  int woff_smem[2];       // byte offsets of the two weight buffers (equal: one buffer)
  int dboff_smem;         // byte offset of the m-tile bias sums
};

// Side of level l's square region around a ts x ts tile: m1 on the tile,
// one more pixel of halo per level up to d5.
__host__ __device__ inline int level_side(int ts, int l) { return ts + 2 * (l - 1); }

// Channels of stack level l (1..4: m_l, 5: d5).
template <int F, int G>
__host__ __device__ constexpr int level_ch(int l) {
  return l == 5 ? F : G;
}

// One pass of a unit loop of the transposed conv into level K (1..4) from
// levels K+1..5: MTU m-tiles by NTU n8-tiles per unit, K walking the taps,
// the levels and their 16-channel chunks, as rdb_cm.cu's conv_units.
template <int NTU, int MTU, int K, int F, int G, typename Epi>
__device__ __forceinline__ void convt_units(const ChainParams& P, const unsigned char* smem, int R,
                                            int M, int n0, const uint32_t* wsm, Epi& epi) {
  constexpr int NL = 5 - K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int units = ((M + 15) / 16 + MTU - 1) / MTU;
  for (int u = warp; u < units; u += WARPS8) {
    int pix[MTU][NL];  // each level's pixel index of this lane's row at tap (0, 0)
#pragma unroll
    for (int m = 0; m < MTU; ++m) {
      const int p = min((u * MTU + m) * 16 + (lane & 15), M - 1);
      const int py = p / R, px = p - py * R;
#pragma unroll
      for (int s = 0; s < NL; ++s) {
        const int l = K + 1 + s, rs = level_side(P.ts, l);
        pix[m][s] = (py + l - K) * rs + px + l - K;
      }
    }
    float acc[MTU][NTU][4];
#pragma unroll
    for (int m = 0; m < MTU; ++m)
#pragma unroll
      for (int j = 0; j < NTU; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
    const uint32_t* wp = wsm;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
      for (int s = 0; s < NL; ++s) {
        const int l = K + 1 + s;
        const int cs = level_ch<F, G>(l);
        const int rs = level_side(P.ts, l), ps = P.ps[l];
        const bf16* src = reinterpret_cast<const bf16*>(smem + P.soff[l]);
        const bf16* a[MTU];
#pragma unroll
        for (int m = 0; m < MTU; ++m) a[m] = src + (pix[m][s] + dy * rs + dx) * ps;
#pragma unroll
        for (int k0 = 0; k0 + 16 <= cs; k0 += 16) {
          uint32_t fa[MTU][4];
#pragma unroll
          for (int m = 0; m < MTU; ++m) ldsm_x4(fa[m], a[m] + k0 + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < NTU; ++j) {
            const uint2 bw = reinterpret_cast<const uint2*>(wp)[j * 32 + lane];
#pragma unroll
            for (int m = 0; m < MTU; ++m) mma_bf16(acc[m][j], fa[m], bw.x, bw.y);
          }
          wp += NTU * 32 * 2;
        }
        if (cs % 16) {  // the last 8 channels of the level (lanes 0-15 address)
          uint32_t fa[MTU][2];
#pragma unroll
          for (int m = 0; m < MTU; ++m) ldsm_x2(fa[m], a[m] + cs - 8);
#pragma unroll
          for (int j = 0; j < NTU; ++j) {
            const uint32_t bw = wp[j * 32 + lane];
#pragma unroll
            for (int m = 0; m < MTU; ++m) mma_bf16_k8(acc[m][j], fa[m], bw);
          }
          wp += NTU * 32;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MTU; ++m) epi((u * MTU + m) * 16, n0, R, M, acc[m]);
  }
}

// Starts copying the fragments of the transposed conv into level K into
// its weight buffer (buffer K & 1; with one buffer both offsets agree).
template <int K, int F, int G>
__device__ __forceinline__ void issue_weights(const ChainParams& P, unsigned char* smem) {
  constexpr int WORDS = 9 * (F + (4 - K) * G) * G / 2;
  uint4* wsm = reinterpret_cast<uint4*>(smem + P.woff_smem[K & 1]);
  const uint4* src = reinterpret_cast<const uint4*>(P.wfrag + P.woff[K]);
  for (int k = threadIdx.x; k < WORDS / 4; k += THREADS8) cp_async16z(wsm + k, src + k, true);
  cp_async_commit();
}

// The transposed conv into level K over its region: its weights were
// issued before (in the previous phase, or at the kernel's start); the
// next level's are issued as soon as this one's have landed when the plan
// has two weight buffers, else once this phase is done. The warps share
// out the region's m-tiles, two to a unit where that keeps as few rounds
// as one.
template <int NTU, int K, int F, int G, typename Epi>
__device__ __forceinline__ void convt_phase(const ChainParams& P, unsigned char* smem, Epi epi) {
  const int R = level_side(P.ts, K), M = R * R, MT = (M + 15) / 16;
  const bool two = P.woff_smem[0] != P.woff_smem[1];
  cp_async_wait<0>();
  __syncthreads();  // the weights have landed; the previous phase's level is written
  if constexpr (K > 1)
    if (two) issue_weights<K - 1, F, G>(P, smem);
  const uint32_t* wsm = reinterpret_cast<const uint32_t*>(smem + P.woff_smem[K & 1]);
  const bool pairs = (MT + 2 * WARPS8 - 1) / (2 * WARPS8) * 2 <= (MT + WARPS8 - 1) / WARPS8;
  if (pairs)
    convt_units<NTU, 2, K, F, G>(P, smem, R, M, 0, wsm, epi);
  else
    convt_units<NTU, 1, K, F, G>(P, smem, R, M, 0, wsm, epi);
  __syncthreads();
  if constexpr (K > 1)
    if (!two) issue_weights<K - 1, F, G>(P, smem);
}

// Copies the tile's core of a staged level (channels c0 .. c0 + ch of the
// stack, pixel stride ps) to gstack in 16-byte pieces.
__device__ __forceinline__ void core_to_gstack(const ChainParams& P, const bf16* lvl, int side,
                                               int ps, int halo, int c0, int ch, int cs, int ty0,
                                               int tx0) {
  const int TS = P.ts, per = ch / 8;
  bf16* gs = P.gstack + (size_t)blockIdx.y * P.h * P.w * cs;
  for (int i = threadIdx.x; i < TS * TS * per; i += THREADS8) {
    const int q = i / per, v = i - q * per, py = q / TS, px = q - py * TS;
    const int gy = ty0 + py, gx = tx0 + px;
    if (gy >= P.h || gx >= P.w) continue;
    *reinterpret_cast<uint4*>(gs + ((size_t)gy * P.w + gx) * cs + c0 + 8 * v) =
        *reinterpret_cast<const uint4*>(lvl + ((py + halo) * side + px + halo) * ps + 8 * v);
  }
}

// Level K (1..4): m_K = (x_K >= 0 ? 1 : 0.2) * dx_K in fp32, zero outside the
// image; bf16 into its buffer (m2..m4: m1 feeds no level here), and for the
// tile's core into gstack; each
// m-tile's fp32 column sums over the core into the bias scratch, then the
// tile's bias partial is their sum in m-tile order.
template <int NTG, int F, int K>
__device__ __forceinline__ void stack_level(const ChainParams& P, unsigned char* smem, int ty0,
                                            int tx0, int tile) {
  constexpr int G = NTG * 8, C4 = 4 * G, CS = F + C4;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  bf16* dst = reinterpret_cast<bf16*>(smem + P.soff[K]);
  float* dbs = reinterpret_cast<float*>(smem + P.dboff_smem);
  const int ps = P.ps[K], H = P.h, W = P.w, TS = P.ts;
  const size_t img = (size_t)blockIdx.y * H * W * CS;
  const bf16* stash = P.stash + img;
  bf16* gstack = P.gstack + img;
  convt_phase<NTG, K, F, G>(P, smem, [&](int p0, int n0, int R, int M, float (&acc)[NTG][4]) {
    float colsum[NTG][2];
#pragma unroll
    for (int j = 0; j < NTG; ++j) colsum[j][0] = colsum[j][1] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + g + 8 * half;
      const int py = p / R, px = p - py * R, gy = ty0 - (K - 1) + py, gx = tx0 - (K - 1) + px;
      const bool live = p < M;
      const bool inside = live && gy >= 0 && gy < H && gx >= 0 && gx < W;
      const bool core =
          inside && py >= K - 1 && py < K - 1 + TS && px >= K - 1 && px < K - 1 + TS;
      const size_t at = ((size_t)gy * W + gx) * CS + (K - 1) * G;
#pragma unroll
      for (int j = 0; j < NTG; ++j) {
        const int n = n0 + j * 8 + tig * 2;
        float v0 = 0.f, v1 = 0.f;
        if (inside) {
          const __nv_bfloat162 xk =
              *reinterpret_cast<const __nv_bfloat162*>(stash + at + F + n);
          const float d0 = acc[j][2 * half], d1 = acc[j][2 * half + 1];
          v0 = __bfloat162float(xk.x) >= 0.f ? d0 : 0.2f * d0;
          v1 = __bfloat162float(xk.y) >= 0.f ? d1 : 0.2f * d1;
        }
        const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
        if (K > 1 && live) *reinterpret_cast<__nv_bfloat162*>(dst + p * ps + n) = v;
        if (core) {  // m2..m4 reach gstack from their buffers once the phase is done
          if (K == 1) *reinterpret_cast<__nv_bfloat162*>(gstack + at + n) = v;
          colsum[j][0] += v0;
          colsum[j][1] += v1;
        }
      }
    }
    if (p0 >= M) return;  // warp-uniform: a unit's idle second m-tile
#pragma unroll
    for (int j = 0; j < NTG; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = colsum[j][e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (g == 0) dbs[(p0 / 16) * G + n0 + j * 8 + tig * 2 + e] = s;
      }
  });
  // convt_phase ended with a barrier: every m-tile's sums, and the level,
  // are in place
  if (K > 1) core_to_gstack(P, dst, level_side(TS, K), ps, K - 1, (K - 1) * G, G, CS, ty0, tx0);
  const int MT = (level_side(TS, K) * level_side(TS, K) + 15) / 16;
  for (int c = threadIdx.x; c < G; c += THREADS8) {
    float s = 0.f;
    for (int t = 0; t < MT; ++t) s += dbs[t * G + c];
    P.dbpart[(size_t)tile * (C4 + F) + (K - 1) * G + c] = s;
  }
  __syncthreads();  // the bias scratch is free again
}

template <int NTG, int NTF>
__global__ void __launch_bounds__(THREADS8, 1) stack_kernel(const ChainParams P) {
  constexpr int F = NTF * 8, G = NTG * 8, C4 = 4 * G;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int H = P.h, W = P.w, TS = P.ts;
  const int ty0 = (blockIdx.x / P.tiles_x) * TS, tx0 = (blockIdx.x % P.tiles_x) * TS;
  const int b = blockIdx.y, tile = b * P.tiles + blockIdx.x;
  const bf16* dyg = P.dy + (size_t)b * F * H * W;
  issue_weights<4, F, G>(P, smem);  // lands while d5 is staged

  // ---- d5 = bf16(0.2 dy) on the (TS+8)^2 halo, zero outside the image;
  // the core's also into the stack in device memory
  const int R5 = TS + 2 * HALO, total = (F / 2) * R5 * R5;
  bf16* d5 = reinterpret_cast<bf16*>(smem + P.soff[5]);
  constexpr int U = 8;
  for (int base = tid; base < total; base += THREADS8 * U) {
    float v[U][2];
    int at[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int idx = base + k * THREADS8;
      const int cp = idx / (R5 * R5), pix = idx - cp * R5 * R5;
      const int ry = pix / R5, rx = pix - ry * R5, gy = ty0 - HALO + ry, gx = tx0 - HALO + rx;
      at[k] = idx < total ? pix * P.ps[5] + 2 * cp : -1;
      v[k][0] = v[k][1] = 0.f;
      if (idx < total && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const size_t off = ((size_t)(2 * cp) * H + gy) * W + gx;
        v[k][0] = 0.2f * __bfloat162float(dyg[off]);
        v[k][1] = 0.2f * __bfloat162float(dyg[off + (size_t)H * W]);
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (at[k] >= 0)
        *reinterpret_cast<__nv_bfloat162*>(d5 + at[k]) = __floats2bfloat162_rn(v[k][0], v[k][1]);
  }
  // d5's bias partial: the fp32 0.2 dy summed over the core, row by row
  float* dbs = reinterpret_cast<float*>(smem + P.dboff_smem);
  for (int idx = tid; idx < F * TS; idx += THREADS8) {
    const int c = idx / TS, ry = idx - c * TS, gy = ty0 + ry;
    float s = 0.f;
    if (gy < H)
      for (int rx = 0; rx < TS && tx0 + rx < W; ++rx)
        s += 0.2f * __bfloat162float(dyg[((size_t)c * H + gy) * W + tx0 + rx]);
    dbs[idx] = s;
  }
  __syncthreads();
  core_to_gstack(P, d5, R5, P.ps[5], HALO, C4, F, C4 + F, ty0, tx0);
  for (int c = tid; c < F; c += THREADS8) {
    float s = 0.f;
    for (int ry = 0; ry < TS; ++ry) s += dbs[c * TS + ry];
    P.dbpart[(size_t)tile * (C4 + F) + C4 + c] = s;
  }
  __syncthreads();

  // ---- m4, m3, m2, m1 (each phase synchronises before and after)
  stack_level<NTG, F, 4>(P, smem, ty0, tx0, tile);
  stack_level<NTG, F, 3>(P, smem, ty0, tx0, tile);
  stack_level<NTG, F, 2>(P, smem, ty0, tx0, tile);
  stack_level<NTG, F, 1>(P, smem, ty0, tx0, tile);
}

// Shared-memory plan of the stack kernel at tile side ts: per level (d5,
// m4, m3, m2) its pixel stride and byte offset, then the weight buffers
// (two: m4's and m2's fragments in one, m3's and m1's in the other; or one
// of the largest, m1's: 9 x (F + 3G) x G bf16), then the bias scratch;
// returns the total.
size_t chain_plan(int f, int g, int ts, bool two, int* ps, int* soff, int* woff_smem,
                  int* dboff_smem) {
  size_t o = 0;
  for (int l = 5; l >= 2; --l) {
    const int ch = l == 5 ? f : g;
    const int r = level_side(ts, l);
    ps[l] = (ch / 8) % 2 == 1 ? ch : ch + 8;
    soff[l] = (int)o;
    o += align128(sizeof(bf16) * (size_t)r * r * ps[l]);
  }
  ps[0] = soff[0] = ps[1] = soff[1] = 0;
  const size_t w1 = align128(sizeof(bf16) * 9 * (size_t)(f + 3 * g) * g);  // m1's group
  const size_t w2 = align128(sizeof(bf16) * 9 * (size_t)(f + 2 * g) * g);  // m2's group
  woff_smem[1] = (int)o;
  woff_smem[0] = two ? (int)(o + w1) : (int)o;
  o += two ? w1 + w2 : w1;
  *dboff_smem = (int)o;
  const int mt4 = (level_side(ts, 4) * level_side(ts, 4) + 15) / 16;
  const int dbs = mt4 * g > f * ts ? mt4 * g : f * ts;
  return o + align128(sizeof(float) * (size_t)dbs);
}

constexpr size_t MAX_SMEM = 232448;

// The largest tile whose plan fits, with two weight buffers where one fits
// beside it; returns the side (0: none) and sets *two.
int chain_tile(int f, int g, bool* two) {
  int ps[6], soff[6], woff_smem[2], dboff_smem;
  const int sizes[] = {16, 12, 8};
  for (int t2 = 1; t2 >= 0; --t2)
    for (int ts : sizes)
      if (chain_plan(f, g, ts, t2, ps, soff, woff_smem, &dboff_smem) <= MAX_SMEM) {
        *two = t2;
        return ts;
      }
  return 0;
}

// ---------------------------------------------------------------- wgrad ----
//
// dW[tap][c][n] = sum over pixels p of src[p + shift(tap)][c] * stack[p][n],
// a product with K = the pixels. A block owns one slice of dW: a 64-channel
// tile of the sources (ct) against one F-wide slice of the stack (s: [m1
// m2], [m3 m4] or [d5]; F = 2G at every compiled width), all nine taps,
// over a chunk of 8 x 16 pixel tiles. Per tile, one producer thread brings
// the slice's sources on the tile's 1-pixel halo (10 x 18 pixels) and its
// stack (8 x 16) in by TMA: one 5-D box each (8 channels x pixels x rows x
// channel groups x 1 image), which lands as 16-byte rows of 8 channels,
// pixel after pixel, group after group: the interleaved MN-major wgmma
// layout. Elements outside the image (and channels past C) arrive as
// zeros. Three consumer warpgroups own three taps each (3 m64nF
// accumulators); tap (dy, dx) of tile row y reads the staged sources from
// pixel (y + 1 + dy, 1 + dx) on: the shift is only the descriptor's start.
// A ring of five or six tiles under mbarriers keeps the copies ahead of
// the products.

constexpr int WTH = 8, WTW = 16;  // the pixel tile: one k16 step per row
constexpr int SRC_PIX = (WTH + 2) * (WTW + 2);
constexpr int CORE_PIX = WTH * WTW;
// bytes between the staged sources' 8-channel groups
constexpr int SRC_GROUP = SRC_PIX * 16;
constexpr int WTHREADS = 4 * 128;  // three consumer warpgroups and a producer
constexpr int MAX_PAIRS = 9;

struct WgradParams {
  float* part;  // (chunks, pairs, 9, 64, F)
  int tiles_x, tiles_img, ntiles, per_chunk, pairs;
  int pair_ct[MAX_PAIRS], pair_s[MAX_PAIRS];  // each block column's source tile and stack slice
  // the bias reduction, done by the producer warpgroup's idle warps: the
  // stack kernel's per-tile partials dbpart (dbtiles, F + 4G) into db
  const float* dbpart;
  int dbtiles;
  float* db;
};

template <int F>
__host__ __device__ constexpr size_t wgrad_stage_bytes() {
  return (size_t)SRC_GROUP * 8 + (size_t)CORE_PIX * F * 2;
}

// ring depth: as many stages as 227 KB holds, up to six
template <int F>
__host__ __device__ constexpr int wgrad_stages() {
  return F == 64 ? 5 : 6;
}

template <int F>
__host__ __device__ constexpr size_t wgrad_smem() {
  return wgrad_stages<F>() * wgrad_stage_bytes<F>() + 2 * wgrad_stages<F>() * sizeof(uint64_t);
}

template <int F, int TA, int TB>
__device__ __forceinline__ void wgmma_nf(float (&d)[F / 2], uint64_t da, uint64_t db) {
  using namespace hopper;
  if constexpr (F == 48) wgmma_n48<TA, TB>(d, da, db, 1);
  else if constexpr (F == 64) wgmma_n64<TA, TB>(d, da, db, 1);
  else wgmma_n16<TA, TB>(d, da, db, 1);
}

template <int F>
__global__ void __launch_bounds__(WTHREADS, 1)
    wgrad_kernel(const __grid_constant__ CUtensorMap src_map,
                 const __grid_constant__ CUtensorMap stk_map, const WgradParams P) {
  using namespace hopper;
  constexpr int SRC_BYTES = SRC_GROUP * 8, STAGE = (int)wgrad_stage_bytes<F>();
  constexpr int NS = wgrad_stages<F>();
  constexpr int TX = SRC_PIX * 16 * 8 + CORE_PIX * F * 2;  // what the boxes bring
  extern __shared__ __align__(1024) unsigned char wsm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(wsm + NS * STAGE);
  uint64_t* empty = full + NS;
  const int tid = threadIdx.x, wgi = tid >> 7;
  const int ct = P.pair_ct[blockIdx.x], sl = P.pair_s[blockIdx.x];
  const int t_begin = blockIdx.y * P.per_chunk;
  const int tiles = min(P.ntiles, t_begin + P.per_chunk) - t_begin;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 3);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (wgi == 3) {  // producer: one thread issues every copy
    if (tid >= 3 * 128 + 32) {  // db = the tiles' partials summed in tile order
      const int c = (blockIdx.y * gridDim.x + blockIdx.x) * 96 + tid - (3 * 128 + 32);
      if (c < 3 * F) {  // F + 4G = 3F at every compiled width
        float s = 0.f;
#pragma unroll 8
        for (int t = 0; t < P.dbtiles; ++t) s += P.dbpart[(size_t)t * 3 * F + c];
        P.db[c] = s;
      }
      return;
    }
    if (tid != 3 * 128) return;
    for (int i = 0; i < tiles; ++i) {
      const int st = i % NS;
      if (i >= NS) mbar_wait(&empty[st], ((i / NS) - 1) & 1);
      const int t = t_begin + i, b = t / P.tiles_img, r = t - b * P.tiles_img;
      const int ty0 = (r / P.tiles_x) * WTH, tx0 = (r % P.tiles_x) * WTW;
      unsigned char* stage = wsm + st * STAGE;
      mbar_arrive_expect_tx(&full[st], TX);
      tma_load_5d(stage, &src_map, 0, tx0 - 1, ty0 - 1, 8 * ct, b, &full[st]);
      tma_load_5d(stage + SRC_BYTES, &stk_map, 0, tx0, ty0, F / 8 * sl, b, &full[st]);
    }
    return;
  }
  float acc[3][F / 2];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < F / 2; ++i) acc[k][i] = 0.f;
  for (int i = 0; i < tiles; ++i) {
    const int st = i % NS;
    mbar_wait(&full[st], (i / NS) & 1);
    const unsigned char* src = wsm + st * STAGE;
    const unsigned char* stk = src + SRC_BYTES;
#pragma unroll
    for (int k = 0; k < 3; ++k) fence_regs(acc[k]);
    wg_fence();
#pragma unroll
    for (int y = 0; y < WTH; ++y) {
      const uint64_t db = desc(stk + y * WTW * 16, 128, CORE_PIX * 16);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int tap = 3 * wgi + k, dy = tap / 3 - 1, dx = tap % 3 - 1;
        wgmma_nf<F, MNMAJ, MNMAJ>(acc[k], desc(src + ((y + 1 + dy) * (WTW + 2) + 1 + dx) * 16, 128, SRC_GROUP),
                    db);
      }
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int k = 0; k < 3; ++k) fence_regs(acc[k]);
    if ((tid & 127) == 0) mbar_arrive(&empty[st]);
  }
  // the block's partial: (tap, source channel of the tile, stack channel of the slice)
  const int lane = tid & 31, w = (tid >> 5) & 3;
  float* out = P.part + ((size_t)blockIdx.y * P.pairs + blockIdx.x) * 9 * 64 * F;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < F / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = 16 * w + (lane >> 2) + 8 * hh, n = 8 * j + 2 * (lane & 3);
        *reinterpret_cast<float2*>(out + ((size_t)(3 * wgi + k) * 64 + c) * F + n) =
            make_float2(acc[k][4 * j + 2 * hh], acc[k][4 * j + 2 * hh + 1]);
      }
}

// ------------------------------------------------------------------- dx ----
//
// dx = the transposed conv of the whole stack [m1 m2 m3 m4 d5] into x, plus
// dy: for each output pixel, the stack on its 3 x 3 neighbourhood (read back
// from gstack, which the stack kernel wrote for every pixel) against conv
// 1..5's weights of source 0, taps flipped. An implicit GEMM on wgmma
// m64nFk16 with M = one 64-pixel row of a 64 x 4 tile (two consumer
// warpgroups of two rows each), N = F, K = 9 taps x (F + 4G) stack
// channels. Per 16-channel k step a producer thread brings in by TMA one
// 5-D box of the stack on the tile's halo (66 pixels x 6 rows x 2 groups of
// 8 channels: 16-byte rows of 8 channels, pixel after pixel, the
// interleaved K-major layout with 8-pixel core matrices 128 bytes apart),
// so tap (dy, dx) of an output row is the same bytes from pixel (row + 1 +
// dy, 1 + dx) on: nine taps from one copy. dx's weights (9 taps x (F + 4G)
// x F bf16) stay in shared memory for the block's life where they fit
// (F = 48: 124 KB; F = 16); at F = 64 (221 KB) each k step's share comes
// with its box. A 4- (3-) stage ring under mbarriers; the blocks are
// persistent and walk the tiles. Each tile's dx = acc + dy goes out through
// shared memory, 16-byte runs of one channel's pixels (channels-major rows),
// not 2-byte stores. The producer warpgroup's other three warps meanwhile
// sum the weight-gradient partials in chunk order.

constexpr int DTW = 64, DTH = 4;                  // the dx tile
constexpr int DPIX = (DTH + 2) * (DTW + 2);       // its halo: 396 pixels
constexpr int DGROUP = DPIX * 16;                 // one 8-channel group of the box
constexpr int DBOX = 2 * DGROUP;                  // a k step's box: 12,672 bytes
constexpr int DTHREADS = 3 * 128;

template <int F>
__host__ __device__ constexpr bool dx_resident() {
  return F != 64;
}

template <int F>
__host__ __device__ constexpr int dx_stages() {
  return dx_resident<F>() ? 4 : 3;
}

// the output staging of a consumer warpgroup: fp32 [F][2 rows x 64 pixels
// + 4], the pad keeping the fragment stores free of bank conflicts
constexpr int DOUT_LD = 2 * DTW + 4;

template <int F>
__host__ __device__ constexpr int dx_out_bytes() {
  return F * DOUT_LD * 4;
}

template <int F>
__host__ __device__ constexpr int dx_wstep() {  // bytes of one k step's weights
  return 9 * 16 * F * 2;
}

template <int F>
__host__ __device__ constexpr int dx_stage_bytes() {  // a multiple of 128: TMA's alignment
  return (DBOX + (dx_resident<F>() ? 0 : dx_wstep<F>()) + 127) / 128 * 128;
}

template <int F>
__host__ __device__ constexpr size_t dx_smem() {
  return (dx_resident<F>() ? (size_t)(3 * F / 16) * dx_wstep<F>() : 0) +
         dx_stages<F>() * (size_t)dx_stage_bytes<F>() + 2 * (size_t)dx_out_bytes<F>() +
         16 * sizeof(uint64_t);
}

struct DxParams {
  const bf16* dy;       // (B, F, H*W)
  bf16* dx;             // (B, F, H*W)
  const bf16* wdx;      // per 16-channel k step: [tap][F/8][2][8][8] bf16 (the wrapper's packing)
  int h, w, tiles_x, tiles_img, ntiles;
  // the weight-gradient reduction: WgradParams' partials over `chunks`
  // chunks into dw (HWIO fp32, the five convs one after another)
  int chunks;
  float* dw;
};

template <int F, int G>
__global__ void __launch_bounds__(DTHREADS, 1)
    dx_kernel(const __grid_constant__ CUtensorMap map, const DxParams P, const WgradParams W) {
  using namespace hopper;
  constexpr int C = F + 4 * G, KS = C / 16, NS = dx_stages<F>(), STAGE = dx_stage_bytes<F>();
  constexpr bool RES = dx_resident<F>();
  constexpr int WRES = RES ? KS * dx_wstep<F>() : 0;
  constexpr int TX = DBOX + (RES ? 0 : dx_wstep<F>());
  extern __shared__ __align__(1024) unsigned char dsm[];
  unsigned char* ring = dsm + WRES;  // the resident weights first, then the ring
  float* outs = reinterpret_cast<float*>(ring + NS * STAGE);  // the two warpgroups' staging
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NS * STAGE + 2 * dx_out_bytes<F>());
  uint64_t* empty = full + NS;
  uint64_t* wbar = empty + NS;
  const int tid = threadIdx.x, wgi = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(wbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (wgi == 2) {
    if (tid == 256) {  // producer
      if (RES) {
        mbar_arrive_expect_tx(wbar, WRES);
        for (int k = 0; k < KS; ++k)
          bulk_load(dsm + k * dx_wstep<F>(), P.wdx + (size_t)k * dx_wstep<F>() / 2, dx_wstep<F>(),
                    wbar);
      }
      int it = 0;
      for (int t = blockIdx.x; t < P.ntiles; t += gridDim.x) {
        const int b = t / P.tiles_img, r = t - b * P.tiles_img;
        const int ty0 = (r / P.tiles_x) * DTH, tx0 = (r % P.tiles_x) * DTW;
        for (int k = 0; k < KS; ++k, ++it) {
          const int st = it % NS;
          if (it >= NS) mbar_wait(&empty[st], (it / NS - 1) & 1);
          unsigned char* stage = ring + st * STAGE;
          mbar_arrive_expect_tx(&full[st], TX);
          tma_load_5d(stage, &map, 0, tx0 - 1, ty0 - 1, 2 * k, b, &full[st]);
          if (!RES)
            bulk_load(stage + DBOX, P.wdx + (size_t)k * dx_wstep<F>() / 2, dx_wstep<F>(),
                      &full[st]);
        }
      }
    } else if (tid >= 288) {  // reducers: dW = the chunks' partials summed in chunk order
      // four consecutive stack channels (one conv's, F and G multiples of 8)
      // a float4, R of them a thread at once
      constexpr int PER_PAIR = 9 * 64 * F, R = 4;
      const int n4 = W.pairs * PER_PAIR / 4;
      const int nthr = gridDim.x * 96, gidx = blockIdx.x * 96 + tid - 288;
      const float4* part4 = reinterpret_cast<const float4*>(W.part);
      for (int i0 = gidx; i0 < n4; i0 += R * nthr) {
        float4 s[R];
        int at[R];
#pragma unroll
        for (int u = 0; u < R; ++u) {
          s[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          at[u] = -1;
          const int idx = 4 * (i0 + u * nthr);
          if (idx >= 4 * n4) continue;
          const int pr = idx / PER_PAIR, rest = idx - pr * PER_PAIR;
          const int tap = rest / (64 * F), c = 64 * W.pair_ct[pr] + (rest / F) % 64;
          const int n = F * W.pair_s[pr] + rest % F;  // the first stack channel of the four
          const int conv = n < 4 * G ? n / G : 4;     // 0-based
          const int o = n < 4 * G ? n % G : n - 4 * G;
          const int cin = F + conv * G, cout = conv < 4 ? G : F;
          if (c >= cin) continue;
          int base = 0;
          for (int i = 0; i < conv; ++i) base += 9 * (F + i * G) * G;
          at[u] = base + (tap * cin + c) * cout + o;
        }
#pragma unroll 2
        for (int k = 0; k < P.chunks; ++k)
#pragma unroll
          for (int u = 0; u < R; ++u)
            if (at[u] >= 0) {
              const float4 v = part4[(size_t)k * n4 + i0 + u * nthr];
              s[u].x += v.x;
              s[u].y += v.y;
              s[u].z += v.z;
              s[u].w += v.w;
            }
#pragma unroll
        for (int u = 0; u < R; ++u)
          if (at[u] >= 0) *reinterpret_cast<float4*>(P.dw + at[u]) = s[u];
      }
    }
    return;
  }
  // consumers: warpgroup wgi owns rows 2 wgi and 2 wgi + 1 of each tile
  const int lane = tid & 31, w = (tid >> 5) & 3, g = lane >> 2, t4 = lane & 3;
  const int H = P.h, Wd = P.w;
  if (RES) mbar_wait(wbar, 0);
  int it = 0;
  for (int t = blockIdx.x; t < P.ntiles; t += gridDim.x) {
    const int b = t / P.tiles_img, r = t - b * P.tiles_img;
    const int ty0 = (r / P.tiles_x) * DTH, tx0 = (r % P.tiles_x) * DTW;
    float acc[2][F / 2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int i = 0; i < F / 2; ++i) acc[rr][i] = 0.f;
    for (int k = 0; k < KS; ++k, ++it) {
      const int st = it % NS;
      mbar_wait(&full[st], (it / NS) & 1);
      const unsigned char* stage = ring + st * STAGE;
      const unsigned char* wk = RES ? dsm + k * dx_wstep<F>() : stage + DBOX;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) fence_regs(acc[rr]);
      wg_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        const uint64_t db = desc(wk + tap * F * 32, 128, 256);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          wgmma_nf<F, KMAJ, KMAJ>(
              acc[rr], desc(stage + ((2 * wgi + rr + 1 + dy) * (DTW + 2) + 1 + dx) * 16, DGROUP, 128),
              db);
      }
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) fence_regs(acc[rr]);
      if ((tid & 127) == 0) mbar_arrive(&empty[st]);
    }
    // dx = acc + dy, channels-major: the fp32 tile through shared memory
    // ([n][row][pixel]), then 8 pixels of one channel a thread, 16-byte
    // loads of dy and stores of dx
    float* ob = outs + wgi * (dx_out_bytes<F>() / 4);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int j = 0; j < F / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            ob[(8 * j + 2 * t4 + e) * DOUT_LD + rr * DTW + 16 * w + g + 8 * hh] =
                acc[rr][4 * j + 2 * hh + e];
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
    const size_t img = (size_t)b * F * H * Wd;
    for (int q = tid & 127; q < F * 2 * (DTW / 8); q += 128) {
      const int n = q / (2 * DTW / 8), rest = q - n * (2 * DTW / 8), rr = rest / (DTW / 8);
      const int gy = ty0 + 2 * wgi + rr, gx = tx0 + 8 * (rest % (DTW / 8));
      if (gy >= H || gx >= Wd) continue;
      const float* v = ob + n * DOUT_LD + rr * DTW + gx - tx0;
      const size_t off = img + ((size_t)n * H + gy) * Wd + gx;
      if (Wd % 8 == 0) {  // gx + 8 <= Wd, 16-byte aligned rows
        const uint4 d = *reinterpret_cast<const uint4*>(P.dy + off);
        const bf16* dv = reinterpret_cast<const bf16*>(&d);
        uint4 o;
        uint32_t* ov = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ov[e] = pack_bf16(v[2 * e] + __bfloat162float(dv[2 * e]),
                            v[2 * e + 1] + __bfloat162float(dv[2 * e + 1]));
        *reinterpret_cast<uint4*>(P.dx + off) = o;
      } else {
        for (int e = 0; e < 8 && gx + e < Wd; ++e)
          P.dx[off + e] = __float2bfloat16(v[e] + __bfloat162float(P.dy[off + e]));
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");  // the staging is free
  }
}


struct Launch {
  int ts, tiles_x, tiles, wtiles_x, wtiles_img, ntiles, chunks, per_chunk, pairs;
  int pair_ct[MAX_PAIRS], pair_s[MAX_PAIRS];
  int dtiles_x, dtiles_img, dtiles;
  bool two;
};

Launch geometry(int f, int g, int bsz, int h, int w, int sms) {
  Launch L;
  L.ts = chain_tile(f, g, &L.two);
  L.tiles_x = L.ts ? (w + L.ts - 1) / L.ts : 0;
  L.tiles = L.ts ? L.tiles_x * ((h + L.ts - 1) / L.ts) : 0;
  L.wtiles_x = (w + WTW - 1) / WTW;
  L.wtiles_img = L.wtiles_x * ((h + WTH - 1) / WTH);
  L.ntiles = bsz * L.wtiles_img;
  // the (source tile, stack slice) pairs that hold a weight: slice s reads
  // sources below F + G (m1 m2), F + 3G (m3 m4), F + 4G (d5)
  const int c = f + 4 * g, maxcin[3] = {f + g, f + 3 * g, c};
  L.pairs = 0;
  for (int ct = 0; 64 * ct < c; ++ct)
    for (int sl = 0; sl < 3; ++sl)
      if (64 * ct < maxcin[sl]) {
        L.pair_ct[L.pairs] = ct;
        L.pair_s[L.pairs] = sl;
        ++L.pairs;
      }
  // one wave: pairs x chunks blocks on the SMs
  L.chunks = max(1, min(L.ntiles, sms / L.pairs));
  L.per_chunk = (L.ntiles + L.chunks - 1) / L.chunks;
  L.chunks = (L.ntiles + L.per_chunk - 1) / L.per_chunk;
  L.dtiles_x = (w + DTW - 1) / DTW;
  L.dtiles_img = L.dtiles_x * ((h + DTH - 1) / DTH);
  L.dtiles = bsz * L.dtiles_img;
  return L;
}

int device_sms() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// The 5-D tensor map (8 channels, W, H, C/8 channel groups, B) of a
// pixel-major (B, H*W, C) bf16 tensor, boxes of 8 channels x bw x bh x
// groups x 1: a box lands as `groups` blocks of bh x bw 16-byte rows (8
// channels of a pixel), the interleaved wgmma layout.
cudaError_t pixel_map(CUtensorMap* map, const void* base, int c, int w, int h, int b, int bw,
                      int bh, int groups) {
  static PFN_cuTensorMapEncodeTiled encode = [] {
    void* fn = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault) != cudaSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[5] = {8, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)c / 8, (cuuint64_t)b};
  const cuuint64_t strides[4] = {(cuuint64_t)c * 2, (cuuint64_t)c * w * 2, 16,
                                 (cuuint64_t)c * w * h * 2};
  const cuuint32_t box[5] = {8, (cuuint32_t)bw, (cuuint32_t)bh, (cuuint32_t)groups, 1};
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base),
                            dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Maps {
  CUtensorMap src, stk, dx;  // the stash on the wgrad tile's halo, the stack on its core, the
                             // stack on the dx tile's rows
};

template <int NTG, int NTF>
cudaError_t launch(const ChainParams& CP, size_t chain_smem, const WgradParams& WP,
                   const DxParams& DP, const Maps& maps, int chunks, int bsz, int sms,
                   cudaStream_t stream) {
  constexpr int F = NTF * 8, G = NTG * 8;
  cudaError_t err = cudaFuncSetAttribute(stack_kernel<NTG, NTF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)chain_smem);
  if (err != cudaSuccess) return err;
  stack_kernel<NTG, NTF><<<dim3(CP.tiles, bsz), THREADS8, chain_smem, stream>>>(CP);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wgrad_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wgrad_smem<F>());
  if (err != cudaSuccess) return err;
  wgrad_kernel<F><<<dim3(WP.pairs, chunks), WTHREADS, wgrad_smem<F>(), stream>>>(maps.src,
                                                                              maps.stk, WP);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dx_kernel<F, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dx_smem<F>());
  if (err != cudaSuccess) return err;
  const int per_sm = MAX_SMEM / dx_smem<F>() < 2 ? (int)(MAX_SMEM / dx_smem<F>()) : 2;
  dx_kernel<F, G><<<min(per_sm * sms, DP.ntiles), DTHREADS, dx_smem<F>(), stream>>>(maps.dx, DP,
                                                                                     WP);
  return cudaGetLastError();
}

bool widths_ok(int f, int g) {
  return (f == 48 && g == 24) || (f == 64 && g == 32) || (f == 16 && g == 8);
}

}  // namespace

// Scratch the wrapper allocates for one call, in elements: sizes[0] the
// gradient stack (bf16, bsz x h*w x (f + 4g)), sizes[1] the per-tile bias
// partials (fp32), sizes[2] the weight-gradient partials (fp32). Returns 0,
// or a cudaError_t for widths that are not compiled.
extern "C" int rdb_cm_bwd_scratch(int f, int g, int bsz, int h, int w, long long* sizes) {
  if (!widths_ok(f, g) || bsz <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const Launch L = geometry(f, g, bsz, h, w, device_sms());
  sizes[0] = (long long)bsz * h * w * (f + 4 * g);
  sizes[1] = (long long)bsz * L.tiles * (f + 4 * g);
  sizes[2] = (long long)L.chunks * L.pairs * 9 * 64 * f;
  return 0;
}

// Dynamic shared memory of the three kernels (stack, wgrad, dx) at widths
// f/g, in bytes, into out[0..2]; returns the stack kernel's tile side.
extern "C" int rdb_cm_bwd_smem_bytes(int f, int g, long long* out) {
  if (!widths_ok(f, g)) return 0;
  bool two = false;
  const int ts = chain_tile(f, g, &two);
  int ps[6], soff[6], woff_smem[2], dboff_smem;
  out[0] = (long long)chain_plan(f, g, ts, two, ps, soff, woff_smem, &dboff_smem);
  out[1] = f == 48 ? (long long)wgrad_smem<48>() : f == 64 ? (long long)wgrad_smem<64>()
                                                            : (long long)wgrad_smem<16>();
  out[2] = f == 48 ? (long long)dx_smem<48>() : f == 64 ? (long long)dx_smem<64>()
                                                        : (long long)dx_smem<16>();
  return ts;
}

// C entry point, bound with ctypes; returns a cudaError_t. dy and dx are
// (bsz, f, h*w) bf16, stash (bsz, h*w, f + 4g) bf16, x and x1..x4 from K7's
// training call; wpack the packed weights (the wrapper's
// pack_rdb_bwd_weights) with woff the word offsets of dx's k steps (woff[0])
// and of m1..m4's fragments (woff[1..4]); dw the five HWIO weight gradients
// one after another and db b1..b5's (fp32). gstack, dbpart and part are
// scratch of rdb_cm_bwd_scratch's sizes.
extern "C" int rdb_cm_bwd_bf16(const void* dy, const void* stash, const void* wpack,
                               const int* woff, void* dx, void* dw, void* db, void* gstack,
                               void* dbpart, void* part, int bsz, int f, int g, int h, int w,
                               void* stream) {
  if (!widths_ok(f, g) || bsz <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(wpack) % 16 != 0 || reinterpret_cast<uintptr_t>(stash) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(gstack) % 16 != 0 || reinterpret_cast<uintptr_t>(part) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int sms = device_sms();
  const Launch L = geometry(f, g, bsz, h, w, sms);
  if (L.ts == 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i)
    if (woff[i] % 4 != 0) return (int)cudaErrorMisalignedAddress;
  const uint32_t* words = static_cast<const uint32_t*>(wpack);
  ChainParams CP = {};
  CP.dy = static_cast<const bf16*>(dy);
  CP.stash = static_cast<const bf16*>(stash);
  CP.wfrag = words;
  CP.gstack = static_cast<bf16*>(gstack);
  CP.dbpart = static_cast<float*>(dbpart);
  CP.h = h;
  CP.w = w;
  CP.ts = L.ts;
  CP.tiles_x = L.tiles_x;
  CP.tiles = L.tiles;
  for (int i = 0; i < 5; ++i) CP.woff[i] = woff[i];
  const size_t chain_smem =
      chain_plan(f, g, L.ts, L.two, CP.ps, CP.soff, CP.woff_smem, &CP.dboff_smem);
  WgradParams WP = {};
  WP.part = static_cast<float*>(part);
  WP.tiles_x = L.wtiles_x;
  WP.tiles_img = L.wtiles_img;
  WP.ntiles = L.ntiles;
  WP.per_chunk = L.per_chunk;
  WP.pairs = L.pairs;
  for (int i = 0; i < L.pairs; ++i) {
    WP.pair_ct[i] = L.pair_ct[i];
    WP.pair_s[i] = L.pair_s[i];
  }
  WP.dbpart = static_cast<const float*>(dbpart);
  WP.dbtiles = bsz * L.tiles;
  WP.db = static_cast<float*>(db);
  DxParams DP = {};
  DP.dy = static_cast<const bf16*>(dy);
  DP.dx = static_cast<bf16*>(dx);
  DP.wdx = reinterpret_cast<const bf16*>(words + woff[0]);
  DP.h = h;
  DP.w = w;
  DP.tiles_x = L.dtiles_x;
  DP.tiles_img = L.dtiles_img;
  DP.ntiles = L.dtiles;
  DP.chunks = L.chunks;
  DP.dw = static_cast<float*>(dw);
  Maps maps;
  const int c = f + 4 * g;
  cudaError_t err = pixel_map(&maps.src, stash, c, w, h, bsz, WTW + 2, WTH + 2, 8);
  if (err == cudaSuccess) err = pixel_map(&maps.stk, gstack, c, w, h, bsz, WTW, WTH, f / 8);
  if (err == cudaSuccess) err = pixel_map(&maps.dx, gstack, c, w, h, bsz, DTW + 2, DTH + 2, 2);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f == 48) return (int)launch<3, 6>(CP, chain_smem, WP, DP, maps, L.chunks, bsz, sms, s);
  if (f == 64) return (int)launch<4, 8>(CP, chain_smem, WP, DP, maps, L.chunks, bsz, sms, s);
  return (int)launch<1, 2>(CP, chain_smem, WP, DP, maps, L.chunks, bsz, sms, s);
}
