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
// Design. Stash, not recompute: the TPU kernel re-derives x1..x4 from an
// 8-row halo of x, which on the TPU's VMEM is cheap. Here a 16 x 16 tile
// with that halo would run conv1 on 32 x 32 pixels, and its buffers would
// not fit beside the gradient stack's in 227 KB of shared memory. So K7,
// when it runs for training, writes x, x1..x4 of its output tiles pixel-major
// ((B, HW, F + 4G) bf16, 38 MB per block at B = 2, 256^2), and K8 reads
// them: the same bits a recompute would give, since they are K7's own
// rounding.
//
// Three launches, no atomics, so two runs give the same bits:
// 1. chain_kernel: one block of 16 warps per TS x TS tile (TS = 16 at F/G =
//    48/24). It loads d5 = bf16(0.2 dy) on the (TS+10)^2 halo, then runs the
//    five transposed convs as K7 runs its convs (implicit GEMM on mma.sync
//    m16n8k16, weight groups staged in shared memory in B-fragment order,
//    the wrapper's pack_rdb_bwd_weights): m4 on (TS+8)^2, m3 on (TS+6)^2, ..,
//    m1 on (TS+2)^2, dx on TS^2. Each m_k is zero outside the image. It
//    writes dx, the core's stack [m1 m2 m3 m4 d5] pixel-major ((B, HW,
//    F + 4G) bf16) for the weight gradient, and per-tile partial bias sums
//    (m-tile sums in a fixed order).
// 2. wgrad_kernel: one block per (tap, chunk of 8 x 16 pixel tiles). A block
//    copies the tile's sources [x x1 x2 x3 x4] on a 1-pixel halo and its
//    stack, both pixel-major, with 16-byte cp.async, and accumulates every
//    (source channel, stack channel) product of its tap over its chunk:
//    rows are 16-channel tiles of the sources, columns 8-channel tiles of
//    the suffix of the stack that reads them, k the pixels; a warp's
//    products share each source fragment across its stack columns. It
//    writes its partial sums.
// 3. reduce_kernel sums the partials over the chunks, and the bias partials
//    over the tiles, in a fixed order, into dW (HWIO fp32) and db (fp32).
//
// What bounds it: dx's transposed convs and dW are 2 x 269,568 FLOP per
// pixel (70.7 GFLOP at 2 x 256^2): operation-bound at 0.0715 ms, against
// 37.7 MB of x, dy and dx. This first design gives up: the halo work of the
// chain (1.9x dx's useful FLOP), mma.sync rather than wgmma, the reload of
// each pixel tile by the nine tap blocks, and the partial sums' round trip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "swin_common.cuh"

using namespace swin;

namespace {

constexpr int THREADS8 = 512;
constexpr int WARPS8 = THREADS8 / 32;
constexpr int HALO = 5;  // d5's halo: one pixel per transposed conv

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
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
  const uint32_t* wfrag;  // the five transposed convs' B fragments, dx's first
  bf16* dx;               // (B, F, H*W)
  bf16* gstack;           // (B, H*W, F + 4G): m1..m4, d5 of every pixel
  float* dbpart;          // (B * tiles, 4G + F): per-tile bias sums
  int h, w, ts, tiles_x, tiles;
  int woff[5];            // word offset of each output level's fragments
  int ps[6];              // shared-memory pixel stride (bf16) of levels 1..5
  int soff[6];            // byte offset of each level's buffer
  int woff_smem;          // byte offset of the staged weight group
  int dboff_smem;         // byte offset of the m-tile bias sums
};

// Channels of stack level l (1..4: m_l, 5: d5).
template <int F, int G>
__host__ __device__ constexpr int level_ch(int l) {
  return l == 5 ? F : G;
}

// One pass of a unit loop of the transposed conv into level K (0..4) from
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
        const int l = K + 1 + s, rs = P.ts + 2 * l;
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
        const int rs = P.ts + 2 * l, ps = P.ps[l];
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

// The transposed conv into level K over its (ts + 2K)^2 region, one group of
// G output channels at a time (level 0, dx, has F / G groups): the group's
// fragments are staged in shared memory, then the warps share out the
// region's m-tiles, two to a unit where that keeps as few rounds as one.
template <int NTU, int K, int F, int G, typename Epi>
__device__ __forceinline__ void convt_phase(const ChainParams& P, unsigned char* smem, Epi epi) {
  constexpr int NOUT = K == 0 ? F : G;
  constexpr int KIN = F + (4 - K) * G;
  constexpr int GROUP_WORDS = 9 * KIN * G / 2;
  const int R = P.ts + 2 * K, M = R * R, MT = (M + 15) / 16;
  uint32_t* wsm = reinterpret_cast<uint32_t*>(smem + P.woff_smem);
  const bool pairs = (MT + 2 * WARPS8 - 1) / (2 * WARPS8) * 2 <= (MT + WARPS8 - 1) / WARPS8;
#pragma unroll 1
  for (int ng = 0; ng < NOUT / G; ++ng) {
    __syncthreads();  // the previous group's (or phase's) readers are done
    const uint4* src = reinterpret_cast<const uint4*>(P.wfrag + P.woff[K] +
                                                      (size_t)ng * GROUP_WORDS);
    for (int k = threadIdx.x; k < GROUP_WORDS / 4; k += THREADS8)
      cp_async16z(reinterpret_cast<uint4*>(wsm) + k, src + k, true);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (pairs)
      convt_units<NTU, 2, K, F, G>(P, smem, R, M, ng * G, wsm, epi);
    else
      convt_units<NTU, 1, K, F, G>(P, smem, R, M, ng * G, wsm, epi);
  }
  __syncthreads();
}

// Level K (1..4): m_K = (x_K >= 0 ? 1 : 0.2) * dx_K in fp32, zero outside the
// image; bf16 into its buffer, and for the tile's core into gstack; each
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
      const int py = p / R, px = p - py * R, gy = ty0 - K + py, gx = tx0 - K + px;
      const bool live = p < M;
      const bool inside = live && gy >= 0 && gy < H && gx >= 0 && gx < W;
      const bool core = inside && py >= K && py < K + TS && px >= K && px < K + TS;
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
        if (live) *reinterpret_cast<__nv_bfloat162*>(dst + p * ps + n) = v;
        if (core) {
          *reinterpret_cast<__nv_bfloat162*>(gstack + at + n) = v;
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
  // convt_phase ended with a barrier: every m-tile's sums are in place
  const int MT = ((TS + 2 * K) * (TS + 2 * K) + 15) / 16;
  for (int c = threadIdx.x; c < G; c += THREADS8) {
    float s = 0.f;
    for (int t = 0; t < MT; ++t) s += dbs[t * G + c];
    P.dbpart[(size_t)tile * (C4 + F) + (K - 1) * G + c] = s;
  }
  __syncthreads();  // the bias scratch is free again
}

template <int NTG, int NTF>
__global__ void __launch_bounds__(THREADS8, 1) chain_kernel(const ChainParams P) {
  constexpr int F = NTF * 8, G = NTG * 8, C4 = 4 * G;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int H = P.h, W = P.w, TS = P.ts;
  const int ty0 = (blockIdx.x / P.tiles_x) * TS, tx0 = (blockIdx.x % P.tiles_x) * TS;
  const int b = blockIdx.y, tile = b * P.tiles + blockIdx.x;
  const bf16* dyg = P.dy + (size_t)b * F * H * W;
  bf16* dxg = P.dx + (size_t)b * F * H * W;
  bf16* gsg = P.gstack + (size_t)b * H * W * (C4 + F);

  // ---- d5 = bf16(0.2 dy) on the (TS+10)^2 halo, zero outside the image;
  // the core's also into the stack in device memory
  const int R5 = TS + 2 * HALO, total = (F / 2) * R5 * R5;
  bf16* d5 = reinterpret_cast<bf16*>(smem + P.soff[5]);
  constexpr int U = 8;
  for (int base = tid; base < total; base += THREADS8 * U) {
    float v[U][2];
    int at[U];
    long long gat[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int idx = base + k * THREADS8;
      const int cp = idx / (R5 * R5), pix = idx - cp * R5 * R5;
      const int ry = pix / R5, rx = pix - ry * R5, gy = ty0 - HALO + ry, gx = tx0 - HALO + rx;
      at[k] = idx < total ? pix * P.ps[5] + 2 * cp : -1;
      gat[k] = -1;
      v[k][0] = v[k][1] = 0.f;
      if (idx < total && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const size_t off = ((size_t)(2 * cp) * H + gy) * W + gx;
        v[k][0] = 0.2f * __bfloat162float(dyg[off]);
        v[k][1] = 0.2f * __bfloat162float(dyg[off + (size_t)H * W]);
        if (ry >= HALO && ry < HALO + TS && rx >= HALO && rx < HALO + TS)
          gat[k] = ((long long)gy * W + gx) * (C4 + F) + C4 + 2 * cp;
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v[k][0], v[k][1]);
      if (at[k] >= 0) *reinterpret_cast<__nv_bfloat162*>(d5 + at[k]) = pair;
      if (gat[k] >= 0) *reinterpret_cast<__nv_bfloat162*>(gsg + gat[k]) = pair;
    }
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

  // ---- dx = the transposed conv into x, plus dy, channels-major
  convt_phase<NTG, 0, F, G>(P, smem, [&](int p0, int n0, int R, int M, float (&acc)[NTG][4]) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + g + 8 * half;
      if (p >= M) continue;
      const int py = p / R, px = p - py * R, gy = ty0 + py, gx = tx0 + px;
      if (gy >= H || gx >= W) continue;
#pragma unroll
      for (int j = 0; j < NTG; ++j) {
        const int n = n0 + j * 8 + tig * 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const size_t off = ((size_t)(n + e) * H + gy) * W + gx;
          dxg[off] = __float2bfloat16(acc[j][2 * half + e] + __bfloat162float(dyg[off]));
        }
      }
    }
  });
}

// Shared-memory plan of the chain at tile side ts: per level its pixel
// stride and byte offset, then the weight group (dx's: 9 x (F + 4G) x G
// bf16), then the bias scratch; returns the total.
size_t chain_plan(int f, int g, int ts, int* ps, int* soff, int* woff_smem, int* dboff_smem) {
  size_t o = 0;
  for (int l = 5; l >= 1; --l) {
    const int ch = l == 5 ? f : g;
    const int r = ts + 2 * l;
    ps[l] = (ch / 8) % 2 == 1 ? ch : ch + 8;
    soff[l] = (int)o;
    o += align128(sizeof(bf16) * (size_t)r * r * ps[l]);
  }
  ps[0] = soff[0] = 0;
  *woff_smem = (int)o;
  o += align128(sizeof(bf16) * 9 * (size_t)(f + 4 * g) * g);
  *dboff_smem = (int)o;
  const int mt4 = ((ts + 8) * (ts + 8) + 15) / 16;
  const int dbs = mt4 * g > f * ts ? mt4 * g : f * ts;
  return o + align128(sizeof(float) * (size_t)dbs);
}

constexpr size_t MAX_SMEM = 232448;

int chain_tile(int f, int g) {
  int ps[6], soff[6], woff_smem, dboff_smem;
  const int sizes[] = {16, 12, 8};
  for (int ts : sizes)
    if (chain_plan(f, g, ts, ps, soff, &woff_smem, &dboff_smem) <= MAX_SMEM) return ts;
  return 0;
}

// ---------------------------------------------------------------- wgrad ----

constexpr int WTH = 8, WTW = 16;  // the weight-gradient pixel tile
constexpr int SRC_PIX = (WTH + 2) * (WTW + 2);
constexpr int CORE_PIX = WTH * WTW;

// Source channel tile j (channels 16j .. 16j+15 of [x x1 x2 x3 x4]) meets
// the stack from the first conv that reads its lowest channel: the n8-tile
// where that conv's gradient starts.
__host__ __device__ constexpr int first_ntile(int F, int G, int j) {
  return 16 * j < F ? 0 : ((16 * j - F) / G + 1) * G / 8;
}

// Products (16-channel source tile, 8-channel stack tile) of one tap.
__host__ __device__ constexpr int n_items(int F, int G) {
  int n = 0;
  for (int j = 0; j < (F + 4 * G) / 16; ++j) n += (F + 4 * G) / 8 - first_ntile(F, G, j);
  return n;
}

__host__ __device__ constexpr int wgrad_warps(int F, int G) { return n_items(F, G) > 128 ? 16 : 8; }

template <int F, int G>
__device__ __forceinline__ void decode_item(int it, int& j, int& nt) {
  constexpr int NJ = (F + 4 * G) / 16, NT8 = (F + 4 * G) / 8;
  j = 0;
  for (int jj = 0; jj < NJ; ++jj) {
    const int cnt = NT8 - first_ntile(F, G, jj);
    if (it < cnt) {
      j = jj;
      nt = first_ntile(F, G, jj) + it;
      return;
    }
    it -= cnt;
  }
  nt = 0;
}

struct WgradParams {
  const bf16* stash;   // (B, H*W, F + 4G): x, x1..x4
  const bf16* gstack;  // (B, H*W, F + 4G): m1..m4, d5
  float* part;         // (chunks, 9, items, 128)
  int h, w, tiles_x, tiles_img, ntiles, per_chunk;
};

template <int F, int G>
__global__ void __launch_bounds__(wgrad_warps(F, G) * 32, 1) wgrad_kernel(const WgradParams P) {
  constexpr int C = F + 4 * G;
  constexpr int PSW = (C / 8) % 2 == 1 ? C : C + 8;
  constexpr int NIT = n_items(F, G), NW = wgrad_warps(F, G), NTH = NW * 32;
  constexpr int T = (NIT + NW - 1) / NW;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* src = reinterpret_cast<bf16*>(smem);                   // [SRC_PIX][PSW]: x, x1..x4
  bf16* stk = src + SRC_PIX * PSW;                             // [CORE_PIX][PSW]: m1..m4, d5
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tap = blockIdx.x, oy = tap / 3 - 1, ox = tap % 3 - 1;
  const int H = P.h, W = P.w, HW = H * W;

  // the warp's items, in order: runs of one source tile j over stack tiles
  int a_off[T], b_off[T];
#pragma unroll
  for (int u = 0; u < T; ++u) {
    int j, nt;
    decode_item<F, G>(min(warp * T + u, NIT - 1), j, nt);
    a_off[u] = 16 * j + ((lane >> 3) & 1) * 8;
    b_off[u] = 8 * nt;
  }
  float acc[T][4];
#pragma unroll
  for (int u = 0; u < T; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;

  const int t_end = min(P.ntiles, (blockIdx.y + 1) * P.per_chunk);
  for (int t = blockIdx.y * P.per_chunk; t < t_end; ++t) {
    const int b = t / P.tiles_img, r = t - b * P.tiles_img;
    const int ty0 = (r / P.tiles_x) * WTH, tx0 = (r % P.tiles_x) * WTW;
    const bf16* sg = P.stash + (size_t)b * HW * C;
    const bf16* mg = P.gstack + (size_t)b * HW * C;
    __syncthreads();  // the previous tile's readers are done
    // sources on the 1-pixel halo and the stack on the core, zero outside
    // the image: 16-byte copies of pixel-major rows
    for (int idx = tid; idx < (SRC_PIX + CORE_PIX) * (C / 8); idx += NTH) {
      const int q = idx / (C / 8), v = idx - q * (C / 8);
      int gy, gx;
      bf16* dst;
      const bf16* from;
      if (q < SRC_PIX) {
        const int ry = q / (WTW + 2);
        gy = ty0 - 1 + ry;
        gx = tx0 - 1 + q - ry * (WTW + 2);
        dst = src + q * PSW + v * 8;
        from = sg;
      } else {
        const int c = q - SRC_PIX, ry = c / WTW;
        gy = ty0 + ry;
        gx = tx0 + c - ry * WTW;
        dst = stk + c * PSW + v * 8;
        from = mg;
      }
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16z(dst, ok ? from + ((size_t)gy * W + gx) * C + v * 8 : from, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // k walks the tile's rows of 16 pixels; A = sources at the tap's shift
    // (16 channels x 16 pixels, stored pixel-major: ldmatrix.trans), B =
    // the stack (16 pixels x 8 channels, pixel-major: ldmatrix.trans); a
    // source fragment is loaded once per run of items that share it
    const int ka = ((lane >> 4) & 1) * 8 + (lane & 7), kb = lane & 15;
#pragma unroll 1
    for (int ry = 0; ry < WTH; ++ry) {
      const bf16* arow = src + ((ry + 1 + oy) * (WTW + 2) + ka + 1 + ox) * PSW;
      const bf16* brow = stk + (ry * WTW + kb) * PSW;
      uint32_t fa[4];
#pragma unroll
      for (int u = 0; u < T; ++u) {
        if (warp * T + u < NIT) {
          if (u == 0 || a_off[u] != a_off[u - 1]) ldsm_x4_trans(fa, arow + a_off[u]);
          uint32_t fb[2];
          ldsm_x2_trans(fb, brow + b_off[u]);
          mma_bf16(acc[u], fa, fb[0], fb[1]);
        }
      }
    }
  }
  float* out = P.part + ((size_t)blockIdx.y * 9 + tap) * NIT * 128;
#pragma unroll
  for (int u = 0; u < T; ++u)
    if (warp * T + u < NIT)
      *reinterpret_cast<float4*>(out + (size_t)(warp * T + u) * 128 + lane * 4) =
          make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
}

// dW[tap][c][n] (HWIO, the five convs one after another) = the chunks'
// partials summed in chunk order; db = the tiles' bias partials summed in
// tile order.
template <int F, int G>
__global__ void reduce_kernel(const float* part, int chunks, const float* dbpart, int tiles,
                              float* dw, float* db) {
  constexpr int C = F + 4 * G, NIT = n_items(F, G);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < 9 * NIT * 128) {
    float s = 0.f;
    for (int k = 0; k < chunks; ++k) s += part[(size_t)k * 9 * NIT * 128 + idx];
    const int tap = idx / (NIT * 128), rest = idx - tap * NIT * 128;
    const int it = rest / 128, lane = (rest / 4) % 32, e = rest % 4;
    int j, nt;
    decode_item<F, G>(it, j, nt);
    const int c = 16 * j + (lane >> 2) + (e >= 2 ? 8 : 0);
    const int n = 8 * nt + (lane & 3) * 2 + (e & 1);
    const int conv = n < 4 * G ? n / G : 4;  // 0-based
    const int o = n < 4 * G ? n % G : n - 4 * G;
    const int cin = F + conv * G, cout = conv < 4 ? G : F;
    if (c < cin) {
      int base = 0;
      for (int i = 0; i < conv; ++i) base += 9 * (F + i * G) * G;
      dw[base + (tap * cin + c) * cout + o] = s;
    }
  }
  if (idx < C) {
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s += dbpart[(size_t)t * C + idx];
    db[idx] = s;
  }
}

struct Launch {
  int ts, tiles_x, tiles, wtiles_x, wtiles_img, ntiles, chunks, per_chunk;
};

Launch geometry(int f, int g, int bsz, int h, int w) {
  Launch L;
  L.ts = chain_tile(f, g);
  L.tiles_x = L.ts ? (w + L.ts - 1) / L.ts : 0;
  L.tiles = L.ts ? L.tiles_x * ((h + L.ts - 1) / L.ts) : 0;
  L.wtiles_x = (w + WTW - 1) / WTW;
  L.wtiles_img = L.wtiles_x * ((h + WTH - 1) / WTH);
  L.ntiles = bsz * L.wtiles_img;
  L.chunks = L.ntiles < 96 ? L.ntiles : 96;
  L.per_chunk = (L.ntiles + L.chunks - 1) / L.chunks;
  L.chunks = (L.ntiles + L.per_chunk - 1) / L.per_chunk;
  return L;
}

int items_of(int f, int g) { return n_items(f, g); }

template <int NTG, int NTF>
cudaError_t launch(const ChainParams& CP, size_t chain_smem, const WgradParams& WP, int chunks,
                   float* dw, float* db, int bsz, cudaStream_t stream) {
  constexpr int F = NTF * 8, G = NTG * 8, C = F + 4 * G;
  constexpr int PSW = (C / 8) % 2 == 1 ? C : C + 8;
  cudaError_t err = cudaFuncSetAttribute(chain_kernel<NTG, NTF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)chain_smem);
  if (err != cudaSuccess) return err;
  chain_kernel<NTG, NTF><<<dim3(CP.tiles, bsz), THREADS8, chain_smem, stream>>>(CP);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t wsmem = sizeof(bf16) * (size_t)(SRC_PIX + CORE_PIX) * PSW;
  err = cudaFuncSetAttribute(wgrad_kernel<F, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wsmem);
  if (err != cudaSuccess) return err;
  wgrad_kernel<F, G><<<dim3(9, chunks), wgrad_warps(F, G) * 32, wsmem, stream>>>(WP);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = 9 * n_items(F, G) * 128;
  reduce_kernel<F, G><<<(n + 255) / 256, 256, 0, stream>>>(WP.part, chunks, CP.dbpart,
                                                           bsz * CP.tiles, dw, db);
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
  const Launch L = geometry(f, g, bsz, h, w);
  sizes[0] = (long long)bsz * h * w * (f + 4 * g);
  sizes[1] = (long long)bsz * L.tiles * (f + 4 * g);
  sizes[2] = (long long)L.chunks * 9 * items_of(f, g) * 128;
  return 0;
}

// C entry point, bound with ctypes; returns a cudaError_t. dy and dx are
// (bsz, f, h*w) bf16, stash (bsz, h*w, f + 4g) bf16, x and x1..x4 from K7's
// training call;
// wfrag the five transposed convs' weights in B-fragment order (the
// wrapper's pack_rdb_bwd_weights) at word offsets woff, dx's first; dw the
// five HWIO weight gradients one after another and db b1..b5's (fp32).
// gstack, dbpart and part are scratch of rdb_cm_bwd_scratch's sizes.
extern "C" int rdb_cm_bwd_bf16(const void* dy, const void* stash, const void* wfrag,
                               const int* woff, void* dx, void* dw, void* db, void* gstack,
                               void* dbpart, void* part, int bsz, int f, int g, int h, int w,
                               void* stream) {
  if (!widths_ok(f, g) || bsz <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(wfrag) % 16 != 0 || reinterpret_cast<uintptr_t>(stash) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(gstack) % 16 != 0 || reinterpret_cast<uintptr_t>(part) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const Launch L = geometry(f, g, bsz, h, w);
  if (L.ts == 0) return (int)cudaErrorInvalidValue;
  ChainParams CP = {};
  CP.dy = static_cast<const bf16*>(dy);
  CP.stash = static_cast<const bf16*>(stash);
  CP.wfrag = static_cast<const uint32_t*>(wfrag);
  CP.dx = static_cast<bf16*>(dx);
  CP.gstack = static_cast<bf16*>(gstack);
  CP.dbpart = static_cast<float*>(dbpart);
  CP.h = h;
  CP.w = w;
  CP.ts = L.ts;
  CP.tiles_x = L.tiles_x;
  CP.tiles = L.tiles;
  for (int i = 0; i < 5; ++i) {
    if (woff[i] % 4 != 0) return (int)cudaErrorMisalignedAddress;
    CP.woff[i] = woff[i];
  }
  const size_t chain_smem =
      chain_plan(f, g, L.ts, CP.ps, CP.soff, &CP.woff_smem, &CP.dboff_smem);
  WgradParams WP = {};
  WP.stash = static_cast<const bf16*>(stash);
  WP.gstack = static_cast<const bf16*>(gstack);
  WP.part = static_cast<float*>(part);
  WP.h = h;
  WP.w = w;
  WP.tiles_x = L.wtiles_x;
  WP.tiles_img = L.wtiles_img;
  WP.ntiles = L.ntiles;
  WP.per_chunk = L.per_chunk;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dwp = static_cast<float*>(dw);
  float* dbp = static_cast<float*>(db);
  if (f == 48) return (int)launch<3, 6>(CP, chain_smem, WP, L.chunks, dwp, dbp, bsz, s);
  if (f == 64) return (int)launch<4, 8>(CP, chain_smem, WP, L.chunks, dwp, dbp, bsz, s);
  return (int)launch<1, 2>(CP, chain_smem, WP, L.chunks, dwp, dbp, bsz, s);
}
