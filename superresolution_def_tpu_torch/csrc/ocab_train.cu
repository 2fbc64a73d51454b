// K10b: the backward of HAT's OCAB cross-attention for Hopper, bf16 in and
// out, fp32 sums.
//
// Replaces the TPU kernel superresolution_def_tpu/kernels/ocab_train.py::
// _ocab_bwd_attn (kernel body _make_ocab_bwd_attn_kernel, its per-head
// branch). The OCAB tail is h = x + proj(cross_attn(q, k, v, bias)); the
// MLP's backward is K9b's (swin_block_train.cu, unit scale) and dx = dh is
// the caller's. From the saved q (64 queries) and the pre-gathered k and v
// (nk <= 144 keys of the 12x12 overlap) of each window and dh, one thread
// block per window computes
//
//   do = bf16(dh . wproj^T)
//   per head: a = softmax(bf16(q * scale) . k^T + bias[h]) (recomputed, fp32;
//             the out-of-image keys are zero vectors that stay in it, as in
//             the forward), da = do . v^T, ds = a * (da - rowsum(da * a)),
//             dq = bf16(ds) . k * scale, dk = bf16(ds)^T . q * scale,
//             dv = bf16(a)^T . do
//
// and writes dq (Bw, 64, C), dk and dv (Bw, nk, C) per window (the gather's
// backward outside sums the overlaps and drops the out-of-image rows), the
// window's (heads, 64, nk) bias gradient and its dbproj row, and the bf16
// attention output and dh at the padded width for the weight-gradient
// product dWproj = att^T . dh, which runs in swin_block_train.cu's wgrad
// kernel; the per-window rows are summed by its colsum kernel. Every sum
// runs in a fixed order, with no atomics: two runs give the same bits.
//
// Layout: two heads at a time, warps 0-3 on the first and 4-7 on the
// second, 16 query rows each. A warp keeps its 16 x 144 probabilities in
// registers (72 floats) and never holds da whole: one pass over the nine
// 16-key tiles recomputes da = do . v^T tile by tile for rowsum(da * a), a
// second recomputes it for ds, which goes at once into dq's product (the
// accumulator of two 8-key tiles is the A fragment of one 16-key step) and,
// rounded, into shared memory beside bf16(a) for dk and dv, which the warps
// then take 16 key rows at a time.
//
// What bounds it: at C = 90, six heads of 15, nk = 144 a window does six
// 64 x 144 x 90 products (scores, the attention output, da, dq, dk, dv) and
// two 64 x 90 x 90 (do, dWproj), 12.0 MFLOP, against the bf16 q, dh, dq
// (3 x 11.5 KB) and k, v, dk, dv (4 x 25.9 KB) it must read or write: 138 KB,
// 87 FLOP per byte, byte-bound at the card's peaks. This design also writes
// and re-reads a 221 KB fp32 bias-gradient partial per window (the ordered
// sum's input), and like K4 it is latency-bound.

#include "swin_common.cuh"

namespace {

using namespace swin;

constexpr int NKT = 9;          // key tiles of 16: nk <= 144
constexpr int NKP = 16 * NKT;   // key rows staged per head
constexpr int LDK = NKP + 8;    // bf16 row stride of a 64 x 144 probability / ds tile

struct Params {
  const bf16* q;      // (bw, 64, cio)
  const bf16* k;      // (bw, nk, cio)
  const bf16* v;      // (bw, nk, cio)
  const bf16* dh;     // (bw, 64, cio)
  const float* bias;  // (heads, 64, nk)
  const bf16* wproj;  // (c, c), zero-padded from cio
  bf16* dq;           // (bw, 64, cio)
  bf16* dk;           // (bw, nk, cio)
  bf16* dv;           // (bw, nk, cio)
  bf16* att;          // (bw*64, c) attention output, zero past cio
  bf16* dhp;          // (bw*64, c) dh, zero past cio
  float* vec;         // (bw, c) dbproj of each window
  float* dbias;       // (bw, heads, 64, nk)
  int nk, c, cp, cio, heads, hd;
  float scale;
};

struct Layout {
  int lda;
  size_t d, q, qs, k, v, dop, pr, ds, ring, qmap, total;
};

__host__ __device__ inline Layout make_layout(int cp) {
  Layout L;
  L.lda = cp + 8;
  size_t o = 0;
  L.d = o;    o += align128(sizeof(bf16) * N * L.lda);     // dh
  L.q = o;    o += align128(sizeof(bf16) * 2 * N * LDQ);   // q of the pair
  L.qs = o;   o += align128(sizeof(bf16) * 2 * N * LDQ);   // bf16(q * scale)
  L.k = o;    o += align128(sizeof(bf16) * 2 * NKP * LDQ);
  L.v = o;    o += align128(sizeof(bf16) * 2 * NKP * LDQ);
  L.dop = o;  o += align128(sizeof(bf16) * 2 * N * LDQ);   // do of the pair
  L.pr = o;   o += align128(sizeof(bf16) * 2 * N * LDK);   // bf16(a) of the pair
  L.ds = o;   o += align128(sizeof(bf16) * 2 * N * LDK);   // bf16(ds) of the pair
  L.ring = o; o += align128(sizeof(bf16) * STAGES * TILE * LDT);
  L.qmap = o; o += align128(sizeof(int) * 2 * DP);
  L.total = o;
  return L;
}

// acc (16 x 16, two 8-wide accumulator tiles) = a[q0..q0+15, 0:32] . b[key
// rows kt*16 .. +15, 0:32]^T with a's fragments fa preloaded and b stored
// [token][LDQ].
__device__ __forceinline__ void tile_nt(float (&acc)[2][4], const uint32_t (&fa)[2][4],
                                        const bf16* b, int kt) {
#pragma unroll
  for (int i = 0; i < 2; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t fb[4];
    ldsm_b_nmajor(fb, b, LDQ, kk * 16, kt * 16);
    mma_bf16(acc[0], fa[kk], fb[0], fb[1]);
    mma_bf16(acc[1], fa[kk], fb[2], fb[3]);
  }
}

// o (16 x 32) += bf16([p0 p1]) (16 x 16: two 8-wide accumulator tiles) .
// b[key rows kt*16 .. +15, 0:32] with b stored [token][LDQ].
__device__ __forceinline__ void tile_pv(float (&o)[4][4], const float (&p0)[4],
                                        const float (&p1)[4], const bf16* b, int kt) {
  const uint32_t pa[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                          pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
#pragma unroll
  for (int dp = 0; dp < DP / 16; ++dp) {
    uint32_t fb[4];
    ldsm_b_kmajor(fb, b, LDQ, kt * 16, dp * 16);
    mma_bf16(o[2 * dp], pa, fb[0], fb[1]);
    mma_bf16(o[2 * dp + 1], pa, fb[2], fb[3]);
  }
}

// o (16 keys x 32) += at^T[k0..k0+15, 0:64] . b (64 x 32) with at stored
// [q][LDK] and b stored [q][LDQ]: dk = ds^T . q, dv = a^T . do.
__device__ __forceinline__ void rows_tn(float (&o)[4][4], const bf16* at, int k0, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t fa[4];
    ldsm_a_trans(fa, at, LDK, kk * 16, k0);
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t fb[4];
      ldsm_b_kmajor(fb, b, LDQ, kk * 16, dp * 16);
      mma_bf16(o[2 * dp], fa, fb[0], fb[1]);
      mma_bf16(o[2 * dp + 1], fa, fb[2], fb[3]);
    }
  }
}

// Writes columns d < hd of a 16 x 32 fragment (rows r0 + g, r0 + g + 8 of
// the warp's tile) times `mul` to dst[row * ld + d], rows below `rows`.
__device__ __forceinline__ void store_head(bf16* dst, int ld, const float (&o)[4][4], int r0,
                                           int rows, int hd, float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = t * 8 + tig * 2 + (e & 1), r = r0 + g + 8 * (e >> 1);
      if (d < hd && r < rows) dst[(size_t)r * ld + d] = __float2bfloat16(o[t][e] * mul);
    }
}

__global__ void __launch_bounds__(THREADS, 1) ocab_bwd_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = p.c, CP = p.cp, CIO = p.cio, heads = p.heads, hd = p.hd, nk = p.nk;
  const Layout L = make_layout(CP);
  bf16* dbuf = reinterpret_cast<bf16*>(smem + L.d);
  bf16* qb = reinterpret_cast<bf16*>(smem + L.q);      // [head][token][LDQ]
  bf16* qsb = reinterpret_cast<bf16*>(smem + L.qs);
  bf16* kb = reinterpret_cast<bf16*>(smem + L.k);      // [head][key][LDQ]
  bf16* vb = reinterpret_cast<bf16*>(smem + L.v);
  bf16* dop = reinterpret_cast<bf16*>(smem + L.dop);
  bf16* prob = reinterpret_cast<bf16*>(smem + L.pr);   // [head][q][LDK]
  bf16* dsb = reinterpret_cast<bf16*>(smem + L.ds);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  int* qmap = reinterpret_cast<int*>(smem + L.qmap);
  const int lda = L.lda;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 32, g = lane >> 2, tig = lane & 3;
  const int nkc = (CP + TILE - 1) / TILE;
  const size_t win = blockIdx.x;
  const size_t row0 = win * N, krow0 = win * nk;
  const int hl = warp >> 2;  // the warp's head within a pair

  {  // zeros under the head padding, past nk and past cio
    uint4* z = reinterpret_cast<uint4*>(smem + L.q);
    for (size_t i = tid; i < (L.pr - L.q) / 16; i += THREADS) z[i] = make_uint4(0u, 0u, 0u, 0u);
    const bf16* dh = p.dh + row0 * CIO;
    for (int i = tid; i < N * CP; i += THREADS) {
      const int r = i / CP, c = i - r * CP;
      dbuf[r * lda + c] = c < CIO ? dh[r * CIO + c] : __float2bfloat16(0.f);
    }
    for (int j = tid; j < 2 * hd; j += THREADS) qmap[j] = (j / hd) * N * LDQ + j % hd;
    for (int c = tid; c < C; c += THREADS) {  // dbproj = column sums of dh
      float s = 0.f;
      if (c < CIO)
        for (int r = 0; r < N; ++r) s += __bfloat162float(dh[r * CIO + c]);
      p.vec[win * C + c] = s;
    }
    for (int i = tid; i < N * (C - CIO); i += THREADS)  // att's padding columns
      p.att[(row0 + i / (C - CIO)) * C + CIO + i % (C - CIO)] = __float2bfloat16(0.f);
  }
  __syncthreads();
  {  // dh at the padded width for dWproj
    bf16* dst = p.dhp + row0 * C;
    for (int i = tid; i < N * C; i += THREADS) dst[i] = dbuf[(i / C) * lda + i % C];
  }

  const float qscale = round_bf16(p.scale);
  for (int h0 = 0; h0 < heads; h0 += 2) {
    const int seg = min(2, heads - h0) * hd;  // the pair's columns of q, k, v
    // ---- stage q, bf16(q * scale), k and v of the pair (the previous pair's
    // readers finished at the loop's last barrier)
    const bf16* qw = p.q + row0 * CIO;
    for (int i = tid; i < N * seg; i += THREADS) {
      const int r = i / seg, j = i - r * seg, hh = j / hd, d = j - hh * hd;
      const bf16 y = qw[r * CIO + h0 * hd + j];
      qb[(hh * N + r) * LDQ + d] = y;
      qsb[(hh * N + r) * LDQ + d] = __float2bfloat16(__bfloat162float(y) * qscale);
    }
    for (int i = tid; i < nk * seg; i += THREADS) {
      const int r = i / seg, j = i - r * seg, hh = j / hd, d = j - hh * hd;
      const size_t src = (krow0 + r) * CIO + h0 * hd + j;
      kb[(hh * NKP + r) * LDQ + d] = p.k[src];
      vb[(hh * NKP + r) * LDQ + d] = p.v[src];
    }

    // ---- do = bf16(dh . wproj[pair rows, :]^T); the pipeline's first
    // barrier also orders the staging above before anyone reads it
    {
      const bool lo = c0 < seg, hi = c0 + 16 < seg;
      float acc[4][4];
      pipeline(
          nkc, ring,
          [&](int s) {
            return Tile{p.wproj, C, h0 * hd, seg, s * TILE, min(TILE, C - s * TILE)};
          },
          [&](int s, const bf16* t) {
            if (s == 0) {
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
            }
            if (!lo) return;
            mma_tile_nt(acc, dbuf + s * TILE, lda, min(TILE, CP - s * TILE) / 16, t, hi);
            if (s != nkc - 1) return;
            for_pairs(acc, 0, hi, [&](int r, int c, float v0, float v1) {
              if (c < seg) dop[qmap[c] + r * LDQ] = __float2bfloat16(v0);
              if (c + 1 < seg) dop[qmap[c + 1] + r * LDQ] = __float2bfloat16(v1);
            });
          });
    }
    __syncthreads();  // do of both heads is in shared memory

    const int head = h0 + hl;
    const bf16* qh = qb + hl * N * LDQ;
    const bf16* qsh = qsb + hl * N * LDQ;
    const bf16* kh = kb + hl * NKP * LDQ;
    const bf16* vh = vb + hl * NKP * LDQ;
    const bf16* doh = dop + hl * N * LDQ;
    bf16* ph = prob + hl * N * LDK;
    bf16* dsh = dsb + hl * N * LDK;
    if (head < heads) {
      // ---- scores and softmax of the warp's 16 query rows, in registers
      const float* bh = p.bias + (size_t)head * N * nk;
      float a[2 * NKT][4];
#pragma unroll
      for (int t = 0; t < 2 * NKT; ++t) {  // the bias is the accumulator's starting value
        const int c = t * 8 + tig * 2;
        if (c >= nk) {
          a[t][0] = a[t][1] = a[t][2] = a[t][3] = -__int_as_float(0x7f800000);  // -inf
          continue;
        }
        const float2 b0 = *reinterpret_cast<const float2*>(bh + (r0 + g) * nk + c);
        const float2 b1 = *reinterpret_cast<const float2*>(bh + (r0 + g + 8) * nk + c);
        a[t][0] = b0.x; a[t][1] = b0.y; a[t][2] = b1.x; a[t][3] = b1.y;
      }
      uint32_t fq[DP / 16][4], fdo[DP / 16][4];
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        ldsm_x4(fq[kk], qsh + (r0 + (lane & 15)) * LDQ + kk * 16 + (lane >> 4) * 8);
        ldsm_x4(fdo[kk], doh + (r0 + (lane & 15)) * LDQ + kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int kt = 0; kt < NKT; ++kt) {
        float s[2][4];
        tile_nt(s, fq, kh, kt);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[2 * kt + i][e] += s[i][e];
      }
      float m0 = a[0][0], m1 = a[0][2];
#pragma unroll
      for (int t = 0; t < 2 * NKT; ++t) {
        m0 = fmaxf(m0, fmaxf(a[t][0], a[t][1]));
        m1 = fmaxf(m1, fmaxf(a[t][2], a[t][3]));
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
      }
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int t = 0; t < 2 * NKT; ++t) {
        a[t][0] = expf(a[t][0] - m0); a[t][1] = expf(a[t][1] - m0);
        a[t][2] = expf(a[t][2] - m1); a[t][3] = expf(a[t][3] - m1);
        l0 += a[t][0] + a[t][1];
        l1 += a[t][2] + a[t][3];
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, o);
        l1 += __shfl_xor_sync(0xffffffffu, l1, o);
      }
#pragma unroll
      for (int t = 0; t < 2 * NKT; ++t) {
        a[t][0] /= l0; a[t][1] /= l0;
        a[t][2] /= l1; a[t][3] /= l1;
        *reinterpret_cast<uint32_t*>(ph + (r0 + g) * LDK + t * 8 + tig * 2) =
            pack_bf16(a[t][0], a[t][1]);
        *reinterpret_cast<uint32_t*>(ph + (r0 + g + 8) * LDK + t * 8 + tig * 2) =
            pack_bf16(a[t][2], a[t][3]);
      }
      {  // attention output bf16(a) . v, for dWproj
        float o[4][4] = {};
#pragma unroll
        for (int kt = 0; kt < NKT; ++kt) tile_pv(o, a[2 * kt], a[2 * kt + 1], vh, kt);
        store_head(p.att + row0 * C + head * hd, C, o, r0, N, hd, 1.f);
      }
      // ---- rowsum(da * a), da = do . v^T recomputed tile by tile
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int kt = 0; kt < NKT; ++kt) {
        float da[2][4];
        tile_nt(da, fdo, vh, kt);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          s0 += da[i][0] * a[2 * kt + i][0] + da[i][1] * a[2 * kt + i][1];
          s1 += da[i][2] * a[2 * kt + i][2] + da[i][3] * a[2 * kt + i][3];
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      // ---- ds = a * (da - rowsum) -> the window's bias gradient, bf16(ds)
      // to shared memory, and dq += bf16(ds) . k
      float* db = p.dbias + (win * heads + head) * N * nk;
      float dq[4][4] = {};
#pragma unroll
      for (int kt = 0; kt < NKT; ++kt) {
        float ds[2][4];
        tile_nt(ds, fdo, vh, kt);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          ds[i][0] = a[2 * kt + i][0] * (ds[i][0] - s0);
          ds[i][1] = a[2 * kt + i][1] * (ds[i][1] - s0);
          ds[i][2] = a[2 * kt + i][2] * (ds[i][2] - s1);
          ds[i][3] = a[2 * kt + i][3] * (ds[i][3] - s1);
          const int c = kt * 16 + i * 8 + tig * 2;
          if (c < nk) {
            *reinterpret_cast<float2*>(db + (r0 + g) * nk + c) = make_float2(ds[i][0], ds[i][1]);
            *reinterpret_cast<float2*>(db + (r0 + g + 8) * nk + c) =
                make_float2(ds[i][2], ds[i][3]);
          }
          *reinterpret_cast<uint32_t*>(dsh + (r0 + g) * LDK + c) = pack_bf16(ds[i][0], ds[i][1]);
          *reinterpret_cast<uint32_t*>(dsh + (r0 + g + 8) * LDK + c) =
              pack_bf16(ds[i][2], ds[i][3]);
        }
        tile_pv(dq, ds[0], ds[1], kh, kt);
      }
      store_head(p.dq + row0 * CIO + head * hd, CIO, dq, r0, N, hd, p.scale);
    }
    __syncthreads();  // bf16(a) and bf16(ds) of both heads are in shared memory

    // ---- dk = bf16(ds)^T . q * scale and dv = bf16(a)^T . do, 16 key rows
    // at a time: warp w & 3 of each head takes key tiles w & 3, +4, +8
    if (head < heads) {
      for (int kt = warp & 3; kt < NKT && kt * 16 < nk; kt += 4) {
        float dk[4][4] = {}, dv[4][4] = {};
        rows_tn(dk, dsh, kt * 16, qh);
        rows_tn(dv, ph, kt * 16, doh);
        store_head(p.dk + krow0 * CIO + head * hd, CIO, dk, kt * 16, nk, hd, p.scale);
        store_head(p.dv + krow0 * CIO + head * hd, CIO, dv, kt * 16, nk, hd, 1.f);
      }
    }
    __syncthreads();  // the pair's q, k, v, do, a and ds are consumed
  }
}

}  // namespace

// C entry point, bound with ctypes; returns a cudaError_t. q, dh (bw, 64,
// cio) and k, v (bw, nk, cio) bf16; bias (heads, 64, nk) fp32; wproj (c, c)
// bf16 zero-padded from cio. Writes dq (bw, 64, cio), dk and dv (bw, nk,
// cio), att and dhp (bw*64, c) bf16, vec (bw, c) and dbias (bw, heads, 64,
// nk) fp32.
extern "C" int ocab_bwd_attn_bf16(const void* q, const void* k, const void* v, const void* dh,
                                  const void* bias, const void* wproj, void* dq, void* dk,
                                  void* dv, void* att, void* dhp, void* vec, void* dbias, int bw,
                                  int nk, int c, int cio, int heads, float scale, void* stream) {
  const int hd = heads > 0 ? cio / heads : 0;
  if (bw <= 0 || nk <= 0 || nk > NKP || nk % 2 != 0 || c <= 0 || c > MAX_C || c % 4 != 0 ||
      cio <= 0 || cio > c || heads <= 0 || cio % heads != 0 || hd > DP)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(wproj) % 8 != 0 || reinterpret_cast<uintptr_t>(bias) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(dbias) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dh = static_cast<const bf16*>(dh);
  p.bias = static_cast<const float*>(bias);
  p.wproj = static_cast<const bf16*>(wproj);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.att = static_cast<bf16*>(att);
  p.dhp = static_cast<bf16*>(dhp);
  p.vec = static_cast<float*>(vec);
  p.dbias = static_cast<float*>(dbias);
  p.nk = nk;
  p.c = c;
  p.cp = round16(c);
  p.cio = cio;
  p.heads = heads;
  p.hd = hd;
  p.scale = scale;
  const size_t smem = make_layout(p.cp).total;
  cudaError_t err = cudaFuncSetAttribute(ocab_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ocab_bwd_kernel<<<bw, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Dynamic shared memory one block needs at padded width c.
extern "C" size_t ocab_bwd_attn_smem_bytes(int c) { return make_layout(round16(c)).total; }
