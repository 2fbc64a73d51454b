// The window-kernel phases of the Swin-block backward's first design, shared
// by K4b (swin_block_bwd.cu) and, for their parameters, by K3/K9b
// (swin_block_train.cu): the ordered fragment sums, the MLP backward's
// parameters, the first K4's parameters and head-pair loop (attn_pairs), and
// the launch helpers. swin_block_train.cu says what each kernel computes and
// how its sums are ordered.
//
// mlp_chunks and attn_pairs are the first design's hidden loop and head-pair
// loop: one window per block on mma.sync behind a 2-deep cp.async ring of
// 64 x 64 weight tiles. K3/K9b and K4/K9c moved to swin_block_train.cu's
// wgmma window kernels; both loops stay here for K4b alone, whose kernel
// holds 255 registers and 195 KB of shared memory already.

#pragma once

#include "swin_common.cuh"

namespace swin {

constexpr int LDP = N + 8;  // bf16 row stride of a 64 x 64 probability / ds tile

// ---------------------------------------------------------------------------
// Column sums of register fragments, in a fixed order.
//
// v[t][e] is a warp's fragment of 16 rows x 32 columns (t = 8-wide block,
// e = the accumulator element: rows g, g, g+8, g+8). Sums the 16 rows of
// each column inside the warp and stores the result to slot[col] for the
// columns with col < limit (lanes with g == 0 store).
__device__ __forceinline__ void frag_colsum(const float (&v)[4][4], int col0, int limit,
                                            float* slot) {
  const int lane = threadIdx.x & 31, tig = lane & 3;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = v[t][e] + v[t][e + 2];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      const int col = col0 + t * 8 + tig * 2 + e;
      if ((lane >> 2) == 0 && col < limit) slot[col] = s;
    }
}

// Row sums of a 64 x C tile held as K1 holds its residual (NCH chunks of the
// per-warp fragment; warps w and w+4 share rows): returns the sums of the
// thread's two rows (r0+g, r0+g+8) of f(ch, t, e) over the real columns.
// `red` holds 2 * N floats. Ends with a barrier.
template <int NCH, typename F>
__device__ __forceinline__ void row_sums(float (&out)[2], float* red, int C, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 32, g = lane >> 2, tig = lane & 3;
  float acc[2] = {0.f, 0.f};
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = ch * TILE + c0 + t * 8 + tig * 2 + (e & 1);
        if (col < C) acc[e >> 1] += f(ch, t, e);
      }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    acc[half] += __shfl_xor_sync(0xffffffffu, acc[half], 1);
    acc[half] += __shfl_xor_sync(0xffffffffu, acc[half], 2);
    if (tig == 0) red[(r0 + g + 8 * half) * 2 + (warp >> 2)] = acc[half];
  }
  __syncthreads();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    out[half] = red[r * 2] + red[r * 2 + 1];
  }
  __syncthreads();  // red is rewritten by the next call
}

// Column sums (over the 64 rows) of a 64 x C fragment set as in row_sums,
// into dst[col] for col < C. `slot` holds 4 * CP floats. Ends with a barrier.
template <int NCH, typename F>
__device__ __forceinline__ void tile_colsum(float* dst, float* slot, int C, int CP, F f) {
  const int warp = threadIdx.x >> 5;
  const int c0 = (warp >> 2) * 32;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    float v[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[t][e] = f(ch, t, e);
    frag_colsum(v, ch * TILE + c0, C, slot + (warp & 3) * CP);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += THREADS)
    dst[c] = ((slot[c] + slot[CP + c]) + slot[2 * CP + c]) + slot[3 * CP + c];
  __syncthreads();
}

// Copies a (64, C) bf16 window from global memory, times `scale` and
// rounded to bf16, into rows of stride ld, zero-filling columns C .. CP-1.
__device__ __forceinline__ void stage_padded(bf16* dst, int ld, const bf16* src, int C, int CP,
                                             float scale) {
  for (int i = threadIdx.x; i < N * CP; i += THREADS) {
    const int r = i / CP, c = i - r * CP;
    dst[r * ld + c] = __float2bfloat16(c < C ? __bfloat162float(src[r * C + c]) * scale : 0.f);
  }
}

// scale * the column sums of a (64, cio) bf16 window, summed in row order,
// into dst[0 .. c-1] (zeros past cio).
__device__ __forceinline__ void window_colsum(float* dst, const bf16* src, int cio, int c,
                                              float scale) {
  for (int col = threadIdx.x; col < c; col += THREADS) {
    float s = 0.f;
    if (col < cio)
      for (int r = 0; r < N; ++r) s += __bfloat162float(src[r * cio + col]);
    dst[col] = scale * s;
  }
}

// Copies rows 0..63, columns 0..C-1 of a stride-ld bf16 tile to a dense
// (64, C) window in global memory.
__device__ __forceinline__ void store_window(bf16* dst, const bf16* src, int ld, int C) {
  for (int i = threadIdx.x; i < N * C; i += THREADS) {
    const int r = i / C;
    dst[i] = src[r * ld + i - r * C];
  }
}

__device__ __forceinline__ void zero_smem(void* p, size_t bytes) {
  uint4* z = reinterpret_cast<uint4*>(p);
  for (size_t i = threadIdx.x; i < bytes / 16; i += THREADS) z[i] = make_uint4(0u, 0u, 0u, 0u);
}

// ===========================================================================
// K3: LN2 + MLP backward of one window.
// ===========================================================================

struct MlpParams {
  const bf16* h;      // (Bw, 64, cio)
  const bf16* dout;   // (Bw, 64, cio)
  const float* dp;    // (Bw,) the MLP branch's scale per window, or null (1)
  const float* ln2_w;
  const float* ln2_b;
  const bf16* w1;  // (C, hidden)
  const float* b1;
  const bf16* w2;  // (hidden, C)
  bf16* dh;        // (Bw, 64, cio)
  bf16* hn;        // (Bw*64, C)       LN2 output, for dW1
  bf16* g;         // (Bw*64, hidden)  GELU output, for dW2
  bf16* du;        // (Bw*64, hidden)  for dW1
  bf16* dm;        // (Bw*64, C)       bf16(dp * dout), for dW2; null: K3 reads dout
  float* vec;      // (Bw, hidden + 3C): db1 | db2 | dln2s | dln2b of each window
  const bf16* wpack;  // K3/K9b: w1 and w2 packed for the window kernel's ring (scratch)
  int c, cp, cio, hidden;
};

// The tanh GELU of u (swin_common.cuh's gelu_tanh) and its derivative,
// sharing one tanh.
__device__ __forceinline__ float2 gelu_and_grad(float u) {
  const float s = 0.7978845608028654f * (u + 0.044715f * u * u * u);
  const float t = tanhf(s);
  const float ds = 0.7978845608028654f * (1.0f + 3.0f * 0.044715f * u * u);
  return make_float2(0.5f * u * (1.0f + t), 0.5f * (1.0f + t) + 0.5f * u * (1.0f - t * t) * ds);
}

// The MLP backward's hidden loop, shared by K3/K9b and K4b. Per 64-wide
// hidden chunk j: u = hn.w1[:, j] + b1, dg = dout.w2[j, :]^T, du = dg *
// gelu'(u) -> g and du to global (rows row0.., p.g and p.du) and du to
// `mid`, db1's chunk to vout[j*64 ..]; then dhn += du . w1[:, j]^T into
// registers. abuf holds hn, dbuf the cotangent (64 x cp bf16 each), b1s the
// staged b1; `slot` 4 x 64 floats of scratch.
template <int NCH>
__device__ __forceinline__ void mlp_chunks(float (&dhn)[NCH][4][4], const MlpParams& p, int lda,
                                           const bf16* abuf, const bf16* dbuf, bf16* mid,
                                           bf16* ring, const float* b1s, float* slot, float* vout,
                                           size_t row0) {
  const int C = p.c, CP = p.cp, hidden = p.hidden;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 32, g = lane >> 2, tig = lane & 3;
  const int nkc = (CP + TILE - 1) / TILE;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < 4; ++i) dhn[ch][i][0] = dhn[ch][i][1] = dhn[ch][i][2] = dhn[ch][i][3] = 0.f;
  {
    const int per = 2 * nkc + NCH;
    float accu[4][4], accg[4][4];
    pipeline(
        ((hidden + TILE - 1) / TILE) * per, ring,
        [&](int s) {
          const int j = s / per, u = s - j * per, nn = min(TILE, hidden - j * TILE);
          if (u < nkc)  // w1[c, j] k-major: rows c, columns j
            return Tile{p.w1, hidden, u * TILE, min(TILE, C - u * TILE), j * TILE, nn};
          if (u < 2 * nkc)  // w2 rows j, columns c: n-major for dout . w2^T
            return Tile{p.w2, C, j * TILE, nn, (u - nkc) * TILE, min(TILE, C - (u - nkc) * TILE)};
          // w1 rows c, columns j: n-major for du . w1^T
          return Tile{p.w1, hidden, (u - 2 * nkc) * TILE, min(TILE, C - (u - 2 * nkc) * TILE),
                      j * TILE, nn};
        },
        [&](int s, const bf16* t) {
          const int j = s / per, u = s - j * per, nn = min(TILE, hidden - j * TILE);
          const bool lo = c0 < nn, hi = c0 + 16 < nn;
          if (u < nkc) {
            if (u == 0) {
#pragma unroll
              for (int i = 0; i < 4; ++i) accu[i][0] = accu[i][1] = accu[i][2] = accu[i][3] = 0.f;
            }
            if (lo) mma_tile(accu, abuf + u * TILE, lda, min(TILE, CP - u * TILE) / 16, t, hi);
          } else if (u < 2 * nkc) {
            const int kc = u - nkc;
            if (kc == 0) {
#pragma unroll
              for (int i = 0; i < 4; ++i) accg[i][0] = accg[i][1] = accg[i][2] = accg[i][3] = 0.f;
            }
            if (lo) mma_tile_nt(accg, dbuf + kc * TILE, lda, min(TILE, CP - kc * TILE) / 16, t, hi);
            if (kc != nkc - 1) return;
            float du[4][4] = {};
            if (lo) {
#pragma unroll
              for (int tt = 0; tt < 4; ++tt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int r = r0 + g + 8 * (e >> 1);
                  const int col = c0 + tt * 8 + tig * 2 + (e & 1);
                  if ((tt < 2 || hi) && col < nn) {
                    const float2 gg = gelu_and_grad(accu[tt][e] + b1s[j * TILE + col]);
                    const float d = accg[tt][e] * gg.y;
                    const size_t gi = (row0 + r) * hidden + j * TILE + col;
                    p.g[gi] = __float2bfloat16(gg.x);
                    p.du[gi] = __float2bfloat16(d);
                    du[tt][e] = d;
                  }
                  if (tt < 2 || hi) mid[r * LDT + col] = __float2bfloat16(du[tt][e]);
                }
            }
            // db1 of this chunk: warp partials into slot, summed in the next step
            frag_colsum(du, c0, lo ? nn : 0, slot + (warp & 3) * TILE);
          } else {
            const int ch = u - 2 * nkc, nc = C - ch * TILE;
            if (ch == 0 && tid < nn)
              vout[j * TILE + tid] =
                  ((slot[tid] + slot[TILE + tid]) + slot[2 * TILE + tid]) + slot[3 * TILE + tid];
            if (c0 >= nc) return;
            const int ksteps = round16(nn) / 16;
#pragma unroll
            for (int cc = 0; cc < NCH; ++cc)
              if (cc == ch) mma_tile_nt(dhn[cc], mid, LDT, ksteps, t, c0 + 16 < nc);
          }
        });
  }
}

// ===========================================================================
// K4: attention + LN1 backward of one window.
// ===========================================================================

struct AttnParams {
  const bf16* x;      // (Bw, 64, cio)
  const bf16* dh;     // (Bw, 64, cio)
  const float* dp;    // (Bw,) the attention branch's scale per window, or null (1)
  const float* mask;  // (nw, 64, 64) additive shift mask, or null
  const float* ln1_w;
  const float* ln1_b;
  const bf16* wqkv;   // (C, 3C)
  const float* bqkv;
  const float* bias;  // (heads, 64, 64)
  const bf16* wproj;  // (C, C)
  bf16* dx;           // (Bw, 64, cio)
  bf16* xn;           // (Bw*64, C)   LN1 output, for dWqkv
  bf16* att;          // (Bw*64, C)   attention output, for dWproj
  bf16* dqkv;         // (Bw*64, 3C)  for dWqkv
  bf16* dhs;          // (Bw*64, C)   bf16(dp * dh), for dWproj; null: K4 reads dh
  float* vec;         // (Bw, 6C): dbqkv | dbproj | dln1s | dln1b of each window
  float* dbias;       // (Bw, heads, 64, 64)
  int c, cp, cio, heads, hd, nw;
  float scale;
};

// q, q*scale, k, v of a head pair: slots 0..3, each [head][token][LDQ]
enum { S_Q, S_QS, S_K, S_V };

// s (16 x 64, accumulator layout) += a[q0..q0+15, 0:32] . b^T with a and b
// stored [token][LDQ]: scores q.k^T, or da = do.v^T.
__device__ __forceinline__ void rows_nt(float (&s)[8][4], const bf16* a, const bf16* b, int q0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t fa[4];
    ldsm_x4(fa, a + (q0 + (lane & 15)) * LDQ + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t fb[4];
      ldsm_b_nmajor(fb, b, LDQ, kk * 16, np * 16);
      mma_bf16(s[2 * np], fa, fb[0], fb[1]);
      mma_bf16(s[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// o (16 x 32) += bf16(p) (16 x 64, from registers) . b (64 x 32, [token][LDQ]).
__device__ __forceinline__ void rows_pv(float (&o)[4][4], const float (&p)[8][4], const bf16* b) {
#pragma unroll
  for (int kb = 0; kb < N / 16; ++kb) {
    const uint32_t pa[4] = {
        pack_bf16(p[2 * kb][0], p[2 * kb][1]), pack_bf16(p[2 * kb][2], p[2 * kb][3]),
        pack_bf16(p[2 * kb + 1][0], p[2 * kb + 1][1]),
        pack_bf16(p[2 * kb + 1][2], p[2 * kb + 1][3]),
    };
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t fb[4];
      ldsm_b_kmajor(fb, b, LDQ, kb * 16, dp * 16);
      mma_bf16(o[2 * dp], pa, fb[0], fb[1]);
      mma_bf16(o[2 * dp + 1], pa, fb[2], fb[3]);
    }
  }
}

// o (16 x 32) += at^T[k0..k0+15, :] . b with at stored [q][LDP] (so at^T is
// [key][q]) and b stored [q][LDQ]: dv = a^T . do, dk = ds^T . q.
__device__ __forceinline__ void rows_tn(float (&o)[4][4], const bf16* at, int k0, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t fa[4];
    ldsm_a_trans(fa, at, LDP, kk * 16, k0);
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t fb[4];
      ldsm_b_kmajor(fb, b, LDQ, kk * 16, dp * 16);
      mma_bf16(o[2 * dp], fa, fb[0], fb[1]);
      mma_bf16(o[2 * dp + 1], fa, fb[2], fb[3]);
    }
  }
}

// Shared-memory regions the attention backward's head-pair loop works in
// (K4b's).
struct AttnSmem {
  const bf16* abuf;  // LN1 output xn (64 x cp)
  const bf16* dbuf;  // the cotangent at h, bf16 (64 x cp)
  bf16 *qkv, *dop, *prob, *dsb, *dpair, *ring;
  const float* vec;  // ln1_w | ln1_b | bqkv
  const int* qmap;
  float* slot;
  int lda;
};

// The attention backward's head-pair loop, shared by K4/K9c and K4b: per
// pair of heads, recompute q, k, v and the softmax, write the attention
// output (p.att), the window's bias-table gradient (p.dbias), dq | dk | dv
// (p.dqkv) and dbqkv's columns (vout), and accumulate dxn = dqkv . wqkv^T
// in registers. `mask`: the window's (64, 64) shift mask, or null.
template <int NCH>
__device__ __forceinline__ void attn_pairs(float (&dxn)[NCH][4][4], const AttnParams& p,
                                           const AttnSmem& sm, float* vout, const float* mask,
                                           size_t win) {
  const int C = p.c, CP = p.cp, heads = p.heads, hd = p.hd;
  const int lda = sm.lda;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 32, g = lane >> 2, tig = lane & 3;
  const int nkc = (CP + TILE - 1) / TILE;
  const size_t row0 = win * N;
  const int hl = warp >> 2;  // the warp's head within a pair
  const bf16 *abuf = sm.abuf, *dbuf = sm.dbuf;
  bf16 *qkv = sm.qkv, *dop = sm.dop, *prob = sm.prob, *dsb = sm.dsb, *dpair = sm.dpair,
       *ring = sm.ring;
  const float* vec = sm.vec;
  const int* qmap = sm.qmap;
  float* slot = sm.slot;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < 4; ++i) dxn[ch][i][0] = dxn[ch][i][1] = dxn[ch][i][2] = dxn[ch][i][3] = 0.f;

  const float qscale = round_bf16(p.scale);
  for (int h0 = 0; h0 < heads; h0 += 2) {
    const int seg = min(2, heads - h0) * hd;  // the pair's columns of q (or k, v, attn)
    const bool lo = c0 < seg, hi = c0 + 16 < seg;
    zero_smem(dpair, sizeof(bf16) * 3 * N * LDT);

    // ---- q, k, v of the pair (as K1) and do = bf16(dh . wproj[pair, :]^T)
    float acc[4][4];
    pipeline(
        4 * nkc, ring,
        [&](int s) {
          const int which = s / nkc, kc = s - which * nkc;
          if (which < 3)
            return Tile{p.wqkv, 3 * C, kc * TILE, min(TILE, C - kc * TILE), which * C + h0 * hd,
                        seg};
          return Tile{p.wproj, C, h0 * hd, seg, kc * TILE, min(TILE, C - kc * TILE)};
        },
        [&](int s, const bf16* t) {
          const int which = s / nkc, kc = s - which * nkc;
          if (kc == 0) {
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
          }
          if (!lo) return;
          const int ks = min(TILE, CP - kc * TILE) / 16;
          if (which < 3) mma_tile(acc, abuf + kc * TILE, lda, ks, t, hi);
          else mma_tile_nt(acc, dbuf + kc * TILE, lda, ks, t, hi);
          if (kc != nkc - 1) return;
          const int base = which * C + h0 * hd;
          for_pairs(acc, 0, hi, [&](int r, int c, float v0, float v1) {
            const float v[2] = {v0, v1};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (c + e >= seg) continue;
              const int at = qmap[c + e] + r * LDQ;
              if (which == 3) {
                dop[at] = __float2bfloat16(v[e]);
                continue;
              }
              const float y = round_bf16(v[e] + vec[2 * C + base + c + e]);
              if (which == 0) {
                qkv[S_Q * 2 * N * LDQ + at] = __float2bfloat16(y);
                qkv[S_QS * 2 * N * LDQ + at] = __float2bfloat16(y * qscale);
              } else {
                qkv[(which + 1) * 2 * N * LDQ + at] = __float2bfloat16(y);
              }
            }
          });
        });

    // ---- per head (warps 0-3: head h0, 4-7: h0+1), 16 query rows per warp:
    // a = softmax(qs.k^T + bias); attention output a.v; da = do.v^T;
    // ds = a * (da - rowsum(da * a)); dq = ds.k * scale
    const int head = h0 + hl;
    const bf16* qh = qkv + (S_Q * 2 + hl) * N * LDQ;
    const bf16* qsh = qkv + (S_QS * 2 + hl) * N * LDQ;
    const bf16* kh = qkv + (S_K * 2 + hl) * N * LDQ;
    const bf16* vh = qkv + (S_V * 2 + hl) * N * LDQ;
    const bf16* doh = dop + hl * N * LDQ;
    bf16* ph = prob + hl * N * LDP;
    bf16* dsh = dsb + hl * N * LDP;
    if (head < heads) {
      const float* bh = p.bias + (size_t)head * N * N;
      float a[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t) {  // the bias (and mask) is the accumulator's starting value
        float2 b0 = *reinterpret_cast<const float2*>(bh + (r0 + g) * N + t * 8 + tig * 2);
        float2 b1 = *reinterpret_cast<const float2*>(bh + (r0 + g + 8) * N + t * 8 + tig * 2);
        if (mask != nullptr) {
          const float2 m0 =
              *reinterpret_cast<const float2*>(mask + (r0 + g) * N + t * 8 + tig * 2);
          const float2 m1 =
              *reinterpret_cast<const float2*>(mask + (r0 + g + 8) * N + t * 8 + tig * 2);
          b0.x += m0.x; b0.y += m0.y; b1.x += m1.x; b1.y += m1.y;
        }
        a[t][0] = b0.x; a[t][1] = b0.y; a[t][2] = b1.x; a[t][3] = b1.y;
      }
      rows_nt(a, qsh, kh, r0);
      float m0 = a[0][0], m1 = a[0][2];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
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
      for (int t = 0; t < 8; ++t) {
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
      for (int t = 0; t < 8; ++t) {
        a[t][0] /= l0; a[t][1] /= l0;
        a[t][2] /= l1; a[t][3] /= l1;
        *reinterpret_cast<uint32_t*>(ph + (r0 + g) * LDP + t * 8 + tig * 2) =
            pack_bf16(a[t][0], a[t][1]);
        *reinterpret_cast<uint32_t*>(ph + (r0 + g + 8) * LDP + t * 8 + tig * 2) =
            pack_bf16(a[t][2], a[t][3]);
      }
      {  // attention output, for dWproj
        float o[4][4] = {};
        rows_pv(o, a, vh);
        bf16* att = p.att + row0 * C + head * hd;
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = t * 8 + tig * 2 + (e & 1);
            if (d < hd) att[(r0 + g + 8 * (e >> 1)) * C + d] = __float2bfloat16(o[t][e]);
          }
      }
      float da[8][4] = {};
      rows_nt(da, doh, vh, r0);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        s0 += da[t][0] * a[t][0] + da[t][1] * a[t][1];
        s1 += da[t][2] * a[t][2] + da[t][3] * a[t][3];
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      float* db = p.dbias + (win * heads + head) * N * N;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        da[t][0] = a[t][0] * (da[t][0] - s0); da[t][1] = a[t][1] * (da[t][1] - s0);
        da[t][2] = a[t][2] * (da[t][2] - s1); da[t][3] = a[t][3] * (da[t][3] - s1);
        *reinterpret_cast<float2*>(db + (r0 + g) * N + t * 8 + tig * 2) =
            make_float2(da[t][0], da[t][1]);
        *reinterpret_cast<float2*>(db + (r0 + g + 8) * N + t * 8 + tig * 2) =
            make_float2(da[t][2], da[t][3]);
        *reinterpret_cast<uint32_t*>(dsh + (r0 + g) * LDP + t * 8 + tig * 2) =
            pack_bf16(da[t][0], da[t][1]);
        *reinterpret_cast<uint32_t*>(dsh + (r0 + g + 8) * LDP + t * 8 + tig * 2) =
            pack_bf16(da[t][2], da[t][3]);
      }
      float dq[4][4] = {};
      rows_pv(dq, da, kh);  // ds (rounded to bf16 as it is packed) . k
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dq[t][e] *= p.scale;
          const int d = t * 8 + tig * 2 + (e & 1);
          if (d < hd) dpair[(r0 + g + 8 * (e >> 1)) * LDT + hl * hd + d] = __float2bfloat16(dq[t][e]);
          else dq[t][e] = 0.f;
        }
      frag_colsum(dq, hl * hd, hl * hd + hd, slot + (warp & 3) * 3 * TILE);
    }
    __syncthreads();  // a and ds of both heads are in shared memory

    // ---- dk = ds^T . q * scale and dv = a^T . do, 16 key rows per warp
    if (head < heads) {
      float dk[4][4] = {}, dv[4][4] = {};
      rows_tn(dk, dsh, r0, qh);
      rows_tn(dv, ph, r0, doh);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dk[t][e] *= p.scale;
          const int d = t * 8 + tig * 2 + (e & 1), r = r0 + g + 8 * (e >> 1);
          if (d < hd) {
            dpair[N * LDT + r * LDT + hl * hd + d] = __float2bfloat16(dk[t][e]);
            dpair[2 * N * LDT + r * LDT + hl * hd + d] = __float2bfloat16(dv[t][e]);
          } else {
            dk[t][e] = dv[t][e] = 0.f;
          }
        }
      frag_colsum(dk, TILE + hl * hd, TILE + hl * hd + hd, slot + (warp & 3) * 3 * TILE);
      frag_colsum(dv, 2 * TILE + hl * hd, 2 * TILE + hl * hd + hd,
                     slot + (warp & 3) * 3 * TILE);
    }
    __syncthreads();
    // dbqkv of the pair's columns; dq | dk | dv to global for dWqkv
    for (int i = tid; i < 3 * seg; i += THREADS) {
      const int which = i / seg, col = i - which * seg, sc = which * TILE + col;
      vout[which * C + h0 * hd + col] = ((slot[sc] + slot[3 * TILE + sc]) +
                                         slot[6 * TILE + sc]) + slot[9 * TILE + sc];
    }
    for (int i = tid; i < 3 * N * seg; i += THREADS) {
      const int which = i / (N * seg), rem = i - which * N * seg, r = rem / seg,
                col = rem - r * seg;
      p.dqkv[(row0 + r) * 3 * C + which * C + h0 * hd + col] =
          dpair[which * N * LDT + r * LDT + col];
    }

    // ---- dxn += [dq | dk | dv] . wqkv[:, pair columns]^T
    pipeline(
        3 * NCH, ring,
        [&](int s) {
          const int which = s / NCH, ch = s - which * NCH;
          return Tile{p.wqkv, 3 * C, ch * TILE, min(TILE, C - ch * TILE), which * C + h0 * hd,
                      seg};
        },
        [&](int s, const bf16* t) {
          const int which = s / NCH, chunk = s - which * NCH, nc = C - chunk * TILE;
          if (c0 >= nc) return;
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch)
            if (ch == chunk)
              mma_tile_nt(dxn[ch], dpair + which * N * LDT, LDT, round16(seg) / 16, t,
                          c0 + 16 < nc);
        });
  }
}

template <typename P>
cudaError_t launch_window(void (*kernel)(P), int bw, size_t smem, cudaStream_t s, const P& p) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<bw, THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

inline bool widths_ok(int c, int heads) {
  const int hd = heads > 0 ? c / heads : 0;
  return c > 0 && c <= MAX_C && c % 4 == 0 && heads > 0 && c % heads == 0 && hd <= DP &&
         hd % 2 == 0 && (heads % 2 == 0 || hd % 4 == 0);
}

inline bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

inline MlpParams mlp_params(const void* h, const void* dout, const void* ln2_w,
                            const void* ln2_b, const void* w1, const void* b1, const void* w2,
                            void* dh, void* hn, void* g, void* du, void* vec, int c,
                            int hidden) {
  MlpParams p = {};
  p.h = static_cast<const bf16*>(h);
  p.dout = static_cast<const bf16*>(dout);
  p.ln2_w = static_cast<const float*>(ln2_w);
  p.ln2_b = static_cast<const float*>(ln2_b);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.dh = static_cast<bf16*>(dh);
  p.hn = static_cast<bf16*>(hn);
  p.g = static_cast<bf16*>(g);
  p.du = static_cast<bf16*>(du);
  p.vec = static_cast<float*>(vec);
  p.c = p.cio = c;
  p.hidden = hidden;
  return p;
}

inline AttnParams attn_params(const void* x, const void* dh, const void* ln1_w,
                              const void* ln1_b, const void* wqkv, const void* bqkv,
                              const void* bias, const void* wproj, void* dx, void* xn, void* att,
                              void* dqkv, void* vec, void* dbias, int c, int heads, float scale) {
  AttnParams p = {};
  p.x = static_cast<const bf16*>(x);
  p.dh = static_cast<const bf16*>(dh);
  p.ln1_w = static_cast<const float*>(ln1_w);
  p.ln1_b = static_cast<const float*>(ln1_b);
  p.wqkv = static_cast<const bf16*>(wqkv);
  p.bqkv = static_cast<const float*>(bqkv);
  p.bias = static_cast<const float*>(bias);
  p.wproj = static_cast<const bf16*>(wproj);
  p.dx = static_cast<bf16*>(dx);
  p.xn = static_cast<bf16*>(xn);
  p.att = static_cast<bf16*>(att);
  p.dqkv = static_cast<bf16*>(dqkv);
  p.vec = static_cast<float*>(vec);
  p.dbias = static_cast<float*>(dbias);
  p.c = p.cio = c;
  p.heads = heads;
  p.nw = 1;
  p.scale = scale;
  return p;
}

}  // namespace swin
