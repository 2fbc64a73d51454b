// Backward of the fused Swin transformer block and of HAT's HAB for Hopper,
// bf16 activations and weights, fp32 sums.
//
// K3 replaces superresolution_def_tpu/kernels/swin_block.py::_bwd_mlp (body
// _bwd_mlp_kernel): the LN2 + MLP backward from the saved h.
// K4 replaces ::_bwd_attn (body _make_bwd_attn_kernel, its per-head branch):
// the attention + LN1 backward, recomputing LN1, qkv and each head's softmax
// from x.
// K9b and K9c are the same two window kernels run for HAT's HAB
// (superresolution_def_tpu/kernels/hab_train.py::_hab_bwd_mlp and
// ::_hab_bwd_attn, bodies _hab_bwd_mlp_kernel and _make_hab_bwd_attn_kernel);
// K9b also serves the OCAB tail (ocab_train.py, with a unit scale). They add:
//   - a second width, as K5 has it: the kernels run at the padded width c
//     (HAT's 90 columns and 15-wide heads padded to 96 and 16 by the
//     wrapper, with zeros) while the windows keep cio columns in device
//     memory and the LayerNorm statistics and their backward run over those
//     cio; the padded columns of every cotangent come out exactly zero;
//   - a per-window branch scale (the drop-path dp2 of the MLP, dp1 of the
//     attention): the cotangent entering the branch is bf16(dp * d) and its
//     bias gradient dp * sum(d), while the residual passes d through
//     unscaled (dh = LN2^T(...) + dout, dx = LN1^T(...) + dh). The scaled
//     cotangent is also written at width c for the weight-gradient product;
//   - K9c: the (nW, 64, 64) shift mask in the softmax recompute, window w
//     reading mask[w mod nW] as K5/K9a do.
//
// On the TPU the grid runs in order and every weight gradient accumulates
// into one revisited output block. Hopper runs the blocks in parallel, so
// each backward is three steps here, all in this file and all in a fixed
// summation order (bit-reproducible runs, no atomics):
//
//   1. a window kernel (one thread block per 8x8 window, 8 warps) computes
//      everything that is per token: dh (K3) or dx (K4), and writes the
//      bf16 operands of the weight-gradient products (K3: LN2 output hn,
//      GELU output g, du; K4: LN1 output xn, attention output, dq|dk|dv)
//      plus one fp32 row per window of its bias and LayerNorm gradients
//      (K4 also the window's (heads, 64, 64) bias-table gradient);
//   2. wgrad_kernel: dW = A^T . B over all Bw*64 tokens, bf16 operands and
//      fp32 sums, each thread block summing one 64x64 tile over one
//      contiguous slice of tokens into its own partial;
//   3. colsum_kernel: sums the partials, and the per-window rows, in order.
//
// Rounding points follow the TPU kernels: the operands of every product are
// the bf16 values the TPU kernel feeds its dots (hn, g, dout, du; xn, do,
// a, ds, q, k, v, dh, dq|dk|dv, attention output), everything else fp32;
// dh and dx are rounded to bf16 once, at the end. q is scaled and rounded
// before QK^T; dq and dk carry the scale in fp32; dk uses the unscaled q.
//
// What bounds them: at the flagship widths (C=180, 6 heads, hidden 720) K3
// does 82.9 MFLOP and K4 54.5 MFLOP per window against 46 KB of window
// input and output, so both are compute-bound (0.172 and 0.113 ms at
// Bw=2048 at the bf16 peak). This first design is far from that: the
// intermediates of step 1 go through device memory (K3 writes 0.42 and K4
// 0.49 GB at Bw=2048 that the TPU kernel keeps in VMEM), the window kernel
// streams every weight through a 2-deep cp.async ring with one barrier per
// 64x64 tile as K1 does, and products run on mma.sync, not wgmma.

#include "swin_common.cuh"

namespace {

using namespace swin;

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
  int c, cp, cio, hidden;
};

struct MlpLayout {
  int lda;
  size_t hs, a, d, mid, ring, vec, stats, red, slot, total;
};

__host__ __device__ inline MlpLayout mlp_layout(int c, int cp, int hidden) {
  MlpLayout L;
  L.lda = cp + 8;
  size_t o = 0;
  L.hs = o;    o += align128(sizeof(bf16) * N * c);          // h window (cio <= c wide)
  L.a = o;     o += align128(sizeof(bf16) * N * L.lda);      // hn
  L.d = o;     o += align128(sizeof(bf16) * N * L.lda);      // dout
  L.mid = o;   o += align128(sizeof(bf16) * N * LDT);        // du chunk
  L.ring = o;  o += align128(sizeof(bf16) * STAGES * TILE * LDT);
  L.vec = o;   o += align128(sizeof(float) * (2 * c + hidden));  // ln2 w, b; b1
  L.stats = o; o += align128(sizeof(float) * 2 * N);         // LN2 mean, 1/std
  L.red = o;   o += align128(sizeof(float) * 2 * N);
  L.slot = o;  o += align128(sizeof(float) * 4 * (cp > TILE ? cp : TILE));  // column sums
  L.total = o;
  return L;
}

__device__ __forceinline__ float gelu_tanh_grad(float u) {
  const float s = 0.7978845608028654f * (u + 0.044715f * u * u * u);
  const float t = tanhf(s);
  const float ds = 0.7978845608028654f * (1.0f + 3.0f * 0.044715f * u * u);
  return 0.5f * (1.0f + t) + 0.5f * u * (1.0f - t * t) * ds;
}

template <int NCH>
__global__ void __launch_bounds__(THREADS, 1) mlp_bwd_kernel(const MlpParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = p.c, CP = p.cp, CIO = p.cio, hidden = p.hidden;
  const MlpLayout L = mlp_layout(C, CP, hidden);
  bf16* hs = reinterpret_cast<bf16*>(smem + L.hs);
  bf16* abuf = reinterpret_cast<bf16*>(smem + L.a);
  bf16* dbuf = reinterpret_cast<bf16*>(smem + L.d);
  bf16* mid = reinterpret_cast<bf16*>(smem + L.mid);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  float* vec = reinterpret_cast<float*>(smem + L.vec);
  float* stats = reinterpret_cast<float*>(smem + L.stats);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* slot = reinterpret_cast<float*>(smem + L.slot);
  const int lda = L.lda;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 32, g = lane >> 2, tig = lane & 3;
  const int nkc = (CP + TILE - 1) / TILE;
  const size_t win = blockIdx.x;
  const size_t row0 = win * N;  // first token row of the window
  float* vout = p.vec + win * (hidden + 3 * C);
  const float dscale = p.dp != nullptr ? __ldg(p.dp + win) : 1.f;
  const bf16* dout = p.dout + row0 * CIO;

  {
    const uint4* src = reinterpret_cast<const uint4*>(p.h + row0 * CIO);
    uint4* dst = reinterpret_cast<uint4*>(hs);
    for (int i = tid; i < N * CIO / 8; i += THREADS) dst[i] = __ldg(src + i);
    stage_padded(dbuf, lda, dout, CIO, CP, dscale);
    for (int i = tid; i < C; i += THREADS) {
      vec[i] = __ldg(p.ln2_w + i);
      vec[C + i] = __ldg(p.ln2_b + i);
    }
    for (int i = tid; i < hidden; i += THREADS) vec[2 * C + i] = __ldg(p.b1 + i);
  }
  __syncthreads();
  layer_norm_rows(
      abuf, lda, CIO, CP, [&](int r, int c) { return __bfloat162float(hs[r * CIO + c]); }, vec,
      vec + C, stats);
  __syncthreads();
  store_window(p.hn + row0 * C, abuf, lda, C);
  if (p.dm != nullptr) store_window(p.dm + row0 * C, dbuf, lda, C);
  window_colsum(vout + hidden, dout, CIO, C, dscale);  // db2

  // ---- per 64-wide hidden chunk j: u = hn.w1[:, j] + b1, dg = dout.w2[j, :]^T,
  // du = dg * gelu'(u) -> g, du to global and du to `mid`; then
  // dhn += du . w1[:, j]^T into registers
  float dhn[NCH][4][4];
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
                    const float uu = accu[tt][e] + vec[2 * C + j * TILE + col];
                    const float d = accg[tt][e] * gelu_tanh_grad(uu);
                    const size_t gi = (row0 + r) * hidden + j * TILE + col;
                    p.g[gi] = __float2bfloat16(gelu_tanh(uu));
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

  // ---- LN2 backward: dln2s, dln2b, dh = rstd * (dxh - mean(dxh) - xhat *
  // mean(dxh * xhat)) + dout, with dxh = dhn * ln2_w
  float mu[2], rstd[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mu[half] = stats[r0 + g + 8 * half];
    rstd[half] = stats[N + r0 + g + 8 * half];
  }
  auto col_of = [&](int ch, int t, int e) { return ch * TILE + c0 + t * 8 + tig * 2 + (e & 1); };
  auto xhat = [&](int ch, int t, int e) {
    const int col = col_of(ch, t, e), r = r0 + g + 8 * (e >> 1);
    return col < CIO ? (__bfloat162float(hs[r * CIO + col]) - mu[e >> 1]) * rstd[e >> 1] : 0.f;
  };
  tile_colsum<NCH>(vout + hidden + C, slot, C, CP,
                   [&](int ch, int t, int e) { return dhn[ch][t][e] * xhat(ch, t, e); });
  tile_colsum<NCH>(vout + hidden + 2 * C, slot, C, CP,
                   [&](int ch, int t, int e) { return dhn[ch][t][e]; });
  auto dxh = [&](int ch, int t, int e) {
    const int col = col_of(ch, t, e);
    return col < CIO ? dhn[ch][t][e] * vec[col] : 0.f;
  };
  float s1[2], s2[2];
  row_sums<NCH>(s1, red, CIO, dxh);
  row_sums<NCH>(s2, red, CIO,
                [&](int ch, int t, int e) { return dxh(ch, t, e) * xhat(ch, t, e); });
  bf16* dh = p.dh + row0 * CIO;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + 8 * half, col = ch * TILE + c0 + t * 8 + tig * 2;
        if (col >= CIO) continue;  // col and CIO even: both columns are real
        const float2 res = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + r * CIO + col));
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ee = 2 * half + e;
          const float d = rstd[half] * (dxh(ch, t, ee) - s1[half] / CIO -
                                        xhat(ch, t, ee) * (s2[half] / CIO));
          v[e] = d + (e == 0 ? res.x : res.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(dh + r * CIO + col) =
            __floats2bfloat162_rn(v[0], v[1]);
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

struct AttnLayout {
  int lda;
  size_t a, d, qkv, dop, pr, dpair, ring, vec, stats, red, qmap, slot, total;
};

// q, q*scale, k, v of a head pair: slots 0..3, each [head][token][LDQ]
enum { S_Q, S_QS, S_K, S_V };

__host__ __device__ inline AttnLayout attn_layout(int c, int cp) {
  AttnLayout L;
  L.lda = cp + 8;
  size_t o = 0;
  L.a = o;     o += align128(sizeof(bf16) * N * L.lda);       // xn
  L.d = o;     o += align128(sizeof(bf16) * N * L.lda);       // dh
  L.qkv = o;   o += align128(sizeof(bf16) * 4 * 2 * N * LDQ);  // q, q*scale, k, v
  L.dop = o;   o += align128(sizeof(bf16) * 2 * N * LDQ);      // do of the pair
  L.pr = o;    o += align128(sizeof(bf16) * 2 * 2 * N * LDP);  // a, ds of the pair
  L.dpair = o; o += align128(sizeof(bf16) * 3 * N * LDT);      // dq | dk | dv of the pair
  L.ring = o;  o += align128(sizeof(bf16) * STAGES * TILE * LDT);
  L.vec = o;   o += align128(sizeof(float) * 5 * c);           // ln1 w, b; bqkv
  L.stats = o; o += align128(sizeof(float) * 2 * N);
  L.red = o;   o += align128(sizeof(float) * 2 * N);
  L.qmap = o;  o += align128(sizeof(int) * 2 * DP);
  L.slot = o;  o += align128(sizeof(float) * 4 * (3 * TILE > cp ? 3 * TILE : cp));
  L.total = o;
  return L;
}

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

template <int NCH>
__global__ void __launch_bounds__(THREADS, 1) attn_bwd_kernel(const AttnParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = p.c, CP = p.cp, CIO = p.cio, heads = p.heads, hd = p.hd;
  const AttnLayout L = attn_layout(C, CP);
  bf16* abuf = reinterpret_cast<bf16*>(smem + L.a);
  bf16* dbuf = reinterpret_cast<bf16*>(smem + L.d);
  bf16* qkv = reinterpret_cast<bf16*>(smem + L.qkv);
  bf16* dop = reinterpret_cast<bf16*>(smem + L.dop);
  bf16* prob = reinterpret_cast<bf16*>(smem + L.pr);            // [head][q][LDP]
  bf16* dsb = prob + 2 * N * LDP;                               // [head][q][LDP]
  bf16* dpair = reinterpret_cast<bf16*>(smem + L.dpair);        // [which][token][LDT]
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  float* vec = reinterpret_cast<float*>(smem + L.vec);          // ln1_w | ln1_b | bqkv
  float* stats = reinterpret_cast<float*>(smem + L.stats);
  float* red = reinterpret_cast<float*>(smem + L.red);
  int* qmap = reinterpret_cast<int*>(smem + L.qmap);
  float* slot = reinterpret_cast<float*>(smem + L.slot);
  const int lda = L.lda;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 32, g = lane >> 2, tig = lane & 3;
  const int nkc = (CP + TILE - 1) / TILE;
  const size_t win = blockIdx.x;
  const size_t row0 = win * N;
  const bf16* xw = p.x + row0 * CIO;
  const bf16* dhw = p.dh + row0 * CIO;
  float* vout = p.vec + win * 6 * C;
  const int hl = warp >> 2;  // the warp's head within a pair
  const float dscale = p.dp != nullptr ? __ldg(p.dp + win) : 1.f;
  const float* mask = p.mask != nullptr ? p.mask + (win % p.nw) * N * N : nullptr;

  zero_smem(qkv, sizeof(bf16) * 4 * 2 * N * LDQ);
  zero_smem(dop, sizeof(bf16) * 2 * N * LDQ);
  stage_padded(dbuf, lda, dhw, CIO, CP, dscale);
  for (int i = tid; i < C; i += THREADS) {
    vec[i] = __ldg(p.ln1_w + i);
    vec[C + i] = __ldg(p.ln1_b + i);
  }
  for (int i = tid; i < 3 * C; i += THREADS) vec[2 * C + i] = __ldg(p.bqkv + i);
  for (int j = tid; j < 2 * hd; j += THREADS) qmap[j] = (j / hd) * N * LDQ + j % hd;
  __syncthreads();
  layer_norm_rows(
      abuf, lda, CIO, CP, [&](int r, int c) { return __bfloat162float(xw[r * CIO + c]); }, vec,
      vec + C, stats);
  window_colsum(vout + 3 * C, dhw, CIO, C, dscale);  // dbproj
  __syncthreads();
  store_window(p.xn + row0 * C, abuf, lda, C);
  if (p.dhs != nullptr) store_window(p.dhs + row0 * C, dbuf, lda, C);

  float dxn[NCH][4][4];
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

  // ---- LN1 backward: dln1s, dln1b, dx = rstd * (dxh - mean(dxh) - xhat *
  // mean(dxh * xhat)) + dh, with dxh = dxn * ln1_w
  float mu[2], rstd[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mu[half] = stats[r0 + g + 8 * half];
    rstd[half] = stats[N + r0 + g + 8 * half];
  }
  auto col_of = [&](int ch, int t, int e) { return ch * TILE + c0 + t * 8 + tig * 2 + (e & 1); };
  auto xhat = [&](int ch, int t, int e) {
    const int col = col_of(ch, t, e), r = r0 + g + 8 * (e >> 1);
    return col < CIO ? (__bfloat162float(xw[r * CIO + col]) - mu[e >> 1]) * rstd[e >> 1] : 0.f;
  };
  tile_colsum<NCH>(vout + 4 * C, slot, C, CP,
                   [&](int ch, int t, int e) { return dxn[ch][t][e] * xhat(ch, t, e); });
  tile_colsum<NCH>(vout + 5 * C, slot, C, CP, [&](int ch, int t, int e) { return dxn[ch][t][e]; });
  auto dxh = [&](int ch, int t, int e) {
    const int col = col_of(ch, t, e);
    return col < CIO ? dxn[ch][t][e] * vec[col] : 0.f;
  };
  float s1[2], s2[2];
  row_sums<NCH>(s1, red, CIO, dxh);
  row_sums<NCH>(s2, red, CIO,
                [&](int ch, int t, int e) { return dxh(ch, t, e) * xhat(ch, t, e); });
  bf16* dx = p.dx + row0 * CIO;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + 8 * half, col = ch * TILE + c0 + t * 8 + tig * 2;
        if (col >= CIO) continue;  // col and CIO even: both columns are real
        const float2 res = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dhw + r * CIO + col));
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ee = 2 * half + e;
          const float d = rstd[half] * (dxh(ch, t, ee) - s1[half] / CIO -
                                        xhat(ch, t, ee) * (s2[half] / CIO));
          v[e] = d + (e == 0 ? res.x : res.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(dx + r * CIO + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
}

// ===========================================================================
// Weight gradients and ordered column sums.
// ===========================================================================

// part[split][m][n] = sum over tokens t of this split's slice of a[t][m] * b[t][n]
// (a: (T, M), b: (T, N) bf16 row-major; fp32 sums in token order within each
// 64-token step). Grid (ceil(N/64), ceil(M/64), splits).
__global__ void __launch_bounds__(THREADS) wgrad_kernel(const bf16* a, const bf16* b, int T,
                                                        int M, int Nn, int rows_per_split,
                                                        float* part) {
  __shared__ __align__(128) bf16 as[STAGES][TILE * LDT];
  __shared__ __align__(128) bf16 bs[STAGES][TILE * LDT];
  const int warp = threadIdx.x >> 5;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 32;
  const int n0 = blockIdx.x * TILE, m0 = blockIdx.y * TILE;
  const int t0 = blockIdx.z * rows_per_split;
  const int steps = (min(T, t0 + rows_per_split) - t0) / TILE;
  const int mn = min(TILE, M - m0), nn = min(TILE, Nn - n0);
  const bool hi = c0 + 16 < nn;
  auto issue = [&](int s) {
    if (s < steps) {
      issue_tile(as[s % STAGES], a, M, t0 + s * TILE, TILE, m0, mn);
      issue_tile(bs[s % STAGES], b, Nn, t0 + s * TILE, TILE, n0, nn);
    }
    cp_async_commit();
  };
  float acc[4][4] = {};
  issue(0);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();
    __syncthreads();
    issue(s + 1);
    if (c0 < nn && r0 < mn) {
      const bf16* at = as[s % STAGES];
      const bf16* bt = bs[s % STAGES];
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        uint32_t fa[4], fb[4];
        ldsm_a_trans(fa, at, LDT, kk * 16, r0);
        ldsm_b_kmajor(fb, bt, LDT, kk * 16, c0);
        mma_bf16(acc[0], fa, fb[0], fb[1]);
        mma_bf16(acc[1], fa, fb[2], fb[3]);
        if (hi) {
          ldsm_b_kmajor(fb, bt, LDT, kk * 16, c0 + 16);
          mma_bf16(acc[2], fa, fb[0], fb[1]);
          mma_bf16(acc[3], fa, fb[2], fb[3]);
        }
      }
    }
  }
  float* out = part + (size_t)blockIdx.z * M * Nn;
  for_pairs(acc, 0, hi, [&](int r, int c, float v0, float v1) {
    if (m0 + r >= M) return;
    if (c < nn) out[(size_t)(m0 + r) * Nn + n0 + c] = v0;
    if (c + 1 < nn) out[(size_t)(m0 + r) * Nn + n0 + c + 1] = v1;
  });
}

// out[s][n] = sum of in[r][n] over rows r of slice s (rows_per_split rows),
// in ascending r. Grid (ceil(N/256), slices).
__global__ void __launch_bounds__(THREADS) colsum_kernel(const float* in, int R, int Nn,
                                                         int rows_per_split, float* out) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= Nn) return;
  const int r1 = min(R, (int)(blockIdx.y + 1) * rows_per_split);
  float s = 0.f;
  for (int r = blockIdx.y * rows_per_split; r < r1; ++r) s += in[(size_t)r * Nn + n];
  out[(size_t)blockIdx.y * Nn + n] = s;
}

template <typename P>
cudaError_t launch_window(void (*kernel)(P), int bw, size_t smem, cudaStream_t s, const P& p) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<bw, THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

bool widths_ok(int c, int heads) {
  const int hd = heads > 0 ? c / heads : 0;
  return c > 0 && c <= MAX_C && c % 4 == 0 && heads > 0 && c % heads == 0 && hd <= DP &&
         hd % 2 == 0 && (heads % 2 == 0 || hd % 4 == 0);
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// K3 / K9b: checks the widths and alignments and launches bw windows.
int run_mlp(MlpParams p, int bw, void* stream) {
  const int c = p.c, cio = p.cio, hidden = p.hidden;
  if (bw <= 0 || c <= 0 || c > MAX_C || c % 4 != 0 || cio <= 0 || cio > c || cio % 2 != 0 ||
      hidden <= 0 || hidden % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned(p.h, 16) || !aligned(p.dout, 4) || !aligned(p.w1, 8) || !aligned(p.w2, 8) ||
      !aligned(p.dh, 4))
    return (int)cudaErrorMisalignedAddress;
  p.cp = round16(c);
  const size_t smem = mlp_layout(c, p.cp, hidden).total;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((c + TILE - 1) / TILE) {
    case 1: return (int)launch_window(mlp_bwd_kernel<1>, bw, smem, s, p);
    case 2: return (int)launch_window(mlp_bwd_kernel<2>, bw, smem, s, p);
    case 3: return (int)launch_window(mlp_bwd_kernel<3>, bw, smem, s, p);
    default: return (int)launch_window(mlp_bwd_kernel<4>, bw, smem, s, p);
  }
}

// K4 / K9c: checks the widths and alignments and launches bw windows.
int run_attn(AttnParams p, int bw, void* stream) {
  if (bw <= 0 || !widths_ok(p.c, p.heads) || p.cio <= 0 || p.cio > p.c || p.cio % 2 != 0 ||
      (p.mask != nullptr && p.nw <= 0))
    return (int)cudaErrorInvalidValue;
  if (!aligned(p.x, 2) || !aligned(p.dh, 4) || !aligned(p.wqkv, 8) || !aligned(p.wproj, 8) ||
      !aligned(p.bias, 8) || !aligned(p.mask, 8) || !aligned(p.dx, 4) || !aligned(p.dbias, 8))
    return (int)cudaErrorMisalignedAddress;
  p.cp = round16(p.c);
  p.hd = p.c / p.heads;
  const size_t smem = attn_layout(p.c, p.cp).total;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((p.c + TILE - 1) / TILE) {
    case 1: return (int)launch_window(attn_bwd_kernel<1>, bw, smem, s, p);
    case 2: return (int)launch_window(attn_bwd_kernel<2>, bw, smem, s, p);
    case 3: return (int)launch_window(attn_bwd_kernel<3>, bw, smem, s, p);
    default: return (int)launch_window(attn_bwd_kernel<4>, bw, smem, s, p);
  }
}

MlpParams mlp_params(const void* h, const void* dout, const void* ln2_w, const void* ln2_b,
                     const void* w1, const void* b1, const void* w2, void* dh, void* hn, void* g,
                     void* du, void* vec, int c, int hidden) {
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

AttnParams attn_params(const void* x, const void* dh, const void* ln1_w, const void* ln1_b,
                       const void* wqkv, const void* bqkv, const void* bias, const void* wproj,
                       void* dx, void* xn, void* att, void* dqkv, void* vec, void* dbias, int c,
                       int heads, float scale) {
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

}  // namespace

// C entry points, bound with ctypes. Each returns a cudaError_t: the launch
// is asynchronous on `stream`, so 0 means the kernel was accepted.

// K3's window kernel. h, dout: (bw, 64, c) bf16; ln2 w/b, b1 fp32; w1 (c,
// hidden), w2 (hidden, c) bf16. Writes dh (bw, 64, c), hn (bw*64, c), g and
// du (bw*64, hidden) bf16 and vec (bw, hidden + 3c) fp32.
extern "C" int swin_bwd_mlp_bf16(const void* h, const void* dout, const void* ln2_w,
                                 const void* ln2_b, const void* w1, const void* b1,
                                 const void* w2, void* dh, void* hn, void* g, void* du, void* vec,
                                 int bw, int c, int hidden, void* stream) {
  return run_mlp(mlp_params(h, dout, ln2_w, ln2_b, w1, b1, w2, dh, hn, g, du, vec, c, hidden),
                 bw, stream);
}

// K9b's window kernel: K3 at the padded width c with windows h, dout and dh
// of cio columns, the MLP branch scaled by dp (bw,) fp32 (null: 1), and
// dm = bf16(dp * dout) (bw*64, c) written for dW2.
extern "C" int hab_bwd_mlp_bf16(const void* h, const void* dout, const void* dp,
                                const void* ln2_w, const void* ln2_b, const void* w1,
                                const void* b1, const void* w2, void* dh, void* hn, void* g,
                                void* du, void* dm, void* vec, int bw, int c, int cio, int hidden,
                                void* stream) {
  MlpParams p = mlp_params(h, dout, ln2_w, ln2_b, w1, b1, w2, dh, hn, g, du, vec, c, hidden);
  p.cio = cio;
  p.dp = static_cast<const float*>(dp);
  p.dm = static_cast<bf16*>(dm);
  return run_mlp(p, bw, stream);
}

// K4's window kernel. x, dh: (bw, 64, c) bf16; ln1 w/b, bqkv fp32; wqkv (c,
// 3c), wproj (c, c) bf16; bias (heads, 64, 64) fp32. Writes dx (bw, 64, c),
// xn and att (bw*64, c), dqkv (bw*64, 3c) bf16, vec (bw, 6c) and dbias (bw,
// heads, 64, 64) fp32.
extern "C" int swin_bwd_attn_bf16(const void* x, const void* dh, const void* ln1_w,
                                  const void* ln1_b, const void* wqkv, const void* bqkv,
                                  const void* bias, const void* wproj, void* dx, void* xn,
                                  void* att, void* dqkv, void* vec, void* dbias, int bw, int c,
                                  int heads, float scale, void* stream) {
  return run_attn(attn_params(x, dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, dx, xn, att, dqkv,
                              vec, dbias, c, heads, scale),
                  bw, stream);
}

// K9c's window kernel: K4 at the padded width c (heads of c / heads columns)
// with windows x, dh and dx of cio columns, the (nw, 64, 64) mask (null:
// none), the attention branch scaled by dp (bw,) fp32 (null: 1), and
// dhs = bf16(dp * dh) (bw*64, c) written for dWproj.
extern "C" int hab_bwd_attn_bf16(const void* x, const void* dh, const void* dp, const void* mask,
                                 const void* ln1_w, const void* ln1_b, const void* wqkv,
                                 const void* bqkv, const void* bias, const void* wproj, void* dx,
                                 void* xn, void* att, void* dqkv, void* dhs, void* vec,
                                 void* dbias, int bw, int c, int cio, int heads, int nw,
                                 float scale, void* stream) {
  AttnParams p = attn_params(x, dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, dx, xn, att, dqkv,
                             vec, dbias, c, heads, scale);
  p.cio = cio;
  p.dp = static_cast<const float*>(dp);
  p.mask = static_cast<const float*>(mask);
  p.nw = nw;
  p.dhs = static_cast<bf16*>(dhs);
  return run_attn(p, bw, stream);
}

// part (splits, m, n) fp32 = per-slice a^T . b, a (t, m) and b (t, n) bf16;
// t a multiple of 64, rows_per_split a multiple of 64, m and n multiples of 4.
extern "C" int swin_wgrad_bf16(const void* a, const void* b, int t, int m, int n,
                               int rows_per_split, int splits, void* part, void* stream) {
  if (t <= 0 || t % TILE != 0 || rows_per_split <= 0 || rows_per_split % TILE != 0 ||
      splits <= 0 || (long long)(splits - 1) * rows_per_split >= t || m <= 0 || m % 4 != 0 ||
      n <= 0 || n % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned(a, 8) || !aligned(b, 8)) return (int)cudaErrorMisalignedAddress;
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE, splits);
  wgrad_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), t, m, n, rows_per_split,
      static_cast<float*>(part));
  return (int)cudaGetLastError();
}

// out (slices, n) fp32: sums of consecutive row slices of in (r, n), in order.
extern "C" int swin_colsum_f32(const void* in, int r, int n, int rows_per_split, void* out,
                               void* stream) {
  if (r <= 0 || n <= 0 || rows_per_split <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + THREADS - 1) / THREADS, (r + rows_per_split - 1) / rows_per_split);
  colsum_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), r, n, rows_per_split, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the two window kernels, for the wrappers' checks.
extern "C" size_t swin_bwd_mlp_smem_bytes(int c, int hidden) {
  return mlp_layout(c, round16(c), hidden).total;
}

extern "C" size_t swin_bwd_attn_smem_bytes(int c) { return attn_layout(c, round16(c)).total; }
