// The fused window-attention block kernel shared by swin_block.cu (K1, K2)
// and hab_block.cu (K5). One thread block computes one pre-rolled,
// pre-partitioned 8x8 window (N = 64 tokens) end to end:
//
//   LN1 (fp32 stats) -> QKV (+bqkv, rounded to bf16)
//   -> per head: softmax(q*scale . k^T + bias[h] (+ mask[w])) . v (softmax fp32)
//   -> proj (+bproj) -> h = x + dp1 * proj (+ conv_scale * conv_x)  (residual fp32)
//   -> LN2 of bf16(h) -> fc1 -> tanh GELU -> fc2 -> out = h + dp2 * mlp
//
// dp1 and dp2 are K9a's per-window drop-path scales of the two branches
// (one fp32 value per window); K1, K2, K5 and K6 run with both at 1.
//
// Every matrix product runs on the tensor cores (mma.sync m16n8k16 bf16 with
// fp32 accumulators, operands through ldmatrix). The fp32 residual h lives in
// the accumulator registers (proj and fc2 accumulate into it, LN2 reads it
// there), q/k/v are produced two heads at a time and consumed at once by
// register-resident attention, and the MLP streams its hidden dimension in
// 64-wide chunks; swin_block.cu's header says why.
//
// Two widths: `c` is the width of the weights and of the kernel's internal
// rows (heads * head_dim after the wrapper's zero padding), `cio` the width of
// the windows in device memory and of the LayerNorm statistics. K1/K2 have
// cio == c. K5 (HAT, C = 90, head_dim 15) gets c = 96: the wrapper pads each
// head's q/k/v columns 15 -> 16 and the channel rows 90 -> 96 with zeros, so
// padded q/k/v columns, proj/fc2 outputs and LN outputs are exactly zero and
// the real 90 columns see the unpadded arithmetic.
//
// K13 (swin_stage_ablation.cu) is this kernel with two compile-time
// switches, STAGE (which stages run) and ACT (the MLP's activation); their
// defaults are K1's, so every other kernel here compiles as before. K4b
// (swin_block_bwd.cu) reuses the first half, qkv_attention and
// proj_residual, to recompute the forward inside the backward.

#pragma once

#include "swin_common.cuh"

namespace swin {

struct Params {
  const bf16* x;
  const float* ln1_w;
  const float* ln1_b;
  const bf16* wqkv;
  const float* bqkv;
  const float* bias;
  const bf16* wproj;
  const float* bproj;
  const float* ln2_w;
  const float* ln2_b;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  bf16* out;
  bf16* h_out;        // K2 only: h rounded to bf16
  const bf16* convx;  // K5 only: the CAB branch in window layout (cio wide)
  const float* mask;  // K5 only: (nw, 64, 64) additive mask, or null (all zero)
  const float* dp1;   // K9a only: (bw,) branch scales, or null (all one)
  const float* dp2;
  int c, cp, cio, heads, hd, hidden, hidden_p, nw;
  float scale, conv_scale;
};

// K13's switches. STAGE_FULL runs the whole block; NOATTN feeds proj the
// unscaled q columns instead of the attention output; ATTNONLY stops at
// h = x + proj (out = h); MLPONLY starts at h = x. ACT picks the MLP's
// activation: K1's tanh GELU, the A&S erf GELU, none, x * sigmoid(1.702 x),
// or erf as a Horner polynomial in x / sqrt(2) clipped to [-4, 4].
enum Stage { STAGE_FULL, STAGE_NOATTN, STAGE_ATTNONLY, STAGE_MLPONLY };
enum Act { ACT_TANH, ACT_ERF, ACT_NONE, ACT_SIGMOID, ACT_POLY };

// Abramowitz-Stegun 7.1.26 rational erf (max abs error 1.5e-7), the JAX
// kernels' exact GELU: sign(x) (1 - t P(t) exp(-x^2)), t = 1 / (1 + p|x|)
__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float sgn = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return sgn * (1.0f - poly * expf(-ax * ax));
}

// K13's ACT_POLY erf polynomial, defined in swin_stage_ablation.cu (its
// coefficients live there, in constant memory): only that source
// instantiates ACT_POLY.
__device__ float erf_poly(float u);

template <int ACT>
__device__ __forceinline__ float activation(float x) {
  if constexpr (ACT == ACT_TANH) {
    return gelu_tanh(x);
  } else if constexpr (ACT == ACT_ERF) {
    return x * 0.5f * (1.0f + erf_as(x * 0.70710678118654752f));
  } else if constexpr (ACT == ACT_NONE) {
    return x;
  } else if constexpr (ACT == ACT_SIGMOID) {
    return x / (1.0f + expf(-1.702f * x));
  } else {
    return x * 0.5f * (1.0f + erf_poly(fminf(fmaxf(x * 0.70710678118654752f, -4.0f), 4.0f)));
  }
}

// fp32 vectors staged in shared memory once per window, at these offsets (in
// units of C, b1 last): the epilogues and LayerNorms read them there
enum { V_LN1W, V_LN1B, V_BQKV, V_BPROJ = 5, V_LN2W, V_LN2B, V_B2, V_B1 };

// Shared-memory regions, 128-byte aligned. Row strides are 16-byte multiples
// whose rows fall on distinct 16-byte bank groups, as ldmatrix needs.
struct Layout {
  int lda;  // bf16 row stride of the two 64 x cp activation buffers
  size_t a, attn, big, ring, vec, red, qmap, total;
};

__host__ __device__ inline Layout make_layout(int c, int cp, int hidden_p) {
  Layout L;
  L.lda = cp + 8;
  const size_t qkv = sizeof(bf16) * 3 * 2 * N * LDQ;  // q, k, v of two heads
  const size_t mid = sizeof(bf16) * N * LDT;          // one 64-wide MLP chunk
  size_t o = 0;
  L.a = o;    o += align128(sizeof(bf16) * N * L.lda);   // LN1 out | LN2 out
  L.attn = o; o += align128(sizeof(bf16) * N * L.lda);   // x window | attention out
  L.big = o;  o += align128(qkv > mid ? qkv : mid);      // q, k, v | MLP chunk
  L.ring = o; o += align128(sizeof(bf16) * STAGES * TILE * LDT);  // weight tiles
  L.vec = o;  o += align128(sizeof(float) * (V_B1 * c + hidden_p));  // LN params, biases
  L.red = o;  o += align128(sizeof(float) * 2 * N);      // LN2 partial row sums
  L.qmap = o; o += align128(sizeof(int) * 2 * DP);       // pair column -> q/k/v offset
  L.total = o;
  return L;
}

// Attention of one head for the 16 query rows q0..q0+15 of this warp, all in
// registers, against nk <= 16 * NKT keys (nk even): S = q k^T + bias (+ mask)
// (16 x nk, fp32; bias and mask rows nk apart), softmax over keys in fp32
// with keys past nk at -inf, P rounded to bf16, O = P v (16 x 32). k and v
// are stored [token][d] with 16 * NKT rows (rows past nk zero). Writes
// O[:, :hd] to out (bf16).
template <int NKT>
__device__ __forceinline__ void attention_rows(const bf16* qh, const bf16* kh, const bf16* vh,
                                               const float* bh, const float* mh, int nk, int q0,
                                               int hd, bf16* out, int ldo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  float s[2 * NKT][4];
#pragma unroll
  for (int t = 0; t < 2 * NKT; ++t) {  // the bias (and mask) is the accumulator's starting value
    const int c0 = t * 8 + tig * 2;
    if (c0 >= nk) {
      s[t][0] = s[t][1] = s[t][2] = s[t][3] = -__int_as_float(0x7f800000);  // -inf
      continue;
    }
    float2 b0 = *reinterpret_cast<const float2*>(bh + (q0 + g) * nk + c0);
    float2 b1 = *reinterpret_cast<const float2*>(bh + (q0 + g + 8) * nk + c0);
    if (mh != nullptr) {
      const float2 m0 = *reinterpret_cast<const float2*>(mh + (q0 + g) * nk + c0);
      const float2 m1 = *reinterpret_cast<const float2*>(mh + (q0 + g + 8) * nk + c0);
      b0.x += m0.x; b0.y += m0.y; b1.x += m1.x; b1.y += m1.y;
    }
    s[t][0] = b0.x; s[t][1] = b0.y; s[t][2] = b1.x; s[t][3] = b1.y;
  }
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t fa[4];
    ldsm_x4(fa, qh + (q0 + (lane & 15)) * LDQ + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NKT; ++np) {  // keys np*16 .. np*16+15
      uint32_t fb[4];
      ldsm_x4(fb, kh + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDQ + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], fa, fb[0], fb[1]);
      mma_bf16(s[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
  // this thread holds rows g (s[t][0..1]) and g+8 (s[t][2..3]); a row's
  // values live in the 4 lanes of its quad
  float m0 = s[0][0], m1 = s[0][2];
#pragma unroll
  for (int t = 0; t < 2 * NKT; ++t) {
    m0 = fmaxf(m0, fmaxf(s[t][0], s[t][1]));
    m1 = fmaxf(m1, fmaxf(s[t][2], s[t][3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int t = 0; t < 2 * NKT; ++t) {
    s[t][0] = expf(s[t][0] - m0); s[t][1] = expf(s[t][1] - m0);
    s[t][2] = expf(s[t][2] - m1); s[t][3] = expf(s[t][3] - m1);
    l0 += s[t][0] + s[t][1];
    l1 += s[t][2] + s[t][3];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  float o[4][4] = {};
#pragma unroll
  for (int kb = 0; kb < NKT; ++kb) {  // keys kb*16 .. kb*16+15 as the A operand
    const uint32_t pa[4] = {
        pack_bf16(s[2 * kb][0] / l0, s[2 * kb][1] / l0),
        pack_bf16(s[2 * kb][2] / l1, s[2 * kb][3] / l1),
        pack_bf16(s[2 * kb + 1][0] / l0, s[2 * kb + 1][1] / l0),
        pack_bf16(s[2 * kb + 1][2] / l1, s[2 * kb + 1][3] / l1),
    };
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t fb[4];
      ldsm_x4_trans(fb, vh + (kb * 16 + (lane & 15)) * LDQ + dp * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * dp], pa, fb[0], fb[1]);
      mma_bf16(o[2 * dp + 1], pa, fb[2], fb[3]);
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = t * 8 + tig * 2 + e;
      if (d < hd) {
        out[(q0 + g) * ldo + d] = __float2bfloat16(o[t][e]);
        out[(q0 + g + 8) * ldo + d] = __float2bfloat16(o[t][2 + e]);
      }
    }
  }
}

// proj into the register-resident residual h = x + d1 * (attn @ wproj +
// bproj) (+ conv_scale * conv_x with CONV), from the attention output in
// `attn` (64 x cp bf16, zero beyond the real columns); with STORE_H also
// bf16(h) to p.h_out. MLPONLY (K13) skips proj: h = x. xw is the window's
// rows in device memory. Shared by block_tail and K4b's recompute.
template <int NCH, bool STORE_H, bool CONV, int STAGE = STAGE_FULL>
__device__ __forceinline__ void proj_residual(float (&h)[NCH][4][4], const Params& p, int lda,
                                              const bf16* attn, bf16* ring, const float* vec,
                                              const bf16* xw, size_t win, float d1) {
  const int C = p.c, CP = p.cp, CIO = p.cio;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 32, g = lane >> 2, tig = lane & 3;
  const int nkc = (CP + TILE - 1) / TILE;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < 4; ++i) h[ch][i][0] = h[ch][i][1] = h[ch][i][2] = h[ch][i][3] = 0.f;
  if constexpr (STAGE != STAGE_MLPONLY)
    pipeline(
        NCH * nkc, ring,
        [&](int s) {
          const int ch = s / nkc, kc = s - ch * nkc;
          return Tile{p.wproj, C, kc * TILE, min(TILE, C - kc * TILE), ch * TILE,
                      min(TILE, C - ch * TILE)};
        },
        [&](int s, const bf16* t) {
          const int chunk = s / nkc, kc = s - chunk * nkc, nn = C - chunk * TILE;
          if (c0 >= nn) return;
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch)
            if (ch == chunk)
              mma_tile(h[ch], attn + kc * TILE, lda, min(TILE, CP - kc * TILE) / 16, t,
                       c0 + 16 < nn);
        });
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + 8 * half, col = ch * TILE + c0 + t * 8 + tig * 2;
        if (col < CIO) {  // col and CIO even: both columns are real
          const unsigned xx = __ldg(reinterpret_cast<const unsigned*>(xw + r * CIO + col));
          const float2 x2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xx));
          if constexpr (STAGE == STAGE_MLPONLY) {
            h[ch][t][2 * half] = x2.x;
            h[ch][t][2 * half + 1] = x2.y;
            continue;
          }
          float v0 = x2.x + d1 * (h[ch][t][2 * half] + vec[V_BPROJ * C + col]);
          float v1 = x2.y + d1 * (h[ch][t][2 * half + 1] + vec[V_BPROJ * C + col + 1]);
          if constexpr (CONV) {
            const unsigned cc =
                __ldg(reinterpret_cast<const unsigned*>(p.convx + win + r * CIO + col));
            const float2 c2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&cc));
            v0 += p.conv_scale * c2.x;
            v1 += p.conv_scale * c2.y;
          }
          h[ch][t][2 * half] = v0;
          h[ch][t][2 * half + 1] = v1;
          if constexpr (STORE_H)
            *reinterpret_cast<__nv_bfloat162*>(p.h_out + win + r * CIO + col) =
                __floats2bfloat162_rn(v0, v1);
        }
      }
}

// The block's second half, shared by K1/K2/K5/K9a/K13 and K6/K10a (ocab.cu):
// from the attention output in `attn` (64 x cp bf16, zero beyond the real
// columns), proj into the register-resident residual
// h = x + d1 * (attn @ wproj + bproj) (+ conv_scale * conv_x with CONV), LN2
// of bf16(h), the MLP, and out = h + d2 * (mlp + b2) rounded to bf16. xw/ow
// are the window's rows in device memory. The MLP accumulates into h's
// registers, so a branch scale d2 other than 1 divides h by d2 before it and
// multiplies the sum after (exact but for one fp32 rounding each way); a
// window with d2 = 0 skips the MLP and writes h. STAGE and ACT: K13's
// switches (ATTNONLY writes h and stops).
template <int NCH, bool STORE_H, bool CONV, int STAGE = STAGE_FULL, int ACT = ACT_TANH>
__device__ __forceinline__ void block_tail(const Params& p, int lda, bf16* abuf, const bf16* attn,
                                           bf16* mid, bf16* ring, const float* vec, float* red,
                                           const bf16* xw, bf16* ow, size_t win, float d1 = 1.f,
                                           float d2 = 1.f) {
  const int C = p.c, CP = p.cp, CIO = p.cio, hidden = p.hidden;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 32, g = lane >> 2, tig = lane & 3;
  const int nkc = (CP + TILE - 1) / TILE;
  float h[NCH][4][4];
  proj_residual<NCH, STORE_H, CONV, STAGE>(h, p, lda, attn, ring, vec, xw, win, d1);
  if constexpr (STAGE == STAGE_ATTNONLY) {
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + g + 8 * half, col = ch * TILE + c0 + t * 8 + tig * 2;
          if (col < CIO)
            *reinterpret_cast<__nv_bfloat162*>(ow + r * CIO + col) =
                __floats2bfloat162_rn(h[ch][t][2 * half], h[ch][t][2 * half + 1]);
        }
    return;
  }

  // ---- LN2 of h rounded to bf16 -> abuf; a row's values live in one quad
  // of each of two warps (w and w+4), partial sums meet in `red`
  {
    float mu[2] = {0.f, 0.f}, rstd[2];
    for (int pass = 0; pass < 2; ++pass) {
      float acc2[2] = {0.f, 0.f};
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = ch * TILE + c0 + t * 8 + tig * 2 + (e & 1);
            if (col < CIO) {
              const float v = round_bf16(h[ch][t][e]);
              acc2[e >> 1] += pass == 0 ? v : (v - mu[e >> 1]) * (v - mu[e >> 1]);
            }
          }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        acc2[half] += __shfl_xor_sync(0xffffffffu, acc2[half], 1);
        acc2[half] += __shfl_xor_sync(0xffffffffu, acc2[half], 2);
        if (tig == 0) red[(r0 + g + 8 * half) * 2 + (warp >> 2)] = acc2[half];
      }
      __syncthreads();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + 8 * half;
        const float tot = (red[r * 2] + red[r * 2 + 1]) / CIO;
        if (pass == 0) mu[half] = tot;
        else rstd[half] = rsqrtf(tot + 1e-5f);
      }
      __syncthreads();  // red is rewritten by the next pass
    }
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + g + 8 * (e >> 1);
          const int col = ch * TILE + c0 + t * 8 + tig * 2 + (e & 1);
          if (col < CP) {
            const float v = (round_bf16(h[ch][t][e]) - mu[e >> 1]) * rstd[e >> 1];
            abuf[r * lda + col] = __float2bfloat16(
                col < CIO ? v * vec[V_LN2W * C + col] + vec[V_LN2B * C + col] : 0.f);
          }
        }
  }

  // ---- MLP in 64-wide hidden chunks j: fc1 slice (nkc tiles of w1), GELU ->
  // mid, then mid @ w2[j rows] accumulated into h (NCH tiles of w2)
  if (d2 != 1.f && d2 != 0.f) {
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[ch][t][e] /= d2;
  }
  if (d2 != 0.f) {  // uniform over the block: every thread skips the barriers alike
    const int per = nkc + NCH;
    float acc[4][4];
    pipeline(
        ((hidden + TILE - 1) / TILE) * per, ring,
        [&](int s) {
          const int j = s / per, u = s - j * per;
          if (u < nkc)
            return Tile{p.w1, hidden, u * TILE, min(TILE, C - u * TILE), j * TILE,
                        min(TILE, hidden - j * TILE)};
          return Tile{p.w2, C, j * TILE, min(TILE, hidden - j * TILE), (u - nkc) * TILE,
                      min(TILE, C - (u - nkc) * TILE)};
        },
        [&](int s, const bf16* t) {
          const int j = s / per, u = s - j * per;
          if (u < nkc) {
            const int nn = min(TILE, hidden - j * TILE);
            if (u == 0) {
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
            }
            if (c0 >= nn) return;
            mma_tile(acc, abuf + u * TILE, lda, min(TILE, CP - u * TILE) / 16, t, c0 + 16 < nn);
            if (u != nkc - 1) return;
            for_pairs(acc, 0, c0 + 16 < nn, [&](int r, int c, float v0, float v1) {
              const float v[2] = {v0, v1};
#pragma unroll
              for (int e = 0; e < 2; ++e)
                mid[r * LDT + c + e] = __float2bfloat16(
                    c + e < nn ? activation<ACT>(v[e] + vec[V_B1 * C + j * TILE + c + e])
                               : 0.f);
            });
          } else {
            const int chunk = u - nkc, nn = C - chunk * TILE;
            if (c0 >= nn) return;
            const int ksteps = round16(min(TILE, hidden - j * TILE)) / 16;
#pragma unroll
            for (int ch = 0; ch < NCH; ++ch)
              if (ch == chunk) mma_tile(h[ch], mid, LDT, ksteps, t, c0 + 16 < nn);
          }
        });
  }

  // ---- out = h + d2 * (mlp + b2), rounded to bf16, straight from the registers
  const float b2s = d2 != 0.f ? 1.f : 0.f;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + 8 * half, col = ch * TILE + c0 + t * 8 + tig * 2;
        if (col < CIO) {
          const float o0 = h[ch][t][2 * half] + b2s * vec[V_B2 * C + col];
          const float o1 = h[ch][t][2 * half + 1] + b2s * vec[V_B2 * C + col + 1];
          *reinterpret_cast<__nv_bfloat162*>(ow + r * CIO + col) =
              d2 != 0.f ? __floats2bfloat162_rn(d2 * o0, d2 * o1) : __floats2bfloat162_rn(o0, o1);
        }
      }
}

// The block's first half after LN1: QKV two heads at a time, each pair's
// attention right after it. Warps 0-3 take the first head, warps 4-7 the
// second; each warp owns 16 query rows -> attn columns head*hd ..
// head*hd+hd-1. abuf holds LN1's output (64 x cp bf16), qkv the zeroed
// q/k/v slots of a head pair. NOATTN (K13) writes the unscaled q columns to
// attn instead of the attention output. Shared by swin_block_kernel and
// K4b's recompute.
template <int STAGE = STAGE_FULL>
__device__ __forceinline__ void qkv_attention(const Params& p, int lda, const bf16* abuf,
                                              bf16* attn, bf16* qkv, bf16* ring,
                                              const float* vec, const int* qmap,
                                              const float* mask) {
  const int C = p.c, CP = p.cp, heads = p.heads, hd = p.hd;
  const int warp = threadIdx.x >> 5;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 32;
  const int nkc = (CP + TILE - 1) / TILE;  // 64-row slices of a C-deep product
  const float qscale = round_bf16(p.scale);
  for (int h0 = 0; h0 < heads; h0 += 2) {
    const int seg = min(2, heads - h0) * hd;  // columns of q (or k, or v) of the pair
    const bool lo = c0 < seg, hi = c0 + 16 < seg;
    float acc[4][4];
    pipeline(
        3 * nkc, ring,
        [&](int s) {
          const int which = s / nkc, kc = s - which * nkc;
          return Tile{p.wqkv, 3 * C, kc * TILE, min(TILE, C - kc * TILE), which * C + h0 * hd,
                      seg};
        },
        [&](int s, const bf16* t) {
          const int which = s / nkc, kc = s - which * nkc;
          if (kc == 0) {
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
          }
          if (!lo) return;
          mma_tile(acc, abuf + kc * TILE, lda, min(TILE, CP - kc * TILE) / 16, t, hi);
          if (kc != nkc - 1) return;
          const int base = which * C + h0 * hd;
          bf16* dst = qkv + which * 2 * N * LDQ;
          for_pairs(acc, 0, hi, [&](int r, int c, float v0, float v1) {
            const float v[2] = {v0, v1};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (c + e >= seg) continue;
              float y = round_bf16(v[e] + vec[V_BQKV * C + base + c + e]);
              if constexpr (STAGE == STAGE_NOATTN) {
                if (which == 0) attn[r * lda + h0 * hd + c + e] = __float2bfloat16(y);
                continue;
              }
              if (which == 0) y *= qscale;
              dst[qmap[c + e] + r * LDQ] = __float2bfloat16(y);
            }
          });
        });
    if constexpr (STAGE == STAGE_NOATTN) continue;
    const int head = h0 + (warp >> 2);
    if (head < heads)
      attention_rows<N / 16>(qkv + (size_t)(0 * 2 + (warp >> 2)) * N * LDQ,
                             qkv + (size_t)(1 * 2 + (warp >> 2)) * N * LDQ,
                             qkv + (size_t)(2 * 2 + (warp >> 2)) * N * LDQ,
                             p.bias + (size_t)head * N * N, mask, N, r0, hd, attn + head * hd,
                             lda);
  }
}

// NCH = ceil(C / 64): the column chunks of the residual h held in registers.
// STORE_H: K2 and K9a, which also write bf16(h) to p.h_out. HAB: K5 and K9a,
// which add the mask to the scores and conv_scale * conv_x to the residual;
// both together (K9a) also scale the branches by dp1, dp2. STAGE, ACT: K13's.
template <int NCH, bool STORE_H, bool HAB, int STAGE = STAGE_FULL, int ACT = ACT_TANH>
__global__ void __launch_bounds__(THREADS, 2) swin_block_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(p.c, p.cp, p.hidden_p);
  bf16* abuf = reinterpret_cast<bf16*>(smem + L.a);
  bf16* attn = reinterpret_cast<bf16*>(smem + L.attn);
  bf16* qkv = reinterpret_cast<bf16*>(smem + L.big);
  bf16* mid = reinterpret_cast<bf16*>(smem + L.big);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  float* vec = reinterpret_cast<float*>(smem + L.vec);
  float* red = reinterpret_cast<float*>(smem + L.red);
  int* qmap = reinterpret_cast<int*>(smem + L.qmap);

  const int C = p.c, CP = p.cp, CIO = p.cio, hd = p.hd, hidden = p.hidden;
  const int lda = L.lda;
  const int tid = threadIdx.x;
  const size_t win = (size_t)blockIdx.x * N * CIO;
  const bf16* xw = p.x + win;
  bf16* ow = p.out + win;
  const float* mask = nullptr;
  float d1 = 1.f, d2 = 1.f;
  if constexpr (HAB)
    if (p.mask != nullptr) mask = p.mask + (size_t)(blockIdx.x % p.nw) * N * N;
  if constexpr (HAB && STORE_H) {  // K9a; K5 keeps the constant scales
    if (p.dp1 != nullptr) d1 = __ldg(p.dp1 + blockIdx.x);
    if (p.dp2 != nullptr) d2 = __ldg(p.dp2 + blockIdx.x);
  }

  // q/k/v padding must read as zero; the window goes to the idle attention
  // buffer, the small vectors and the pair column map to theirs
  {
    uint4* z = reinterpret_cast<uint4*>(qkv);
    for (int i = tid; i < 3 * 2 * N * LDQ / 8; i += THREADS) z[i] = make_uint4(0u, 0u, 0u, 0u);
    const uint4* src = reinterpret_cast<const uint4*>(xw);
    uint4* dst = reinterpret_cast<uint4*>(attn);
    for (int i = tid; i < N * CIO / 8; i += THREADS) dst[i] = __ldg(src + i);
    const float* vsrc[] = {p.ln1_w, p.ln1_b, p.bqkv, p.bproj, p.ln2_w, p.ln2_b, p.b2};
    const int voff[] = {V_LN1W, V_LN1B, V_BQKV, V_BPROJ, V_LN2W, V_LN2B, V_B2};
    const int vlen[] = {C, C, 3 * C, C, C, C, C};
#pragma unroll
    for (int v = 0; v < 7; ++v)
      for (int i = tid; i < vlen[v]; i += THREADS) vec[voff[v] * C + i] = __ldg(vsrc[v] + i);
    for (int i = tid; i < hidden; i += THREADS) vec[V_B1 * C + i] = __ldg(p.b1 + i);
    for (int j = tid; j < 2 * hd; j += THREADS) qmap[j] = (j / hd) * N * LDQ + j % hd;
  }
  __syncthreads();

  // ---- LN1 over the CIO real columns -> abuf (zeros up to CP)
  if constexpr (STAGE != STAGE_MLPONLY) {
    const bf16* xs = attn;
    layer_norm_rows(
        abuf, lda, CIO, CP, [&](int r, int c) { return __bfloat162float(xs[r * CIO + c]); },
        vec + V_LN1W * C, vec + V_LN1B * C);
    __syncthreads();
    // the attention output's padding columns are proj's zero k-rows: they
    // must read as zero, not as leftovers of the window staged here
    for (int i = tid; i < N * (CP - C); i += THREADS)
      attn[(i / (CP - C)) * lda + C + i % (CP - C)] = __float2bfloat16(0.f);
  }

  if constexpr (STAGE != STAGE_MLPONLY)
    qkv_attention<STAGE>(p, lda, abuf, attn, qkv, ring, vec, qmap, mask);

  block_tail<NCH, STORE_H, HAB, STAGE, ACT>(p, lda, abuf, attn, mid, ring, vec, red, xw, ow, win,
                                            d1, d2);
}

template <int NCH, bool STORE_H, bool HAB, int STAGE, int ACT>
cudaError_t launch_block(const Params& p, int bw, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(swin_block_kernel<NCH, STORE_H, HAB, STAGE, ACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  swin_block_kernel<NCH, STORE_H, HAB, STAGE, ACT><<<bw, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// Checks the widths and alignments, fills the derived fields of p and
// launches bw blocks. Returns a cudaError_t as an int. ONLY_NCH other than
// 0 compiles the kernel for that one width class (C in 64*(ONLY_NCH-1) + 1
// .. 64*ONLY_NCH) and refuses the others.
template <bool STORE_H, bool HAB, int STAGE = STAGE_FULL, int ACT = ACT_TANH, int ONLY_NCH = 0>
int run_block(Params p, int bw, void* stream) {
  const int c = p.c, heads = p.heads, hidden = p.hidden, cio = p.cio;
  // a head pair's columns are copied in 4-element (8-byte) vectors; window
  // rows are read as bf16 pairs
  const int hd = heads > 0 ? c / heads : 0;
  if (bw <= 0 || c <= 0 || c > MAX_C || c % 4 != 0 || heads <= 0 || c % heads != 0 ||
      hd > DP || hd % 2 != 0 || (heads % 2 != 0 && hd % 4 != 0) || hidden <= 0 ||
      hidden % 4 != 0 || cio <= 0 || cio > c || cio % 2 != 0 || (HAB && p.nw <= 0) ||
      (ONLY_NCH != 0 && (c + TILE - 1) / TILE != ONLY_NCH))
    return (int)cudaErrorInvalidValue;
  const void* aligned8[] = {p.wqkv, p.wproj, p.w1, p.w2, p.bias};
  for (const void* ptr : aligned8)
    if (reinterpret_cast<uintptr_t>(ptr) % 8 != 0) return (int)cudaErrorMisalignedAddress;
  if (reinterpret_cast<uintptr_t>(p.x) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (STORE_H && reinterpret_cast<uintptr_t>(p.h_out) % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (HAB && (reinterpret_cast<uintptr_t>(p.convx) % 4 != 0 ||
              reinterpret_cast<uintptr_t>(p.mask) % 8 != 0))
    return (int)cudaErrorMisalignedAddress;
  p.cp = round16(c);
  p.hd = hd;
  p.hidden_p = round16(hidden);
  const size_t smem = make_layout(c, p.cp, p.hidden_p).total;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (ONLY_NCH != 0) {
    return (int)launch_block<ONLY_NCH, STORE_H, HAB, STAGE, ACT>(p, bw, smem, s);
  } else {
    switch ((c + TILE - 1) / TILE) {
      case 1: return (int)launch_block<1, STORE_H, HAB, STAGE, ACT>(p, bw, smem, s);
      case 2: return (int)launch_block<2, STORE_H, HAB, STAGE, ACT>(p, bw, smem, s);
      case 3: return (int)launch_block<3, STORE_H, HAB, STAGE, ACT>(p, bw, smem, s);
      default: return (int)launch_block<4, STORE_H, HAB, STAGE, ACT>(p, bw, smem, s);
    }
  }
}

}  // namespace swin
