// The Swin-block backward's window kernels on wgmma, shared by
// swin_block_train.cu (K3/K9b, K4/K9c) and swin_block_bwd.cu (K4b, the
// backward with the forward recomputed): the MLP window kernel's body
// (mlp_bwd_body), the attention window kernel's (attn_wg_body), their
// parameters, layouts and launchers. swin_block_train.cu says what each
// kernel computes, how its sums are ordered and how it is laid out;
// swin_block_bwd.cu says how K4b runs them.
//
// Each body has one more mode for K4b, F32, at the TPU kernel's rounding
// points there (dh stays fp32 into dbproj and dx's residual):
//   - the MLP body reads the recompute's fp32 h (LN2's statistics and x-hat
//     from it, not from a bf16 h) and writes dh in fp32 (dx's residual) and
//     in bf16 (do's and dWproj's operand), and dbproj, the column sums of
//     the fp32 dh, into its window's row of vec;
//   - the attention body reads the fp32 dh for dx's residual and leaves
//     dbproj to the MLP body (its bf16 dh feeds do and dWproj, as in K4).
// The modes are separate kernels (mlp_bwd_f32_kernel, attn_wg_f32_kernel)
// whose extra pointers are kernel arguments of their own: MlpParams and
// AttnWgParams, which K3/K9b's and K4/K9c's kernels read, carry none of them.

#pragma once

#include "hopper.cuh"
#include "swin_common.cuh"
#include "swin_pack.cuh"

namespace swin {

// K3/K9b's parameters (K4b adds its fp32 h and dh as kernel arguments of
// their own: mlp_bwd_f32_kernel).
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

}  // namespace swin

namespace {

using namespace swin;

// ===========================================================================
// K3 / K9b: the window kernel on wgmma.
// ===========================================================================

// Shared memory of the MLP window kernel at nw windows a block (bytes):
// the 4-tile weight ring, per window hn and dm (64 x ck bf16 each, the
// interleaved K-major layout), ln2 w | b and b1, per window the LN2
// statistics and the column-sum slots, the ring's mbarriers. ck is C
// rounded up to whole 64-column chunks, so that every product loop has a
// compile-time trip count.
struct MlpWgLayout {
  int ck, nw;
  size_t tile, ring, win, vec, stats, slot, bars, total;
};

__host__ __device__ inline MlpWgLayout mlp_wg_layout(int c, int hidden, int nw) {
  MlpWgLayout L;
  L.ck = (c + TILE - 1) / TILE * TILE;
  L.nw = nw;
  const int sw = L.ck > TILE ? L.ck : TILE;
  L.tile = (size_t)L.ck * 128;  // 64 hidden x ck bf16
  size_t o = 0;
  L.ring = o;  o += 4 * L.tile;
  L.win = o;   o += (size_t)nw * 2 * N * L.ck * 2;
  L.vec = o;   o += align128(sizeof(float) * (2 * c + hidden));
  L.stats = o; o += align128(sizeof(float) * nw * 2 * N);
  L.slot = o;  o += align128(sizeof(float) * nw * 2 * 4 * sw);
  L.bars = o;  o += 8 * sizeof(uint64_t);
  L.total = o;
  return L;
}

constexpr int MLP_THREADS = 3 * 128;  // two consumer warpgroups and a producer
constexpr int MLP_MIN_REGS = 168;     // 384 x 168: the producer gives 128 x 128 to the consumers

// One 8x8 window per consumer warpgroup, nw (1 or 2) windows a block: each
// weight tile that lands serves 128 token rows at nw = 2. The producer
// thread streams the packed tiles (w1 then w2^T of each 64-wide hidden
// chunk) by TMA bulk copy into a 4-tile ring under mbarriers; a warpgroup
// releases a chunk's two tiles once its products have read them. Per chunk
// j: u = hn . w1[:, j] and dg = dm . w2[j, :]^T (wgmma, A and B in shared
// memory), then per token g = gelu(u + b1), du = dg * gelu'(u + b1) in
// fp32, g and du to global for the weight gradients, db1's window sums,
// and dhn += bf16(du) . w1[:, j]^T with du as the A operand in registers.
// F32 (K4b): h32 is the window's fp32 h in place of p.h, and dh leaves in
// fp32 to dh32 as well as in bf16 to p.dh, with dbproj in vec.
template <int NCH, bool F32>
__device__ __forceinline__ void mlp_bwd_body(const MlpParams& p, int bw, int nw,
                                             unsigned char* msm, const float* h32, float* dh32) {
  using namespace hopper;
  const int C = p.c, CIO = p.cio, hidden = p.hidden;
  const MlpWgLayout L = mlp_wg_layout(C, hidden, nw);
  constexpr int CK = NCH * TILE;
  const int TB = (int)L.tile, nj = (hidden + TILE - 1) / TILE;
  const int SW = CK > TILE ? CK : TILE;
  float* vec = reinterpret_cast<float*>(msm + L.vec);  // ln2_w | ln2_b | b1
  uint64_t* full = reinterpret_cast<uint64_t*>(msm + L.bars);
  uint64_t* empty = full + 4;
  const int tid = threadIdx.x, wgi = tid >> 7;
  for (int i = tid; i < C; i += blockDim.x) {
    vec[i] = __ldg(p.ln2_w + i);
    vec[C + i] = __ldg(p.ln2_b + i);
  }
  for (int i = tid; i < hidden; i += blockDim.x) vec[2 * C + i] = __ldg(p.b1 + i);
  if (tid == 0) {
    for (int s = 0; s < 4; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], nw);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == nw) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == nw * 128) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(p.wpack);
      for (int i = 0; i < 2 * nj; ++i) {
        const int st = i & 3;
        if (i >= 4) mbar_wait(&empty[st], ((i >> 2) - 1) & 1);
        mbar_arrive_expect_tx(&full[st], TB);
        bulk_load(msm + L.ring + st * TB, src + (size_t)i * TB, TB, &full[st]);
      }
    }
  } else {  // consumer warpgroup wgi: window blockIdx.x * nw + wgi
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int win = blockIdx.x * nw + wgi;
    const bool live = win < bw;
    const int wt = tid & 127, wi = wt >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    unsigned char* hn_s = msm + L.win + (size_t)wgi * 2 * N * CK * 2;
    unsigned char* dm_s = hn_s + N * CK * 2;
    float* stats = reinterpret_cast<float*>(msm + L.stats) + wgi * 2 * N;
    float* slot = reinterpret_cast<float*>(msm + L.slot) + wgi * 2 * 4 * SW;
    const size_t row0 = (size_t)win * N;
    float* vout = p.vec + (size_t)win * (hidden + (F32 ? 4 : 3) * C);
    const float dscale = live && p.dp != nullptr ? __ldg(p.dp + win) : 1.f;
    const bf16* hw = p.h + row0 * CIO;
    const float* hf = F32 ? h32 + row0 * CIO : nullptr;
    const bf16* dw = p.dout + row0 * CIO;
    auto wg_sync = [&] { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory"); };

    // ---- LN2 of the window (warp wi: rows 16 wi .., four at a time),
    // two-pass fp32 statistics over the cio real columns; hn and dm =
    // bf16(dscale * dout) into shared memory (zero past cio) and to global
    // for the weight gradients; db2 = dscale * dout's column sums, each
    // warp's 16 rows in order, then the four warps in order
    if (live) {
      constexpr int RW = 4, NV = MAX_C / 32;
      float cs[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) cs[i] = 0.f;
      for (int r0 = 16 * wi; r0 < 16 * wi + 16; r0 += RW) {
        float v[RW][NV], dv[RW][NV];
#pragma unroll
        for (int q = 0; q < RW; ++q)
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int c = lane + 32 * i;
            if constexpr (F32) v[q][i] = c < CIO ? hf[(r0 + q) * CIO + c] : 0.f;
            else v[q][i] = c < CIO ? __bfloat162float(hw[(r0 + q) * CIO + c]) : 0.f;
            dv[q][i] = c < CIO ? __bfloat162float(dw[(r0 + q) * CIO + c]) : 0.f;
          }
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          const int r = r0 + q;
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            sum += v[q][i];
            cs[i] += dv[q][i];
          }
          const float mu = warp_sum(sum) / CIO;
          float sq = 0.f;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int c = lane + 32 * i;
            const float d = c < CIO ? v[q][i] - mu : 0.f;
            sq += d * d;
          }
          const float rstd = rsqrtf(warp_sum(sq) / CIO + 1e-5f);
          if (lane == 0) {
            stats[r] = mu;
            stats[N + r] = rstd;
          }
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int c = lane + 32 * i;
            if (c >= CK) continue;
            const bf16 y =
                __float2bfloat16(c < CIO ? (v[q][i] - mu) * rstd * vec[c] + vec[C + c] : 0.f);
            const bf16 d = __float2bfloat16(c < CIO ? dv[q][i] * dscale : 0.f);
            *reinterpret_cast<bf16*>(hn_s + kmaj(r, c, CK)) = y;
            *reinterpret_cast<bf16*>(dm_s + kmaj(r, c, CK)) = d;
            if (c < C) {
              p.hn[(row0 + r) * C + c] = y;
              if (p.dm != nullptr) p.dm[(row0 + r) * C + c] = d;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = lane + 32 * i;
        if (c < C) slot[wi * SW + c] = cs[i];
      }
      wg_sync();
      for (int c = wt; c < C; c += 128)
        vout[hidden + c] =
            dscale * (((slot[c] + slot[SW + c]) + slot[2 * SW + c]) + slot[3 * SW + c]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync();

    // ---- the hidden loop
    float dhn[NCH][32];
#pragma unroll
    for (int k = 0; k < NCH; ++k)
#pragma unroll
      for (int i = 0; i < 32; ++i) dhn[k][i] = 0.f;
    const float* b1s = vec + 2 * C;
    for (int j = 0; j < nj; ++j) {
      const int s1 = (2 * j) & 3, s2 = (2 * j + 1) & 3;
      mbar_wait(&full[s1], ((2 * j) >> 2) & 1);
      mbar_wait(&full[s2], ((2 * j + 1) >> 2) & 1);
      const unsigned char* w1t = msm + L.ring + s1 * TB;
      const unsigned char* w2t = msm + L.ring + s2 * TB;
      if (live) {
        float u[32], dg[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) u[i] = dg[i] = 0.f;
        fence_regs(u);
        fence_regs(dg);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < CK / 16; ++ks)
          wgmma_n64<KMAJ, MNMAJ>(u, desc(hn_s + ks * 256, 128, CK * 16),
                                 desc(w1t + ks * 2048, 1024, 128), 1);
#pragma unroll
        for (int ks = 0; ks < CK / 16; ++ks)
          wgmma_n64<KMAJ, MNMAJ>(dg, desc(dm_s + ks * 256, 128, CK * 16),
                                 desc(w2t + ks * 2048, 1024, 128), 1);
        wg_commit();
        wg_wait<0>();
        fence_regs(u);
        fence_regs(dg);
        // u <- du (fp32); g and du to global
#pragma unroll
        for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * wi + g + 8 * h, hcol = j * TILE + 8 * j8 + 2 * t4;
            float gv[2] = {0.f, 0.f};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int k = 4 * j8 + 2 * h + e;
              float d = 0.f;
              if (hcol < hidden) {  // hcol even, hidden a multiple of 4: both columns real
                const float2 gg = gelu_and_grad(u[k] + b1s[hcol + e]);
                gv[e] = gg.x;
                d = dg[k] * gg.y;
              }
              u[k] = d;
            }
            if (hcol < hidden) {
              const size_t gi = (row0 + r) * hidden + hcol;
              *reinterpret_cast<__nv_bfloat162*>(p.g + gi) = __floats2bfloat162_rn(gv[0], gv[1]);
              *reinterpret_cast<__nv_bfloat162*>(p.du + gi) =
                  __floats2bfloat162_rn(u[4 * j8 + 2 * h], u[4 * j8 + 2 * h + 1]);
            }
          }
        uint32_t af[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          af[ks][0] = pack_bf16(u[8 * ks + 0], u[8 * ks + 1]);
          af[ks][1] = pack_bf16(u[8 * ks + 2], u[8 * ks + 3]);
          af[ks][2] = pack_bf16(u[8 * ks + 4], u[8 * ks + 5]);
          af[ks][3] = pack_bf16(u[8 * ks + 6], u[8 * ks + 7]);
        }
#pragma unroll
        for (int k = 0; k < NCH; ++k) fence_regs(dhn[k]);
        wg_fence();
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          const unsigned char* bt = w1t + k * 8 * 1024;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_n64_rs<KMAJ>(dhn[k], af[ks], desc(bt + ks * 256, 128, 1024), 1);
        }
        wg_commit();
        // db1 of this chunk while the products run: the warp's 16 rows, then
        // the four warps in order
        float* sb = slot + (j & 1) * 4 * TILE;
#pragma unroll
        for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float sum = u[4 * j8 + e] + u[4 * j8 + 2 + e];
            sum += __shfl_xor_sync(0xffffffffu, sum, 4);
            sum += __shfl_xor_sync(0xffffffffu, sum, 8);
            sum += __shfl_xor_sync(0xffffffffu, sum, 16);
            if (g == 0) sb[wi * TILE + 8 * j8 + 2 * t4 + e] = sum;
          }
        wg_wait<0>();
#pragma unroll
        for (int k = 0; k < NCH; ++k) fence_regs(dhn[k]);
        wg_sync();
        if (wt < TILE && j * TILE + wt < hidden)
          vout[j * TILE + wt] = ((sb[wt] + sb[TILE + wt]) + sb[2 * TILE + wt]) + sb[3 * TILE + wt];
      } else {
        wg_sync();
      }
      if (wt == 0) {
        mbar_arrive(&empty[s1]);
        mbar_arrive(&empty[s2]);
      }
    }
    if (!live) return;

    // ---- LN2 backward: dln2s, dln2b, dh = rstd * (dxh - mean(dxh) - xhat *
    // mean(dxh * xhat)) + dout, with dxh = dhn * ln2_w over the cio columns
    wg_sync();  // the last chunk's slot readers are done
    float mu[2], rstd[2], s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mu[h] = stats[16 * wi + g + 8 * h];
      rstd[h] = stats[N + 16 * wi + g + 8 * h];
    }
    auto xhat2 = [&](int r, int col, int h) {
      float2 hv;
      if constexpr (F32) hv = *reinterpret_cast<const float2*>(hf + r * CIO + col);
      else hv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hw + r * CIO + col));
      return make_float2((hv.x - mu[h]) * rstd[h], (hv.y - mu[h]) * rstd[h]);
    };
    float* sa = slot;
    float* sbb = slot + 4 * SW;
#pragma unroll
    for (int k = 0; k < NCH; ++k)
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        const int col = k * TILE + 8 * j8 + 2 * t4;
        float ca[2] = {0.f, 0.f}, cb[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wi + g + 8 * h;
          const float d0 = dhn[k][4 * j8 + 2 * h], d1 = dhn[k][4 * j8 + 2 * h + 1];
          cb[0] += d0;
          cb[1] += d1;
          if (col < CIO) {  // col and cio even: both columns real
            const float2 xh = xhat2(r, col, h);
            const float x0 = d0 * vec[col], x1 = d1 * vec[col + 1];
            s1[h] += x0 + x1;
            s2[h] += x0 * xh.x + x1 * xh.y;
            ca[0] += d0 * xh.x;
            ca[1] += d1 * xh.y;
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int o = 4; o <= 16; o <<= 1) {
            ca[e] += __shfl_xor_sync(0xffffffffu, ca[e], o);
            cb[e] += __shfl_xor_sync(0xffffffffu, cb[e], o);
          }
          if (g == 0 && col + e < C) {
            sa[wi * SW + col + e] = ca[e];
            sbb[wi * SW + col + e] = cb[e];
          }
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], o);
        s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], o);
      }
    wg_sync();
    for (int c = wt; c < C; c += 128) {
      vout[hidden + C + c] = ((sa[c] + sa[SW + c]) + sa[2 * SW + c]) + sa[3 * SW + c];
      vout[hidden + 2 * C + c] = ((sbb[c] + sbb[SW + c]) + sbb[2 * SW + c]) + sbb[3 * SW + c];
    }
    bf16* dh = p.dh + row0 * CIO;
    if constexpr (F32) {
      // dh to dh32 in fp32 and to p.dh in bf16; dbproj = the fp32 dh's
      // column sums (each warp's 16 rows in order, then the four warps in
      // order) into vout[hidden + 3C ..], through sa once dln2s has left it
      float* dhf = dh32 + row0 * CIO;
      wg_sync();  // sa is read
#pragma unroll
      for (int k = 0; k < NCH; ++k)
#pragma unroll
        for (int j8 = 0; j8 < 8; ++j8) {
          const int col = k * TILE + 8 * j8 + 2 * t4;
          float cd[2] = {0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * wi + g + 8 * h;
            if (col < CIO) {  // col and cio even: both columns real
              const float2 xh = xhat2(r, col, h);
              const float2 res = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(dw + r * CIO + col));
              const float x0 = dhn[k][4 * j8 + 2 * h] * vec[col];
              const float x1 = dhn[k][4 * j8 + 2 * h + 1] * vec[col + 1];
              const float v0 = rstd[h] * (x0 - s1[h] / CIO - xh.x * (s2[h] / CIO)) + res.x;
              const float v1 = rstd[h] * (x1 - s1[h] / CIO - xh.y * (s2[h] / CIO)) + res.y;
              *reinterpret_cast<float2*>(dhf + r * CIO + col) = make_float2(v0, v1);
              *reinterpret_cast<__nv_bfloat162*>(dh + r * CIO + col) =
                  __floats2bfloat162_rn(v0, v1);
              cd[0] += v0;
              cd[1] += v1;
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int o = 4; o <= 16; o <<= 1) cd[e] += __shfl_xor_sync(0xffffffffu, cd[e], o);
            if (g == 0 && col + e < C) sa[wi * SW + col + e] = cd[e];
          }
        }
      wg_sync();
      for (int c = wt; c < C; c += 128)
        vout[hidden + 3 * C + c] = ((sa[c] + sa[SW + c]) + sa[2 * SW + c]) + sa[3 * SW + c];
      return;
    }
#pragma unroll
    for (int k = 0; k < NCH; ++k)
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wi + g + 8 * h, col = k * TILE + 8 * j8 + 2 * t4;
          if (col >= CIO) continue;
          const float2 xh = xhat2(r, col, h);
          const float2 res =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dw + r * CIO + col));
          const float x0 = dhn[k][4 * j8 + 2 * h] * vec[col];
          const float x1 = dhn[k][4 * j8 + 2 * h + 1] * vec[col + 1];
          const float v0 = rstd[h] * (x0 - s1[h] / CIO - xh.x * (s2[h] / CIO)) + res.x;
          const float v1 = rstd[h] * (x1 - s1[h] / CIO - xh.y * (s2[h] / CIO)) + res.y;
          *reinterpret_cast<__nv_bfloat162*>(dh + r * CIO + col) = __floats2bfloat162_rn(v0, v1);
        }
  }
}

// K3 / K9b
template <int NCH>
__global__ void __launch_bounds__(MLP_THREADS, 1) mlp_bwd_kernel(const MlpParams p, int bw,
                                                                 int nw) {
  extern __shared__ __align__(1024) unsigned char msm[];
  mlp_bwd_body<NCH, false>(p, bw, nw, msm, nullptr, nullptr);
}

// K4b's MLP phase: h32 (Bw, 64, c) the recompute's fp32 h, dh32 (Bw, 64, c)
// fp32 dh out; vec rows of hidden + 4c (dbproj last)
template <int NCH>
__global__ void __launch_bounds__(MLP_THREADS, 1)
    mlp_bwd_f32_kernel(const MlpParams p, int bw, int nw, const float* h32, float* dh32) {
  extern __shared__ __align__(1024) unsigned char msm[];
  mlp_bwd_body<NCH, true>(p, bw, nw, msm, h32, dh32);
}

// ===========================================================================
// K4 / K9c: the window kernel on wgmma.
// ===========================================================================

struct AttnWgParams {
  const bf16* x;       // (Bw, 64, cio)
  const bf16* dh;      // (Bw, 64, cio)
  const float* dp;     // (Bw,) the attention branch's scale per window, or null (1)
  const float* mask;   // (nmask, 64, 64) additive shift mask, or null
  const float* ln1_w;  // (c)
  const float* ln1_b;
  const bf16* wqkv;    // (c, 3c)
  const float* bqkv;   // (3c)
  const float* bias;   // (heads, 64, 64)
  const bf16* wproj;   // (c, c)
  bf16* wpack;         // wqkv and wproj packed per head (attn_pack_kernel; scratch)
  bf16* dx;            // (Bw, 64, cio)
  bf16* xn;            // (Bw*64, c)     LN1 output, for dWqkv
  bf16* att;           // (Bw*64, dw)    attention output, each head padded to hp, for dWproj
  bf16* dqkv;          // (Bw*64, 3 dw)  dq | dk | dv, each head padded to hp, for dWqkv
  bf16* dhs;           // (Bw*64, c)     bf16(dp * dh), for dWproj; null: K4 reads dh
  float* part;         // (P, 3 dw + 3c + heads*64*64): each consumer warpgroup's sums
  int c, cio, heads, hd, hp, dw, nmask, bw, wpw;
  float scale;
};

// The weight ring: four slots, one per tile of a head's phase A (wproj, wq,
// wk, wv), which phase B's three (wq, wk, wv) share in turn.
constexpr int ATT_STAGES = 4;
constexpr int ATT_THREADS = 3 * 128;  // two consumer warpgroups and a producer
constexpr int ATT_MIN_REGS = 168;     // 384 x 168: the producer gives 128 x 128 to the consumers

// Shared memory of the attention window kernel at nw windows a block
// (bytes): the weight ring (4 tiles of ck x hp bf16), then per window xn
// and dhs (64 x ck, interleaved K-major), one head's q, k, v and do (64 x
// hp), a (64 x 64), ds (64 x 64; at hp = 32 it lies over k | v), dq | dk |
// dv (64 x 3hp); ln1 w | b and bqkv; per window the LN1 statistics and the
// dbqkv column-sum slots; the ring's mbarriers. From q on, a window's
// buffers double as its scratch: the dense staging of the 16-byte stores
// and the column-sum slots of the prologue and the epilogue.
struct AttnWgLayout {
  int ck, hp, nw;
  size_t tile, ring, wins, win, xn, dhs, q, k, v, dop, a, ds, dq, vec, stats, slot, bars, total;
};

__host__ __device__ inline AttnWgLayout attn_wg_layout(int c, int heads, int nw) {
  AttnWgLayout L;
  L.ck = (c + TILE - 1) / TILE * TILE;
  L.hp = c / heads <= 16 ? 16 : 32;
  L.nw = nw;
  L.tile = (size_t)L.ck * L.hp * 2;
  const size_t op = (size_t)N * L.hp * 2, sq = (size_t)N * N * 2;
  size_t o = 0;
  L.xn = o;  o += (size_t)N * L.ck * 2;
  L.dhs = o; o += (size_t)N * L.ck * 2;
  L.q = o;   o += op;
  L.k = o;   o += op;
  L.v = o;   o += op;
  L.dop = o; o += op;
  L.a = o;   o += sq;
  L.ds = L.hp == 32 ? L.k : o;
  if (L.hp != 32) o += sq;
  L.dq = o;  o += 3 * op;
  // the scratch's largest uses: x and the dbproj slots (the prologue); two
  // heads' dq | dk | dv and the LN1 slots (phase B and the epilogue)
  const size_t s1 = (size_t)N * L.ck * 2 + 16 * L.ck, s2 = 6 * op + 32 * L.ck;
  const size_t scratch = s1 > s2 ? s1 : s2;
  if (o - L.q < scratch) o = L.q + scratch;
  L.win = o;
  o = 0;
  L.ring = o;  o += ATT_STAGES * L.tile;
  L.wins = o;  o += nw * L.win;
  L.vec = o;   o += align128(sizeof(float) * 5 * c);
  L.stats = o; o += align128(sizeof(float) * nw * 2 * N);
  L.slot = o;  o += align128(sizeof(float) * nw * 4 * 3 * L.hp);
  L.bars = o;  o += 2 * ATT_STAGES * sizeof(uint64_t);
  L.total = o;
  return L;
}

// 16-byte asynchronous global -> shared copy; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ const bf16* at_byte(const unsigned char* base, int off) {
  return reinterpret_cast<const bf16*>(base + off);
}

// bf16(q * s) of a packed pair of bf16 q values: the A operand of the scores
__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16(f.x * s, f.y * s);
}

// d (m64 x hp) += A . B, B MN-major: one k16 step of the recompute
template <int HP>
__device__ __forceinline__ void wg_mma_mn(float (&d)[HP / 2], uint64_t da, uint64_t db) {
  if constexpr (HP == 16) hopper::wgmma_n16<hopper::KMAJ, hopper::MNMAJ>(d, da, db, 1);
  else hopper::wgmma_n32<hopper::KMAJ, hopper::MNMAJ>(d, da, db, 1);
}

// The warp's 16 x 64 product s += A (16 rows at r0 of an interleaved
// operand `w` wide, k = 0 .. 16 ksteps) . B^T, B stored [n][k] (64 rows of an
// interleaved operand `bw` wide): the scores q . k^T and da = do . v^T. `qs`:
// A's values are multiplied by it and rounded to bf16 first (0: as stored).
template <int KSTEPS>
__device__ __forceinline__ void mma_rows_nt(float (&s)[8][4], const unsigned char* a, int w,
                                            int r0, const unsigned char* b, int bw, float qs) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t fa[4];
    ldsm_x4(fa, at_byte(a, kmaj(r0 + (lane & 15), kk * 16 + (lane >> 4) * 8, w)));
    if (qs != 0.f) {
#pragma unroll
      for (int e = 0; e < 4; ++e) fa[e] = scale_pair(fa[e], qs);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t fb[4];
      ldsm_x4(fb, at_byte(b, kmaj(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                  kk * 16 + ((lane >> 3) & 1) * 8, bw)));
      mma_bf16(s[2 * np], fa, fb[0], fb[1]);
      mma_bf16(s[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// o (16 x HP) += bf16(p) (16 x 64, from registers) . B, B stored [k][n] (64 x
// HP, interleaved): a . v and dq = ds . k.
template <int HP>
__device__ __forceinline__ void mma_rows_pv(float (&o)[HP / 8][4], const float (&p)[8][4],
                                            const unsigned char* b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kb = 0; kb < N / 16; ++kb) {
    const uint32_t pa[4] = {
        pack_bf16(p[2 * kb][0], p[2 * kb][1]), pack_bf16(p[2 * kb][2], p[2 * kb][3]),
        pack_bf16(p[2 * kb + 1][0], p[2 * kb + 1][1]),
        pack_bf16(p[2 * kb + 1][2], p[2 * kb + 1][3]),
    };
#pragma unroll
    for (int dp = 0; dp < HP / 16; ++dp) {
      uint32_t fb[4];
      ldsm_x4_trans(fb, at_byte(b, kmaj(kb * 16 + (lane & 15), dp * 16 + (lane >> 4) * 8, HP)));
      mma_bf16(o[2 * dp], pa, fb[0], fb[1]);
      mma_bf16(o[2 * dp + 1], pa, fb[2], fb[3]);
    }
  }
}

// o (16 x HP) += at^T[r0 .. r0+15, :] . B with at stored [q][key] (64 x 64,
// interleaved) and B stored [q][n] (64 x HP): dv = a^T . do, dk = ds^T . q.
template <int HP>
__device__ __forceinline__ void mma_rows_tn(float (&o)[HP / 8][4], const unsigned char* at, int r0,
                                            const unsigned char* b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t fa[4];
    ldsm_x4_trans(fa, at_byte(at, kmaj(kk * 16 + ((lane >> 4) & 1) * 8 + (lane & 7),
                                       r0 + ((lane >> 3) & 1) * 8, N)));
#pragma unroll
    for (int dp = 0; dp < HP / 16; ++dp) {
      uint32_t fb[4];
      ldsm_x4_trans(fb, at_byte(b, kmaj(kk * 16 + (lane & 15), dp * 16 + (lane >> 4) * 8, HP)));
      mma_bf16(o[2 * dp], fa, fb[0], fb[1]);
      mma_bf16(o[2 * dp + 1], fa, fb[2], fb[3]);
    }
  }
}

// Persistent blocks: consumer warpgroup j (block * nw + its index) walks
// windows j * wpw .. j * wpw + wpw - 1 in order, one 8x8 window at a time,
// and keeps its sums (dbqkv, dbproj, dln1 w|b, the bias-table gradient) in
// row j of `part`: each address there has one owner thread, which stores on
// the warpgroup's first window and adds on the later ones (the bias table
// by a load issued at the head's start, the rest by a reduction that this
// thread alone issues), so in window order. The producer thread streams
// the packed tiles into the ring once per window pass, so a tile serves the
// nw windows of the block, 64 rows each; a consumer warp arrives on a
// slot's `empty` barrier once its products have read the tile.
//
// Per window: x and dh arrive by 16-byte asynchronous copies; dhs =
// bf16(dp * dh) and LN1's xn go into shared memory (and to global memory in
// 16-byte runs). Phase A, per head h: q, k, v = xn . w{q,k,v}[:, h] + b and
// do = dhs . wproj[h, :]^T (wgmma, the tiles released at once); per warp (16
// query rows, 16 key rows) the scores, softmax, attention output, da, ds
// and dq (mma.sync); dv = a^T . do and dk = ds^T . q once a and ds of every
// row are in shared memory; dq | dk | dv to global memory. Phase B: dxn =
// sum over h of [dq | dk | dv]_h . [wq | wk | wv][:, h]^T (wgmma), each
// head's operand back from global memory (L2) by asynchronous copies, so
// that dxn's fp32 accumulators are live only here and in the epilogue and
// phase A keeps its registers for the attention. Then LN1's backward and dx
// through shared memory.
//
// F32 (K4b): dx's residual is dh32, the fp32 dh of the MLP phase, read from
// device memory in the epilogue (p.dh, its bf16 rounding, still feeds do and
// dWproj), and dbproj is left out of `part`: the MLP phase sums it from the
// fp32 dh.
template <int NCH, int HP, bool F32>
__device__ __forceinline__ void attn_wg_body(const AttnWgParams& p, int nw, unsigned char* asm_s,
                                             const float* dh32) {
  using namespace hopper;
  constexpr int CK = NCH * TILE, TB = CK * HP * 2, CGS = HP * 16, NB = HP / 8;
  const int C = p.c, CIO = p.cio, heads = p.heads, hd = p.hd, DW = p.dw;
  const AttnWgLayout L = attn_wg_layout(C, heads, nw);
  float* vec = reinterpret_cast<float*>(asm_s + L.vec);  // ln1_w | ln1_b | bqkv
  uint64_t* full = reinterpret_cast<uint64_t*>(asm_s + L.bars);
  uint64_t* empty = full + ATT_STAGES;
  const int tid = threadIdx.x, wgi = tid >> 7;
  for (int i = tid; i < C; i += blockDim.x) {
    vec[i] = __ldg(p.ln1_w + i);
    vec[C + i] = __ldg(p.ln1_b + i);
  }
  for (int i = tid; i < 3 * C; i += blockDim.x) vec[2 * C + i] = __ldg(p.bqkv + i);
  if (tid == 0) {
    for (int s = 0; s < ATT_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * nw);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int per_pass = 7 * heads;  // a window pass: wproj, wq, wk, wv per head; wq, wk, wv again

  if (wgi == nw) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == nw * 128) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(p.wpack);
      uint32_t i = 0;
      for (int it = 0; it < p.wpw; ++it)
        for (int t = 0; t < per_pass; ++t, ++i) {
          const int u = t - 4 * heads;  // phase B: tile 1 + u % 3 of head u / 3
          const int packed = u < 0 ? t : 4 * (u / 3) + 1 + u % 3;
          const uint32_t st = i & 3, use = i >> 2;
          if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
          mbar_arrive_expect_tx(&full[st], TB);
          bulk_load(asm_s + L.ring + st * TB, src + (size_t)packed * TB, TB, &full[st]);
        }
    }
    return;
  }

  // consumer warpgroup wgi
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wt = tid & 127, wi = wt >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * wi;  // the warp's 16 rows: query rows, key rows, token rows
  unsigned char* wb = asm_s + L.wins + (size_t)wgi * L.win;
  unsigned char *xn_s = wb + L.xn, *dhs_s = wb + L.dhs, *q_s = wb + L.q, *k_s = wb + L.k,
                *v_s = wb + L.v, *do_s = wb + L.dop, *a_s = wb + L.a, *ds_s = wb + L.ds,
                *dq_s = wb + L.dq, *scr = wb + L.q;
  float* stats = reinterpret_cast<float*>(asm_s + L.stats) + wgi * 2 * N;
  float* slot = reinterpret_cast<float*>(asm_s + L.slot) + wgi * 4 * 3 * HP;
  const int prow = blockIdx.x * nw + wgi;
  const size_t LP = 3 * (size_t)DW + 3 * C + (size_t)heads * N * N;
  float* part = p.part + (size_t)prow * LP;  // used only on live windows
  const float qscale = round_bf16(p.scale);
  auto wg_sync = [&] { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory"); };
  auto proxy_fence = [] { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); };
  // into this warpgroup's partial: each address has one owner thread, which
  // stores on the warpgroup's first window and adds on the later ones (a
  // reduction that this thread alone issues, so in window order)
  auto sum_into = [](float* dst, float v, bool first) {
    if (first) *dst = v;
    else atomicAdd(dst, v);
  };
  // the ring: tiles consumed so far; tile j from there, its wait and release
  uint32_t tc = 0;
  auto tile = [&](int j) { return asm_s + L.ring + ((tc + j) & 3) * TB; };
  auto wait_tiles = [&](int n) {
    for (int j = 0; j < n; ++j) mbar_wait(&full[(tc + j) & 3], ((tc + j) >> 2) & 1);
  };
  auto release_tiles = [&](int n) {
    if (lane == 0)
      for (int j = 0; j < n; ++j) mbar_arrive(&empty[(tc + j) & 3]);
    tc += n;
  };
  // a (64, w) bf16 window in global memory into dense shared memory: 16-byte
  // asynchronous copies (w * 64 * 2 bytes, a multiple of 16)
  auto fetch_rows = [&](unsigned char* dst, const bf16* src, int w) {
    for (int i = wt; i < N * w / 8; i += 128) cp_async16(dst + 16 * i, src + 8 * i, true);
  };
  // columns 0 .. w-1 of a 64-row interleaved operand (CK wide) to a dense
  // (64, w) window in global memory: 8-byte pieces into the dense staging
  // area, then 16-byte runs out
  auto store_rows = [&](bf16* dst, const unsigned char* src, int w) {
    const int quads = w >> 2;
    for (int i = wt; i < N * quads; i += 128) {
      const int r = i / quads, q4 = i - r * quads;
      *reinterpret_cast<uint2*>(scr + (size_t)(r * w + 4 * q4) * 2) =
          *reinterpret_cast<const uint2*>(src + kmaj(r, 4 * q4, CK));
    }
    wg_sync();
    const uint4* s4 = reinterpret_cast<const uint4*>(scr);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = wt; i < N * w / 8; i += 128) d4[i] = s4[i];
    wg_sync();
  };

  for (int it = 0; it < p.wpw; ++it) {
    const int win = prow * p.wpw + it;
    const bool live = win < p.bw, first = it == 0;
    const size_t row0 = (size_t)win * N;
    const float dscale = live && p.dp != nullptr ? __ldg(p.dp + win) : 1.f;
    const float* mask =
        live && p.mask != nullptr ? p.mask + (size_t)(win % p.nmask) * N * N : nullptr;

    // ---- the window's x (into the scratch) and dh (over xn_s) by 16-byte
    // asynchronous copies; dhs = bf16(dscale * dh) into dhs_s (zero past
    // cio) and dbproj = dscale * dh's column sums (each warp's 16 rows in
    // order, then the four warps in order); LN1 (two-pass fp32 statistics
    // over the cio real columns) into xn_s; xn and dhs to global
    if (live) {
      constexpr int NV = MAX_C / 32;
      const bf16* xs = reinterpret_cast<const bf16*>(scr);
      const bf16* dsrc = reinterpret_cast<const bf16*>(xn_s);
      float* cslot = reinterpret_cast<float*>(scr + (size_t)N * CK * 2);  // past x
      fetch_rows(scr, p.x + row0 * CIO, CIO);
      fetch_rows(xn_s, p.dh + row0 * CIO, CIO);
      cp_async_commit();
      cp_async_wait<0>();
      wg_sync();
      float cs[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) cs[i] = 0.f;
#pragma unroll 1
      for (int r = r0; r < r0 + 16; ++r)
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int c = lane + 32 * i;
          if (c >= CK) continue;
          const float d = c < CIO ? __bfloat162float(dsrc[r * CIO + c]) : 0.f;
          cs[i] += d;
          *reinterpret_cast<bf16*>(dhs_s + kmaj(r, c, CK)) = __float2bfloat16(d * dscale);
        }
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = lane + 32 * i;
        if (c < C) cslot[wi * CK + c] = cs[i];
      }
      wg_sync();  // dh is read: xn_s is free; cslot complete
      if constexpr (!F32)
        for (int c = wt; c < C; c += 128)
          sum_into(part + 3 * DW + c,
                   dscale * (((cslot[c] + cslot[CK + c]) + cslot[2 * CK + c]) + cslot[3 * CK + c]),
                   first);
      constexpr int RW = 4;  // rows at a time: four independent reduction chains
#pragma unroll 1
      for (int rr = r0; rr < r0 + 16; rr += RW) {
        float v[RW][NV], mu[RW], rstd[RW];
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int c = lane + 32 * i;
            v[q][i] = c < CIO ? __bfloat162float(xs[(rr + q) * CIO + c]) : 0.f;
            sum += v[q][i];
          }
          mu[q] = warp_sum(sum) / CIO;
        }
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          float sq = 0.f;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int c = lane + 32 * i;
            const float d = c < CIO ? v[q][i] - mu[q] : 0.f;
            sq += d * d;
          }
          rstd[q] = rsqrtf(warp_sum(sq) / CIO + 1e-5f);
        }
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          if (lane == 0) {
            stats[rr + q] = mu[q];
            stats[N + rr + q] = rstd[q];
          }
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int c = lane + 32 * i;
            if (c < CK)
              *reinterpret_cast<bf16*>(xn_s + kmaj(rr + q, c, CK)) = __float2bfloat16(
                  c < CIO ? (v[q][i] - mu[q]) * rstd[q] * vec[c] + vec[C + c] : 0.f);
          }
        }
      }
      wg_sync();  // x is read: the scratch is free
      store_rows(p.xn + row0 * C, xn_s, C);
      if (p.dhs != nullptr) store_rows(p.dhs + row0 * C, dhs_s, C);
      proxy_fence();  // xn and dhs, written here, are read by wgmma
      wg_sync();
    }

    // ---- phase A, per head h: everything up to dq | dk | dv
    for (int h = 0; h < heads; ++h) {
      wait_tiles(4);
      if (!live) {
        release_tiles(4);
        continue;
      }
      float* db = part + 3 * DW + 3 * C + (size_t)h * N * N;
      float2 pb[8][2];  // this thread's elements of the head's bias-table partial
      if (!first) {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          pb[t][0] = *reinterpret_cast<const float2*>(db + (r0 + g) * N + t * 8 + t4 * 2);
          pb[t][1] = *reinterpret_cast<const float2*>(db + (r0 + g + 8) * N + t * 8 + t4 * 2);
        }
      }

      // q, k, v of head h (+ b, rounded) and do = bf16(dhs . wproj[h, :]^T)
      {
        float aq[HP / 2], ak[HP / 2], av[HP / 2], ao[HP / 2];
#pragma unroll
        for (int i = 0; i < HP / 2; ++i) aq[i] = ak[i] = av[i] = ao[i] = 0.f;
        fence_regs(aq);
        fence_regs(ak);
        fence_regs(av);
        fence_regs(ao);
        const unsigned char *tp = tile(0), *tq = tile(1), *tk = tile(2), *tv = tile(3);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < CK / 16; ++ks) {
          const uint64_t dxa = desc(xn_s + ks * 256, 128, CK * 16);
          wg_mma_mn<HP>(aq, dxa, desc(tq + ks * 2 * CGS, CGS, 128));
          wg_mma_mn<HP>(ak, dxa, desc(tk + ks * 2 * CGS, CGS, 128));
          wg_mma_mn<HP>(av, dxa, desc(tv + ks * 2 * CGS, CGS, 128));
          wg_mma_mn<HP>(ao, desc(dhs_s + ks * 256, 128, CK * 16),
                        desc(tp + ks * 2 * CGS, CGS, 128));
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(aq);
        fence_regs(ak);
        fence_regs(av);
        fence_regs(ao);
        release_tiles(4);
        const float* bq = vec + 2 * C + h * hd;
#pragma unroll
        for (int jb = 0; jb < NB; ++jb)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = r0 + g + 8 * hh, d = 8 * jb + 2 * t4, e = 4 * jb + 2 * hh;
            const bool real = d < hd;  // d and hd even: both columns or neither
            const int off = kmaj(r, d, HP);
            *reinterpret_cast<uint32_t*>(q_s + off) =
                real ? pack_bf16(aq[e] + bq[d], aq[e + 1] + bq[d + 1]) : 0u;
            *reinterpret_cast<uint32_t*>(k_s + off) =
                real ? pack_bf16(ak[e] + bq[C + d], ak[e + 1] + bq[C + d + 1]) : 0u;
            *reinterpret_cast<uint32_t*>(v_s + off) =
                real ? pack_bf16(av[e] + bq[2 * C + d], av[e + 1] + bq[2 * C + d + 1]) : 0u;
            *reinterpret_cast<uint32_t*>(do_s + off) = pack_bf16(ao[e], ao[e + 1]);
          }
      }
      wg_sync();  // q, k, v, do of every row in place

      // per warp, 16 query rows: a = softmax(bf16(q * scale) . k^T + bias (+
      // mask)); attention output a . v; da = do . v^T; ds = a * (da -
      // rowsum(da * a)); dq = bf16(ds) . k * scale
      const float* bh = p.bias + (size_t)h * N * N;
      float a[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t) {  // the bias (and mask) is the accumulator's starting value
        float2 b0 = *reinterpret_cast<const float2*>(bh + (r0 + g) * N + t * 8 + t4 * 2);
        float2 b1 = *reinterpret_cast<const float2*>(bh + (r0 + g + 8) * N + t * 8 + t4 * 2);
        if (mask != nullptr) {
          const float2 m0 = *reinterpret_cast<const float2*>(mask + (r0 + g) * N + t * 8 + t4 * 2);
          const float2 m1 =
              *reinterpret_cast<const float2*>(mask + (r0 + g + 8) * N + t * 8 + t4 * 2);
          b0.x += m0.x; b0.y += m0.y; b1.x += m1.x; b1.y += m1.y;
        }
        a[t][0] = b0.x; a[t][1] = b0.y; a[t][2] = b1.x; a[t][3] = b1.y;
      }
      mma_rows_nt<HP / 16>(a, q_s, HP, r0, k_s, HP, qscale);
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
      // one division a row, then products: a masked key's exp is denormal,
      // and dividing it takes the division's slow path
      const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        a[t][0] *= i0; a[t][1] *= i0;
        a[t][2] *= i1; a[t][3] *= i1;
      }
      {  // attention output, staged in the warp's rows of dq_s, out in 16-byte runs
        float o[NB][4] = {};
        mma_rows_pv<HP>(o, a, v_s);
        unsigned char* stg = dq_s + wi * 2 * (3 * HP * 16);
#pragma unroll
        for (int jb = 0; jb < NB; ++jb)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<uint32_t*>(stg + kmaj(g + 8 * hh, 8 * jb + 2 * t4, HP)) =
                pack_bf16(o[jb][2 * hh], o[jb][2 * hh + 1]);
        __syncwarp();
        for (int i = lane; i < 16 * NB; i += 32) {
          const int rl = i / NB, jb = i - rl * NB;
          *reinterpret_cast<uint4*>(p.att + (row0 + r0 + rl) * DW + h * HP + 8 * jb) =
              *reinterpret_cast<const uint4*>(stg + kmaj(rl, 8 * jb, HP));
        }
        __syncwarp();
      }
      float ds[8][4] = {};
      mma_rows_nt<HP / 16>(ds, do_s, HP, r0, v_s, HP, 0.f);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        s0 += ds[t][0] * a[t][0] + ds[t][1] * a[t][1];
        s1 += ds[t][2] * a[t][2] + ds[t][3] * a[t][3];
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        ds[t][0] = a[t][0] * (ds[t][0] - s0); ds[t][1] = a[t][1] * (ds[t][1] - s0);
        ds[t][2] = a[t][2] * (ds[t][2] - s1); ds[t][3] = a[t][3] * (ds[t][3] - s1);
        float2 v0 = make_float2(ds[t][0], ds[t][1]), v1 = make_float2(ds[t][2], ds[t][3]);
        if (!first) {
          v0.x += pb[t][0].x; v0.y += pb[t][0].y; v1.x += pb[t][1].x; v1.y += pb[t][1].y;
        }
        *reinterpret_cast<float2*>(db + (r0 + g) * N + t * 8 + t4 * 2) = v0;
        *reinterpret_cast<float2*>(db + (r0 + g + 8) * N + t * 8 + t4 * 2) = v1;
      }
      float dq[NB][4] = {};
      mma_rows_pv<HP>(dq, ds, k_s);  // ds rounded to bf16 as it is packed
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        *reinterpret_cast<uint32_t*>(a_s + kmaj(r0 + g, t * 8 + t4 * 2, N)) =
            pack_bf16(a[t][0], a[t][1]);
        *reinterpret_cast<uint32_t*>(a_s + kmaj(r0 + g + 8, t * 8 + t4 * 2, N)) =
            pack_bf16(a[t][2], a[t][3]);
      }
      // dq | dk | dv of the warp's rows into dq_s (columns which * HP ..) and
      // their column sums over the warp's 16 rows into slot[wi]
      auto put = [&](float (&v)[NB][4], int which) {
#pragma unroll
        for (int jb = 0; jb < NB; ++jb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[jb][e] *= which < 2 ? p.scale : 1.f;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<uint32_t*>(
                dq_s + kmaj(r0 + g + 8 * hh, which * HP + 8 * jb + 2 * t4, 3 * HP)) =
                pack_bf16(v[jb][2 * hh], v[jb][2 * hh + 1]);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float s = v[jb][e] + v[jb][e + 2];
            s += __shfl_xor_sync(0xffffffffu, s, 4);
            s += __shfl_xor_sync(0xffffffffu, s, 8);
            s += __shfl_xor_sync(0xffffffffu, s, 16);
            if (g == 0) slot[wi * 3 * HP + which * HP + 8 * jb + 2 * t4 + e] = s;
          }
        }
      };
      wg_sync();  // a of every row in place; k and v read for the last time
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        *reinterpret_cast<uint32_t*>(ds_s + kmaj(r0 + g, t * 8 + t4 * 2, N)) =
            pack_bf16(ds[t][0], ds[t][1]);
        *reinterpret_cast<uint32_t*>(ds_s + kmaj(r0 + g + 8, t * 8 + t4 * 2, N)) =
            pack_bf16(ds[t][2], ds[t][3]);
      }
      put(dq, 0);
      {  // dv = a^T . do over the warp's 16 key rows
        float dv[NB][4] = {};
        mma_rows_tn<HP>(dv, a_s, r0, do_s);
        put(dv, 2);
      }
      wg_sync();  // ds of every row in place
      {  // dk = ds^T . q * scale, with the unscaled q
        float dk[NB][4] = {};
        mma_rows_tn<HP>(dk, ds_s, r0, q_s);
        put(dk, 1);
      }
      // the warp's rows of dq | dk | dv (its own writes) to global in 16-byte runs
      __syncwarp();
      for (int i = lane; i < 16 * 3 * NB; i += 32) {
        const int rl = i / (3 * NB), rem = i - rl * 3 * NB, which = rem / NB, jb = rem - which * NB;
        *reinterpret_cast<uint4*>(p.dqkv + (row0 + r0 + rl) * 3 * DW + which * DW + h * HP +
                                  8 * jb) =
            *reinterpret_cast<const uint4*>(dq_s + kmaj(r0 + rl, which * HP + 8 * jb, 3 * HP));
      }
      wg_sync();  // the column-sum slots of every warp in place
      for (int i = wt; i < 3 * HP; i += 128) {  // dbqkv of the head: the warps in order
        const int which = i / HP;
        sum_into(part + which * DW + h * HP + (i - which * HP),
                 ((slot[i] + slot[3 * HP + i]) + slot[6 * HP + i]) + slot[9 * HP + i], first);
      }
    }

    // ---- phase B: dxn = sum over the heads of [dq | dk | dv]_h . [wq | wk |
    // wv][:, h]^T (wgmma), each head's operand back from global memory into
    // two alternating buffers over the scratch; meanwhile x and dh arrive
    // over xn_s and dhs_s for the epilogue
    float dxn[NCH][32];
#pragma unroll
    for (int k = 0; k < NCH; ++k)
#pragma unroll
      for (int i = 0; i < 32; ++i) dxn[k][i] = 0.f;
    const size_t qb = (size_t)N * 3 * HP * 2;  // bytes of one head's operand
    auto fetch_head = [&](int h) {
      unsigned char* dst = scr + (h & 1) * qb;
      for (int i = wt; i < N * 3 * NB; i += 128) {
        const int r = i / (3 * NB), rem = i - r * 3 * NB, which = rem / NB, jb = rem - which * NB;
        cp_async16(dst + kmaj(r, which * HP + 8 * jb, 3 * HP),
                   p.dqkv + (row0 + r) * 3 * DW + which * DW + h * HP + 8 * jb, true);
      }
    };
    if (live) {
      wg_sync();  // every warp's dq | dk | dv are in global memory; the scratch is free
      fetch_rows(xn_s, p.x + row0 * CIO, CIO);
      if constexpr (!F32) fetch_rows(dhs_s, p.dh + row0 * CIO, CIO);
      fetch_head(0);
      cp_async_commit();
    }
    for (int h = 0; h < heads; ++h) {
      if (live) {
        cp_async_wait<0>();
        proxy_fence();  // the copies, landed, are read by wgmma
        wg_sync();      // every thread's copies of head h landed; head h-1's products done
        if (h + 1 < heads) {
          fetch_head(h + 1);
          cp_async_commit();
        }
      }
      wait_tiles(3);
      if (live) {
        const unsigned char* qa = scr + (h & 1) * qb;
#pragma unroll
        for (int k = 0; k < NCH; ++k) fence_regs(dxn[k]);
        wg_fence();
#pragma unroll
        for (int which = 0; which < 3; ++which) {
          const unsigned char* wtile = tile(which);
#pragma unroll
          for (int ks = 0; ks < HP / 16; ++ks) {
            const uint64_t da = desc(qa + (which * (HP / 16) + ks) * 256, 128, 3 * HP * 16);
#pragma unroll
            for (int k = 0; k < NCH; ++k)
              wgmma_n64<KMAJ, KMAJ>(dxn[k], da, desc(wtile + k * 8 * CGS + ks * 256, 128, CGS), 1);
          }
        }
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int k = 0; k < NCH; ++k) fence_regs(dxn[k]);
      }
      release_tiles(3);
    }
    if (!live) continue;

    // ---- LN1 backward: dln1s, dln1b, dx = rstd * (dxh - mean(dxh) - xhat *
    // mean(dxh * xhat)) + dh, with dxh = dxn * ln1_w over the cio columns.
    // x and dh lie dense in xn_s and dhs_s (F32: dh in dh32); dxn passes through the scratch
    // one 64-column chunk at a time (fp32, rows of EP floats), so that the
    // sums run as short loops: a thread pair per column (rows 0-31, 32-63)
    // and per row (columns 0-31, 32-63 of the chunk); dx is written over dh
    constexpr int EP = TILE + 2;
    const bf16* xs = reinterpret_cast<const bf16*>(xn_s);
    bf16* dhd = reinterpret_cast<bf16*>(dhs_s);
    float* cbuf = reinterpret_cast<float*>(scr);
    const int half = wt & 1, er = wt >> 1, eh = 32 * half;  // also: column er, rows eh ..
    const float emu = stats[er], ers = stats[N + er];
    auto stage = [&](const float (&d)[32]) {
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(cbuf + (r0 + g + 8 * hh) * EP + 8 * j8 + 2 * t4) =
              make_float2(d[4 * j8 + 2 * hh], d[4 * j8 + 2 * hh + 1]);
    };
    auto xhat = [&](int r, int col) {
      return (__bfloat162float(xs[r * CIO + col]) - stats[r]) * stats[N + r];
    };
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      stage(dxn[k]);
      wg_sync();
      {  // dln1s, dln1b of column k * 64 + er, its rows in order
        const int col = k * TILE + er;
        float ca = 0.f, cb = 0.f;
        if (col < CIO) {
#pragma unroll 4
          for (int r = eh; r < eh + 32; ++r) {
            const float d = cbuf[r * EP + er];
            ca += d * xhat(r, col);
            cb += d;
          }
        }
        ca += __shfl_xor_sync(0xffffffffu, ca, 1);
        cb += __shfl_xor_sync(0xffffffffu, cb, 1);
        if (half == 0 && col < C) {
          sum_into(part + 3 * DW + C + col, ca, first);
          sum_into(part + 3 * DW + 2 * C + col, cb, first);
        }
      }
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {  // row er's sums over its columns of the chunk
        const int col = k * TILE + eh + j;
        if (col < CIO) {
          const float x0 = cbuf[er * EP + eh + j] * vec[col];
          s1 += x0;
          s2 += x0 * (__bfloat162float(xs[er * CIO + col]) - emu) * ers;
        }
      }
      wg_sync();  // the chunk is read before the next one is staged
    }
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      stage(dxn[k]);
      wg_sync();
#pragma unroll 4
      for (int j = 0; j < 32; j += 2) {
        const int col = k * TILE + eh + j;
        if (col < CIO) {  // col and cio even: both columns real
          const float2 xv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + er * CIO + col));
          __nv_bfloat162* dp2 = reinterpret_cast<__nv_bfloat162*>(dhd + er * CIO + col);
          const float2 res =
              F32 ? *reinterpret_cast<const float2*>(dh32 + (row0 + er) * CIO + col)
                  : __bfloat1622float2(*dp2);
          const float x0 = cbuf[er * EP + eh + j] * vec[col];
          const float x1 = cbuf[er * EP + eh + j + 1] * vec[col + 1];
          const float v0 = ers * (x0 - s1 / CIO - (xv.x - emu) * ers * (s2 / CIO)) + res.x;
          const float v1 = ers * (x1 - s1 / CIO - (xv.y - emu) * ers * (s2 / CIO)) + res.y;
          *dp2 = __floats2bfloat162_rn(v0, v1);
        }
      }
      wg_sync();
    }
    {
      const uint4* s4 = reinterpret_cast<const uint4*>(dhd);
      uint4* d4 = reinterpret_cast<uint4*>(p.dx + row0 * CIO);
      for (int i = wt; i < N * CIO / 8; i += 128) d4[i] = s4[i];
    }
    wg_sync();  // dx is read before the next window writes dhs_s
  }
}

// K4 / K9c
template <int NCH, int HP>
__global__ void __launch_bounds__(ATT_THREADS, 1) attn_wg_kernel(const AttnWgParams p, int nw) {
  extern __shared__ __align__(1024) unsigned char asm_s[];
  attn_wg_body<NCH, HP, false>(p, nw, asm_s, nullptr);
}

// K4b's attention phase: dh32 (Bw, 64, c) the MLP phase's fp32 dh
template <int NCH, int HP>
__global__ void __launch_bounds__(ATT_THREADS, 1)
    attn_wg_f32_kernel(const AttnWgParams p, int nw, const float* dh32) {
  extern __shared__ __align__(1024) unsigned char asm_s[];
  attn_wg_body<NCH, HP, true>(p, nw, asm_s, dh32);
}

// windows a block of the MLP window kernel: two where they fit in 227 KB
inline int mlp_windows(int c, int hidden) {
  return mlp_wg_layout(c, hidden, 2).total <= 232448 ? 2 : 1;
}

// The kernel's function attributes before its first launch: setmaxnreg
// moves registers between the warpgroups of a block, and the consumers' 232
// need the 168 the compiler gives each thread at launch (a build that leaves
// fewer is refused); then the dynamic shared memory.
template <typename Kernel>
cudaError_t prepare_wg(Kernel kernel, size_t smem, int min_regs) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs < min_regs) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Packs w1 and w2 into p.wpack and launches the MLP window kernel over bw
// windows (F32: K4b's, on h32 and dh32).
template <int NCH, bool F32>
cudaError_t launch_mlp(const MlpParams& p, int bw, cudaStream_t s, const float* h32,
                       float* dh32) {
  const int nw = mlp_windows(p.c, p.hidden);
  const size_t smem = mlp_wg_layout(p.c, p.hidden, nw).total;
  cudaError_t err;
  if constexpr (F32) err = prepare_wg(mlp_bwd_f32_kernel<NCH>, smem, MLP_MIN_REGS);
  else err = prepare_wg(mlp_bwd_kernel<NCH>, smem, MLP_MIN_REGS);
  if (err != cudaSuccess) return err;
  const int ck = (p.c + TILE - 1) / TILE * TILE;
  const long long packed = 2LL * ck * 64 * ((p.hidden + 63) / 64);
  mlp_pack_kernel<<<(int)(packed / 256 < 1024 ? packed / 256 + 1 : 1024), 256, 0, s>>>(
      p.w1, p.w2, p.c, p.hidden, ck, const_cast<bf16*>(p.wpack));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = (bw + nw - 1) / nw, threads = (nw + 1) * 128;
  if constexpr (F32) mlp_bwd_f32_kernel<NCH><<<blocks, threads, smem, s>>>(p, bw, nw, h32, dh32);
  else mlp_bwd_kernel<NCH><<<blocks, threads, smem, s>>>(p, bw, nw);
  return cudaGetLastError();
}

// K3 / K9b (and K4b's MLP phase with F32): checks the widths and
// alignments, packs the weights and launches bw windows.
template <bool F32>
int run_mlp(MlpParams p, int bw, void* stream, const float* h32 = nullptr,
            float* dh32 = nullptr) {
  const int c = p.c, cio = p.cio, hidden = p.hidden;
  if (bw <= 0 || c <= 0 || c > MAX_C || c % 4 != 0 || cio <= 0 || cio > c || cio % 2 != 0 ||
      hidden <= 0 || hidden % 4 != 0 || (F32 && (h32 == nullptr || dh32 == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (!aligned(p.h, 4) || !aligned(p.dout, 4) || !aligned(p.w1, 2) || !aligned(p.w2, 2) ||
      !aligned(p.dh, 4) || !aligned(p.wpack, 16) || !aligned(p.g, 4) || !aligned(p.du, 4) ||
      !aligned(h32, 8) || !aligned(dh32, 8))
    return (int)cudaErrorMisalignedAddress;
  p.cp = round16(c);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((c + TILE - 1) / TILE) {
    case 1: return (int)launch_mlp<1, F32>(p, bw, s, h32, dh32);
    case 2: return (int)launch_mlp<2, F32>(p, bw, s, h32, dh32);
    case 3: return (int)launch_mlp<3, F32>(p, bw, s, h32, dh32);
    default: return (int)launch_mlp<4, F32>(p, bw, s, h32, dh32);
  }
}

// windows a block of the attention window kernel: two where they fit in 227 KB
inline int attn_windows(int c, int heads) {
  return attn_wg_layout(c, heads, 2).total <= 232448 ? 2 : 1;
}

// Packs wqkv and wproj into p.wpack (F32: K4b packed them once for its
// recompute and this phase, and the launch reads them as they are) and
// launches the persistent window kernel (F32: K4b's, on dh32).
template <int NCH, int HP, bool F32>
cudaError_t launch_attn(const AttnWgParams& p, int nw, cudaStream_t s, const float* dh32) {
  const AttnWgLayout L = attn_wg_layout(p.c, p.heads, nw);
  cudaError_t err;
  if constexpr (F32) err = prepare_wg(attn_wg_f32_kernel<NCH, HP>, L.total, ATT_MIN_REGS);
  else err = prepare_wg(attn_wg_kernel<NCH, HP>, L.total, ATT_MIN_REGS);
  if (err != cudaSuccess) return err;
  if constexpr (!F32) {
    const long long packed = (long long)L.tile / 2 * 4 * p.heads;
    attn_pack_kernel<<<(int)(packed / 256 < 1024 ? packed / 256 + 1 : 1024), 256, 0, s>>>(
        p.wqkv, p.wproj, p.c, p.heads, L.ck, L.hp, p.wpack);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int rows = (p.bw + p.wpw - 1) / p.wpw;  // warpgroups with windows: rows of `part`
  const int blocks = (rows + nw - 1) / nw, threads = (nw + 1) * 128;
  if constexpr (F32) attn_wg_f32_kernel<NCH, HP><<<blocks, threads, L.total, s>>>(p, nw, dh32);
  else attn_wg_kernel<NCH, HP><<<blocks, threads, L.total, s>>>(p, nw);
  return cudaGetLastError();
}

// K4 / K9c (and K4b's attention phase with F32): checks the widths and
// alignments, packs the weights (not with F32) and launches the persistent
// window kernel, wpw windows a consumer warpgroup.
template <bool F32>
int run_attn(AttnWgParams p, void* stream, const float* dh32 = nullptr) {
  if (p.bw <= 0 || p.wpw <= 0 || !widths_ok(p.c, p.heads) || p.cio <= 0 || p.cio > p.c ||
      p.cio % 2 != 0 || (p.mask != nullptr && p.nmask <= 0) || (F32 && dh32 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!aligned(p.x, 4) || !aligned(p.dh, 4) || !aligned(p.wqkv, 2) || !aligned(p.wproj, 2) ||
      !aligned(p.bias, 8) || !aligned(p.mask, 8) || !aligned(p.dx, 16) || !aligned(p.xn, 16) ||
      !aligned(p.att, 16) || !aligned(p.dqkv, 16) || !aligned(p.dhs, 16) ||
      !aligned(p.part, 8) || !aligned(p.wpack, 16) || !aligned(dh32, 8))
    return (int)cudaErrorMisalignedAddress;
  p.hd = p.c / p.heads;
  p.hp = p.hd <= 16 ? 16 : 32;
  p.dw = p.heads * p.hp;
  const int nw = attn_windows(p.c, p.heads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nch = (p.c + TILE - 1) / TILE;
  if (p.hp == 16) {
    switch (nch) {
      case 1: return (int)launch_attn<1, 16, F32>(p, nw, s, dh32);
      case 2: return (int)launch_attn<2, 16, F32>(p, nw, s, dh32);
      case 3: return (int)launch_attn<3, 16, F32>(p, nw, s, dh32);
      default: return (int)launch_attn<4, 16, F32>(p, nw, s, dh32);
    }
  }
  switch (nch) {
    case 1: return (int)launch_attn<1, 32, F32>(p, nw, s, dh32);
    case 2: return (int)launch_attn<2, 32, F32>(p, nw, s, dh32);
    case 3: return (int)launch_attn<3, 32, F32>(p, nw, s, dh32);
    default: return (int)launch_attn<4, 32, F32>(p, nw, s, dh32);
  }
}

AttnWgParams attn_wg_params(const void* x, const void* dh, const void* ln1_w, const void* ln1_b,
                            const void* wqkv, const void* bqkv, const void* bias,
                            const void* wproj, void* dx, void* xn, void* att, void* dqkv,
                            void* part, void* wpack, int bw, int c, int heads, int wpw,
                            float scale) {
  AttnWgParams p = {};
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
  p.part = static_cast<float*>(part);
  p.wpack = static_cast<bf16*>(wpack);
  p.bw = bw;
  p.c = p.cio = c;
  p.heads = heads;
  p.nmask = 1;
  p.wpw = wpw;
  p.scale = scale;
  return p;
}

}  // namespace
