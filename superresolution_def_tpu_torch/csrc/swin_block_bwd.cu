// K4b: the fused Swin block's whole backward from x and dout alone, the
// forward recomputed, for Hopper; bf16 activations and weights, fp32 sums.
//
// Replaces superresolution_def_tpu/kernels/swin_block.py::
// fused_swin_block_bwd (body _make_bwd_kernel), so the training forward
// (K1) need not keep h. It is one window kernel (one thread block per 8x8
// window, 8 warps); its weight gradients then take K3/K4's steps 2 and 3
// (wgrad_kernel, colsum_kernel in swin_block_train.cu: fixed summation
// order, no atomics, so two runs give the same bits).
//
// Its three phases share K1's (swin_block_kernel.cuh) and K3/K4's
// (swin_bwd_phases.cuh) device code. Its rounding points are the TPU
// kernel's, which differ from K2 + K3 + K4 in three places:
//   1. the recompute (K1's qkv_attention and proj_residual) keeps h in
//      fp32 and LN2's statistics and x-hat come from the fp32 h (K3 reads
//      K2's bf16 h);
//   2. the MLP half (K3's hidden loop, mlp_chunks) then LN2's backward give
//      an fp32 dh = LN2^T(dhn) + dout that stays fp32 into dbproj and into
//      dx's residual; only do's and dWproj's operands are bf16(dh) (K3
//      rounds dh to bf16 for K4);
//   3. the attention half (K4's head-pair loop, attn_pairs) on xn
//      recomputed from x.
// Shared memory: the phases cannot be stacked (K4's regions alone are ~190
// KB at C=180), so one region serves K1's q/k/v slots, then the fp32 h (46
// KB) and the du chunk, then K4's regions; the fp32 dh waits for the end in
// a per-token global scratch (94 MB at Bw=2048, written once and read once
// by the same thread), not in the 227 KB. About 195 KB at C=180: one block
// per SM, as K3 and K4.
//
// What bounds it: its function needs 141.5 MFLOP per window at the
// flagship widths (qkv, proj and the attention's two products forward, fc1
// forward, and the backward's 14 products), 0.293 ms at Bw=2048 at the
// bf16 peak; this design does 156.9 (the attention half recomputes qkv and
// the softmax a second time, as K4 does), moves K3's and K4's
// intermediates plus the fp32 dh scratch through memory, and runs K1/K3/K4's
// latency-bound tile loops on mma.sync.

#include "swin_block_kernel.cuh"
#include "swin_bwd_phases.cuh"

namespace {

using namespace swin;

struct BlockBwdParams {
  Params f;     // the forward's operands for the recompute: x, ln1, wqkv, bqkv, bias, wproj, bproj
  MlpParams m;  // dout, ln2, b1, w1, w2; writes hn, g, du
  AttnParams a; // wqkv, bias, wproj; writes dx, xn, att, dqkv, dbias
  bf16* dhb;    // (Bw*64, C) bf16(dh), for dWproj
  float* dh;    // (Bw*64, C) fp32 dh, from the MLP half to dx's residual
  float* vec;   // (Bw, 9C + hidden): dbqkv | dbproj | dln1s | dln1b | db1 | db2 | dln2s | dln2b
};

struct BlockBwdLayout {
  int lda;
  size_t a, d, big, hf, mid, qkv, dop, pr, dpair, ring, vec, stats1, stats2, red, qmap, slot,
      total;
};

// One region, `big`, serves the three phases in turn: K1's q, k, v slots of
// a head pair (the recompute), the fp32 h and the MLP's du chunk (the MLP
// half), K4's q, q*scale, k, v, do, a, ds and dq|dk|dv (the attention half).
__host__ __device__ inline BlockBwdLayout block_bwd_layout(int c, int cp, int hidden) {
  BlockBwdLayout L;
  L.lda = cp + 8;
  size_t o = 0;
  L.a = o;     o += align128(sizeof(bf16) * N * L.lda);  // xn | hn | xn
  L.d = o;     o += align128(sizeof(bf16) * N * L.lda);  // x window, attention out | dout | dh
  L.big = o;
  const size_t end_fwd = o + align128(sizeof(bf16) * 3 * 2 * N * LDQ);
  L.hf = o;
  L.mid = L.hf + align128(sizeof(float) * N * c);
  const size_t end_mlp = L.mid + align128(sizeof(bf16) * N * LDT);
  L.qkv = o;
  L.dop = L.qkv + align128(sizeof(bf16) * 4 * 2 * N * LDQ);
  L.pr = L.dop + align128(sizeof(bf16) * 2 * N * LDQ);
  L.dpair = L.pr + align128(sizeof(bf16) * 2 * 2 * N * LDP);
  const size_t end_attn = L.dpair + align128(sizeof(bf16) * 3 * N * LDT);
  o = end_fwd > end_mlp ? end_fwd : end_mlp;
  o = o > end_attn ? o : end_attn;
  L.ring = o;   o += align128(sizeof(bf16) * STAGES * TILE * LDT);
  L.vec = o;    o += align128(sizeof(float) * (8 * c + hidden));  // K1's offsets, b1 at 8C
  L.stats1 = o; o += align128(sizeof(float) * 2 * N);             // LN1 mean, 1/std
  L.stats2 = o; o += align128(sizeof(float) * 2 * N);             // LN2 mean, 1/std
  L.red = o;    o += align128(sizeof(float) * 2 * N);
  L.qmap = o;   o += align128(sizeof(int) * 2 * DP);
  L.slot = o;   o += align128(sizeof(float) * 4 * (3 * TILE > cp ? 3 * TILE : cp));
  L.total = o;
  return L;
}

template <int NCH>
__global__ void __launch_bounds__(THREADS, 1) block_bwd_kernel(const BlockBwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = p.f.c, CP = p.f.cp, hd = p.f.hd, hidden = p.m.hidden;
  const BlockBwdLayout L = block_bwd_layout(C, CP, hidden);
  bf16* abuf = reinterpret_cast<bf16*>(smem + L.a);
  bf16* dbuf = reinterpret_cast<bf16*>(smem + L.d);
  float* hf = reinterpret_cast<float*>(smem + L.hf);
  bf16* mid = reinterpret_cast<bf16*>(smem + L.mid);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  float* vec = reinterpret_cast<float*>(smem + L.vec);
  float* stats1 = reinterpret_cast<float*>(smem + L.stats1);
  float* stats2 = reinterpret_cast<float*>(smem + L.stats2);
  float* red = reinterpret_cast<float*>(smem + L.red);
  int* qmap = reinterpret_cast<int*>(smem + L.qmap);
  float* slot = reinterpret_cast<float*>(smem + L.slot);
  const int lda = L.lda;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 32, g = lane >> 2, tig = lane & 3;
  const size_t win = blockIdx.x;
  const size_t row0 = win * N;
  const bf16* xw = p.f.x + row0 * C;
  const bf16* dout = p.m.dout + row0 * C;
  float* vout = p.vec + win * (9 * C + hidden);
  float* vmlp = vout + 6 * C;  // db1 | db2 | dln2s | dln2b, K3's row layout
  auto col_of = [&](int ch, int t, int e) { return ch * TILE + c0 + t * 8 + tig * 2 + (e & 1); };

  // ---- the forward up to h, as K1 computes it: K1's q/k/v slots zeroed, the
  // window staged in dbuf, the vectors at K1's offsets (b1 in b2's slot)
  zero_smem(smem + L.big, sizeof(bf16) * 3 * 2 * N * LDQ);
  {
    const uint4* src = reinterpret_cast<const uint4*>(xw);
    uint4* dst = reinterpret_cast<uint4*>(dbuf);
    for (int i = tid; i < N * C / 8; i += THREADS) dst[i] = __ldg(src + i);
    const float* vsrc[] = {p.f.ln1_w, p.f.ln1_b, p.f.bqkv, p.f.bproj, p.m.ln2_w, p.m.ln2_b};
    const int voff[] = {V_LN1W, V_LN1B, V_BQKV, V_BPROJ, V_LN2W, V_LN2B};
    const int vlen[] = {C, C, 3 * C, C, C, C};
#pragma unroll
    for (int v = 0; v < 6; ++v)
      for (int i = tid; i < vlen[v]; i += THREADS) vec[voff[v] * C + i] = __ldg(vsrc[v] + i);
    for (int i = tid; i < hidden; i += THREADS) vec[V_B2 * C + i] = __ldg(p.m.b1 + i);
    for (int j = tid; j < 2 * hd; j += THREADS) qmap[j] = (j / hd) * N * LDQ + j % hd;
  }
  __syncthreads();
  const bf16* xs = dbuf;
  layer_norm_rows(
      abuf, lda, C, CP, [&](int r, int c) { return __bfloat162float(xs[r * C + c]); },
      vec + V_LN1W * C, vec + V_LN1B * C, stats1);
  __syncthreads();
  store_window(p.a.xn + row0 * C, abuf, lda, C);  // for dWqkv
  for (int i = tid; i < N * (CP - C); i += THREADS)
    dbuf[(i / (CP - C)) * lda + C + i % (CP - C)] = __float2bfloat16(0.f);
  qkv_attention(p.f, lda, abuf, dbuf, reinterpret_cast<bf16*>(smem + L.big), ring, vec, qmap,
                nullptr);
  {
    float h[NCH][4][4];
    proj_residual<NCH, false, false>(h, p.f, lda, dbuf, ring, vec, xw, 0, 1.f);
    // the fp32 h to shared memory (the q/k/v slots are dead): LN2's
    // statistics and x-hat come from it, not from bf16(h) as in K1 and K3
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + g + 8 * half, col = ch * TILE + c0 + t * 8 + tig * 2;
          if (col < C)
            *reinterpret_cast<float2*>(hf + r * C + col) =
                make_float2(h[ch][t][2 * half], h[ch][t][2 * half + 1]);
        }
  }
  __syncthreads();
  layer_norm_rows(
      abuf, lda, C, CP, [&](int r, int c) { return hf[r * C + c]; }, vec + V_LN2W * C,
      vec + V_LN2B * C, stats2);
  stage_padded(dbuf, lda, dout, C, CP, 1.f);
  window_colsum(vmlp + hidden, dout, C, C, 1.f);  // db2
  __syncthreads();
  store_window(p.m.hn + row0 * C, abuf, lda, C);  // for dW1

  // ---- the MLP half (K3's hidden loop), then LN2's backward from the fp32 h
  float dd[NCH][4][4];  // dhn, then dh in place
  mlp_chunks<NCH>(dd, p.m, lda, abuf, dbuf, mid, ring, vec + V_B2 * C, slot, vmlp, row0);
  {
    float mu[2], rstd[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mu[half] = stats2[r0 + g + 8 * half];
      rstd[half] = stats2[N + r0 + g + 8 * half];
    }
    auto xhat = [&](int ch, int t, int e) {
      const int col = col_of(ch, t, e), r = r0 + g + 8 * (e >> 1);
      return col < C ? (hf[r * C + col] - mu[e >> 1]) * rstd[e >> 1] : 0.f;
    };
    tile_colsum<NCH>(vmlp + hidden + C, slot, C, CP,
                     [&](int ch, int t, int e) { return dd[ch][t][e] * xhat(ch, t, e); });
    tile_colsum<NCH>(vmlp + hidden + 2 * C, slot, C, CP,
                     [&](int ch, int t, int e) { return dd[ch][t][e]; });
    auto dxh = [&](int ch, int t, int e) {
      const int col = col_of(ch, t, e);
      return col < C ? dd[ch][t][e] * vec[V_LN2W * C + col] : 0.f;
    };
    float s1[2], s2[2];
    row_sums<NCH>(s1, red, C, dxh);
    row_sums<NCH>(s2, red, C, [&](int ch, int t, int e) { return dxh(ch, t, e) * xhat(ch, t, e); });
    // dh = rstd * (dxh - mean(dxh) - xhat * mean(dxh * xhat)) + dout, kept
    // fp32: in dd, in p.dh for dx's residual; bf16 in dbuf (do's operand,
    // dout is consumed) and p.dhb (dWproj's)
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + g + 8 * half, col = ch * TILE + c0 + t * 8 + tig * 2;
          if (col >= C) {
            dd[ch][t][2 * half] = dd[ch][t][2 * half + 1] = 0.f;
            continue;
          }
          const float2 res =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + r * C + col));
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ee = 2 * half + e;
            const float d = rstd[half] * (dxh(ch, t, ee) - s1[half] / C -
                                          xhat(ch, t, ee) * (s2[half] / C));
            v[e] = d + (e == 0 ? res.x : res.y);
          }
          dd[ch][t][2 * half] = v[0];
          dd[ch][t][2 * half + 1] = v[1];
          const size_t at = (row0 + r) * C + col;
          *reinterpret_cast<float2*>(p.dh + at) = make_float2(v[0], v[1]);
          const __nv_bfloat162 vb = __floats2bfloat162_rn(v[0], v[1]);
          *reinterpret_cast<__nv_bfloat162*>(p.dhb + at) = vb;
          *reinterpret_cast<__nv_bfloat162*>(dbuf + r * lda + col) = vb;
        }
  }
  tile_colsum<NCH>(vout + 3 * C, slot, C, CP, [&](int ch, int t, int e) { return dd[ch][t][e]; });

  // ---- the attention half (K4's head-pair loop) on xn recomputed from x
  zero_smem(smem + L.qkv, sizeof(bf16) * 4 * 2 * N * LDQ);
  zero_smem(smem + L.dop, sizeof(bf16) * 2 * N * LDQ);
  layer_norm_rows(
      abuf, lda, C, CP, [&](int r, int c) { return __bfloat162float(xw[r * C + c]); },
      vec + V_LN1W * C, vec + V_LN1B * C);
  __syncthreads();
  float dxn[NCH][4][4];
  {
    bf16* prob = reinterpret_cast<bf16*>(smem + L.pr);
    const AttnSmem sm = {abuf,
                         dbuf,
                         reinterpret_cast<bf16*>(smem + L.qkv),
                         reinterpret_cast<bf16*>(smem + L.dop),
                         prob,
                         prob + 2 * N * LDP,
                         reinterpret_cast<bf16*>(smem + L.dpair),
                         ring,
                         vec,
                         qmap,
                         slot,
                         lda};
    attn_pairs<NCH>(dxn, p.a, sm, vout, nullptr, win);
  }

  // ---- LN1 backward; dx = LN1^T(dxn) + dh with the fp32 dh
  float mu[2], rstd[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mu[half] = stats1[r0 + g + 8 * half];
    rstd[half] = stats1[N + r0 + g + 8 * half];
  }
  auto xhat = [&](int ch, int t, int e) {
    const int col = col_of(ch, t, e), r = r0 + g + 8 * (e >> 1);
    return col < C ? (__bfloat162float(xw[r * C + col]) - mu[e >> 1]) * rstd[e >> 1] : 0.f;
  };
  tile_colsum<NCH>(vout + 4 * C, slot, C, CP,
                   [&](int ch, int t, int e) { return dxn[ch][t][e] * xhat(ch, t, e); });
  tile_colsum<NCH>(vout + 5 * C, slot, C, CP, [&](int ch, int t, int e) { return dxn[ch][t][e]; });
  auto dxh = [&](int ch, int t, int e) {
    const int col = col_of(ch, t, e);
    return col < C ? dxn[ch][t][e] * vec[V_LN1W * C + col] : 0.f;
  };
  float s1[2], s2[2];
  row_sums<NCH>(s1, red, C, dxh);
  row_sums<NCH>(s2, red, C, [&](int ch, int t, int e) { return dxh(ch, t, e) * xhat(ch, t, e); });
  bf16* dx = p.a.dx + row0 * C;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + 8 * half, col = ch * TILE + c0 + t * 8 + tig * 2;
        if (col >= C) continue;
        const float2 res = *reinterpret_cast<const float2*>(p.dh + (row0 + r) * C + col);
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ee = 2 * half + e;
          const float d = rstd[half] * (dxh(ch, t, ee) - s1[half] / C -
                                        xhat(ch, t, ee) * (s2[half] / C));
          v[e] = d + (e == 0 ? res.x : res.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(dx + r * C + col) = __floats2bfloat162_rn(v[0], v[1]);
      }
}

// K4b: checks the widths and alignments and launches bw windows.
int run_block_bwd(BlockBwdParams p, int bw, void* stream) {
  const int c = p.f.c, heads = p.f.heads, hidden = p.m.hidden;
  if (bw <= 0 || !widths_ok(c, heads) || hidden <= 0 || hidden % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned(p.f.x, 16) || !aligned(p.m.dout, 4) || !aligned(p.f.wqkv, 8) ||
      !aligned(p.f.wproj, 8) || !aligned(p.m.w1, 8) || !aligned(p.m.w2, 8) ||
      !aligned(p.f.bias, 8) || !aligned(p.a.dx, 4) || !aligned(p.dh, 8) || !aligned(p.dhb, 4) ||
      !aligned(p.a.dbias, 8))
    return (int)cudaErrorMisalignedAddress;
  const int cp = round16(c);
  p.f.cp = p.m.cp = p.a.cp = cp;
  p.f.hd = p.a.hd = c / heads;
  p.f.hidden_p = round16(hidden);
  const size_t smem = block_bwd_layout(c, cp, hidden).total;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((c + TILE - 1) / TILE) {
    case 1: return (int)launch_window(block_bwd_kernel<1>, bw, smem, s, p);
    case 2: return (int)launch_window(block_bwd_kernel<2>, bw, smem, s, p);
    case 3: return (int)launch_window(block_bwd_kernel<3>, bw, smem, s, p);
    default: return (int)launch_window(block_bwd_kernel<4>, bw, smem, s, p);
  }
}

}  // namespace

// K4b's window kernel. x, dout: (bw, 64, c) bf16; ln1 w/b, bqkv, bproj, ln2
// w/b, b1 fp32; wqkv (c, 3c), wproj (c, c), w1 (c, hidden), w2 (hidden, c)
// bf16; bias (heads, 64, 64) fp32. Writes dx (bw, 64, c); xn, att, hn and
// dhb (bw*64, c), dqkv (bw*64, 3c), g and du (bw*64, hidden) bf16; dh
// (bw*64, c), vec (bw, 9c + hidden) and dbias (bw, heads, 64, 64) fp32.
extern "C" int swin_bwd_block_bf16(const void* x, const void* dout, const void* ln1_w,
                                   const void* ln1_b, const void* wqkv, const void* bqkv,
                                   const void* bias, const void* wproj, const void* bproj,
                                   const void* ln2_w, const void* ln2_b, const void* w1,
                                   const void* b1, const void* w2, void* dx, void* xn, void* att,
                                   void* dqkv, void* hn, void* g, void* du, void* dhb, void* dh,
                                   void* vec, void* dbias, int bw, int c, int heads, int hidden,
                                   float scale, void* stream) {
  BlockBwdParams p = {};
  p.f.x = static_cast<const bf16*>(x);
  p.f.ln1_w = static_cast<const float*>(ln1_w);
  p.f.ln1_b = static_cast<const float*>(ln1_b);
  p.f.wqkv = static_cast<const bf16*>(wqkv);
  p.f.bqkv = static_cast<const float*>(bqkv);
  p.f.bias = static_cast<const float*>(bias);
  p.f.wproj = static_cast<const bf16*>(wproj);
  p.f.bproj = static_cast<const float*>(bproj);
  p.f.c = p.f.cio = c;
  p.f.heads = heads;
  p.f.hidden = hidden;
  p.f.scale = scale;
  p.m = mlp_params(nullptr, dout, ln2_w, ln2_b, w1, b1, w2, nullptr, hn, g, du, nullptr, c,
                   hidden);
  p.a = attn_params(x, nullptr, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, dx, xn, att, dqkv, nullptr,
                    dbias, c, heads, scale);
  p.dhb = static_cast<bf16*>(dhb);
  p.dh = static_cast<float*>(dh);
  p.vec = static_cast<float*>(vec);
  return run_block_bwd(p, bw, stream);
}

// Dynamic shared memory of the window kernel, for the wrapper's check.
extern "C" size_t swin_bwd_block_smem_bytes(int c, int hidden) {
  return block_bwd_layout(c, round16(c), hidden).total;
}
