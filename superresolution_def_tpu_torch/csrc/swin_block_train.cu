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
//
// The window kernels' phases live in swin_bwd_phases.cuh, shared with K4b
// (swin_block_bwd.cu), which also uses steps 2 and 3 from here.

#include "swin_bwd_phases.cuh"

namespace {

using namespace swin;

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

  float dhn[NCH][4][4];
  mlp_chunks<NCH>(dhn, p, lda, abuf, dbuf, mid, ring, vec + 2 * C, slot, vout, row0);

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

template <int NCH>
__global__ void __launch_bounds__(THREADS, 1) attn_bwd_kernel(const AttnParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = p.c, CP = p.cp, CIO = p.cio, hd = p.hd;
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
  const size_t win = blockIdx.x;
  const size_t row0 = win * N;
  const bf16* xw = p.x + row0 * CIO;
  const bf16* dhw = p.dh + row0 * CIO;
  float* vout = p.vec + win * 6 * C;
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
  const AttnSmem sm = {abuf, dbuf, qkv, dop, prob, dsb, dpair, ring, vec, qmap, slot, lda};
  attn_pairs<NCH>(dxn, p, sm, vout, mask, win);

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
