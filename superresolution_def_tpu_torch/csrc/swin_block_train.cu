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
// summation order (bit-reproducible runs, no atomics whose order varies):
//
//   1. a window kernel computes everything that is per token: dh (K3) or
//      dx (K4), and writes the bf16 operands of the weight-gradient
//      products (K3: LN2 output hn, GELU output g, du; K4: LN1 output xn,
//      attention output, dq|dk|dv) plus its bias and LayerNorm gradients:
//      K3 one fp32 row per window, K4 one row per consumer warpgroup summed
//      over its windows (the (heads, 64, 64) bias-table gradient included);
//   2. wgrad_kernel: dW = A^T . B over all Bw*64 tokens, bf16 operands and
//      fp32 sums, each thread block summing one 192 x 192 tile over one
//      contiguous slice of tokens into its own partial;
//   3. colsum_kernel: sums the partials, and the window kernels' rows, in a
//      fixed order, one launch each, gathering the columns kept (K4/K9c:
//      each head's real columns out of its padded ones).
//
// Rounding points follow the TPU kernels: the operands of every product are
// the bf16 values the TPU kernel feeds its dots (hn, g, dout, du; xn, do,
// a, ds, q, k, v, dh, dq|dk|dv, attention output), everything else fp32;
// dh and dx are rounded to bf16 once, at the end. q is scaled and rounded
// before QK^T; dq and dk carry the scale in fp32; dk uses the unscaled q.
//
// What bounds them on the H100: at the flagship widths (C=180, 6 heads,
// hidden 720) K3 does 82.9 MFLOP and K4 54.5 MFLOP per window against 46 KB
// of window input and output, so both are compute-bound (0.172 and 0.113 ms
// at Bw=2048 at the bf16 peak); the split into three steps adds the
// intermediates' round trip through device memory (K3 writes 0.42 and K4
// 0.49 GB at Bw=2048, which the TPU kernel keeps in VMEM, and step 2 reads
// them back). In practice both window kernels are bound by latency, not by
// the tensor cores: per window a chain of small products, barriers and
// reductions, with two windows (eight warps) on an SM.
//
// Both window kernels run two windows a block, one consumer warpgroup each,
// so each weight tile that lands in shared memory serves 128 token rows; the
// weights, packed once per call into the layout wgmma reads (mlp_pack_kernel,
// attn_pack_kernel), come in by TMA bulk copies into a 4-tile ring under
// mbarriers, with no block-wide barrier per tile, and setmaxnreg gives the
// producer warpgroup's registers to the consumers (the launchers refuse a
// build that leaves fewer than the hand-over needs). K3 (mlp_bwd_kernel):
// w1 and w2 of each 64-wide hidden chunk, one w1 tile serving u = hn . w1
// (MN-major B) and dhn = du . w1^T (K-major B); du stays in registers as
// dhn's A. K4 (attn_wg_kernel): persistent blocks, each consumer
// warpgroup walking a fixed slice of windows so that its bias-table
// gradient stays one 98 KB row in L2 instead of 98 KB a window; per head a
// (ck x hp) tile each of wproj, wq, wk, wv (hp: the head padded to 16 or 32
// columns); the qkv, do and dxn products on wgmma, the per-head 64 x 64
// attention products on mma.sync; xn, the attention output, dq|dk|dv and dx
// leave in 16-byte runs through shared memory. The header of attn_wg_kernel
// says how a window runs.
//
// The first design's phases live in swin_bwd_phases.cuh, kept there for K4b
// (swin_block_bwd.cu), which also uses steps 2 and 3 from here.

#include "hopper.cuh"
#include "swin_bwd_phases.cuh"
#include "swin_pack.cuh"

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
template <int NCH>
__global__ void __launch_bounds__(MLP_THREADS, 1) mlp_bwd_kernel(const MlpParams p, int bw,
                                                                 int nw) {
  using namespace hopper;
  extern __shared__ __align__(1024) unsigned char msm[];
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
    float* vout = p.vec + (size_t)win * (hidden + 3 * C);
    const float dscale = live && p.dp != nullptr ? __ldg(p.dp + win) : 1.f;
    const bf16* hw = p.h + row0 * CIO;
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
            v[q][i] = c < CIO ? __bfloat162float(hw[(r0 + q) * CIO + c]) : 0.f;
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
      const float2 hv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hw + r * CIO + col));
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
template <int NCH, int HP>
__global__ void __launch_bounds__(ATT_THREADS, 1) attn_wg_kernel(const AttnWgParams p, int nw) {
  using namespace hopper;
  extern __shared__ __align__(1024) unsigned char asm_s[];
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
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        a[t][0] /= l0; a[t][1] /= l0;
        a[t][2] /= l1; a[t][3] /= l1;
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
      fetch_rows(dhs_s, p.dh + row0 * CIO, CIO);
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
    // x and dh lie dense in xn_s and dhs_s; dxn passes through the scratch
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
          const float2 res = __bfloat1622float2(*dp2);
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

// ===========================================================================
// Weight gradients and ordered column sums.
// ===========================================================================

// part[split][m][n] = sum over the tokens t of this split's slice of
// a[t][m] * b[t][n] (a: (T, M), b: (T, N) bf16 row-major, M and N multiples
// of 4; fp32 sums, in token order within each 16-token wgmma step).
//
// One thread block per (192 x 192 output tile, token slice): three consumer
// warpgroups, each owning 64 rows of the tile as three m64n64 wgmma
// accumulators, and one producer warpgroup that streams 64-token slabs of a
// and b into a 4-stage ring. Both operands are MN-major (the token index is
// K): each slab lands in the interleaved layout, 16-byte chunks of 8
// consecutive m (or n) of one token, token-contiguous within a group of 8
// columns. TMA's tensor maps need 16-byte row strides, and the operands'
// rows are 360 bytes at C = 180, so the producer fills the ring with
// cp.async (16-byte copies where the rows allow, 8-byte otherwise), each
// thread arriving on the stage's mbarrier once its copies land; consumers
// release a stage on a second mbarrier once their products have read it.
// No block-wide barrier in the loop.
namespace wg {
constexpr int BM = 192, BN = 192, BK = 64, STAGES = 4;
constexpr int CONSUMERS = 3, THREADS = (CONSUMERS + 1) * 128;
constexpr int SLAB = BM * BK * 2;  // bytes of one operand's slab (BM == BN)
constexpr size_t SMEM = (size_t)STAGES * 2 * SLAB + 2 * STAGES * sizeof(uint64_t);
}  // namespace wg

// One 64-token slab of x (T, W) columns w0 .. w0+191 into the interleaved
// MN-major layout: column group q (8 columns) at q * 1024 bytes, token k at
// k * 16 within it. Zero outside the matrix.
__device__ __forceinline__ void load_slab(unsigned char* dst, const bf16* x, int T, int W, int t0,
                                          int w0, bool wide, int ptid) {
  const int lane = ptid & 31, pw = ptid >> 5;
#pragma unroll 4
  for (int j = pw; j < 8 * (wg::BM / 32); j += 4) {  // (8-token block, 4 column groups)
    const int k = (j / (wg::BM / 32)) * 8 + (lane & 7);
    const int q = (j % (wg::BM / 32)) * 4 + (lane >> 3);
    const int t = t0 + k, col = w0 + q * 8;
    unsigned char* d = dst + q * 1024 + k * 16;
    const bf16* src = x + (size_t)t * W + col;
    if (wide) {
      const bool ok = t < T && col < W;
      cp_async16(d, ok ? src : x, ok);
    } else {
      const bool ok0 = t < T && col < W, ok1 = t < T && col + 4 < W;
      cp_async8(d, ok0 ? src : x, ok0);
      cp_async8(d + 8, ok1 ? src + 4 : x, ok1);
    }
  }
}

__global__ void __launch_bounds__(wg::THREADS, 1)
    wgrad_kernel(const bf16* a, const bf16* b, int T, int M, int Nn, int rows_per_split,
                 bool wide_a, bool wide_b, float* part) {
  using namespace hopper;
  extern __shared__ __align__(1024) unsigned char wsm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(wsm + wg::STAGES * 2 * wg::SLAB);
  uint64_t* empty = full + wg::STAGES;
  const int tid = threadIdx.x, wgi = tid >> 7;
  const int n0 = blockIdx.x * wg::BN, m0 = blockIdx.y * wg::BM;
  const int t0 = blockIdx.z * rows_per_split;
  const int steps = (min(T, t0 + rows_per_split) - t0 + wg::BK - 1) / wg::BK;
  if (tid == 0) {
    for (int s = 0; s < wg::STAGES; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], wg::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (wgi == wg::CONSUMERS) {  // producer warpgroup
    const int ptid = tid - wg::CONSUMERS * 128;
    for (int s = 0; s < steps; ++s) {
      const int st = s % wg::STAGES;
      if (s >= wg::STAGES) mbar_wait(&empty[st], ((s / wg::STAGES) - 1) & 1);
      unsigned char* sa = wsm + st * 2 * wg::SLAB;
      load_slab(sa, a, T, M, t0 + s * wg::BK, m0, wide_a, ptid);
      load_slab(sa + wg::SLAB, b, T, Nn, t0 + s * wg::BK, n0, wide_b, ptid);
      mbar_arrive_cp_async(&full[st]);
    }
    cp_async_wait<0>();
    return;
  }
  // consumers: warpgroup wgi owns rows m0 + 64 wgi .. +63 (past M it
  // multiplies the slab's zeros, and writes nothing)
  const bool rows_live = m0 + 64 * wgi < M;
  float acc[3][32];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  for (int s = 0; s < steps; ++s) {
    const int st = s % wg::STAGES;
    mbar_wait(&full[st], (s / wg::STAGES) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const unsigned char* sa = wsm + st * 2 * wg::SLAB;
    const unsigned char* sb = sa + wg::SLAB;
#pragma unroll
    for (int c = 0; c < 3; ++c) fence_regs(acc[c]);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < wg::BK / 16; ++ks) {
      const uint64_t da = desc(sa + 8 * wgi * 1024 + ks * 256, 128, 1024);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        wgmma_n64<MNMAJ, MNMAJ>(acc[c], da, desc(sb + 8 * c * 1024 + ks * 256, 128, 1024), 1);
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < 3; ++c) fence_regs(acc[c]);
    if ((tid & 127) == 0) mbar_arrive(&empty[st]);
  }
  if (!rows_live) return;
  const int lane = tid & 31, w = (tid >> 5) & 3;
  float* out = part + (size_t)blockIdx.z * M * Nn;
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 64 * wgi + 16 * w + (lane >> 2) + 8 * h;
        const int n = n0 + 64 * c + 8 * j + 2 * (lane & 3);
        if (m < M && n < Nn)  // n even, N a multiple of 4: both columns are real
          *reinterpret_cast<float2*>(out + (size_t)m * Nn + n) =
              make_float2(acc[c][4 * j + 2 * h], acc[c][4 * j + 2 * h + 1]);
      }
}

// out[j] = the sum of in[r][idx[j]] (idx null: in[r][j]) over all R rows in a
// fixed order: eight row groups (r = g, g + 8, ..) in ascending r, then the
// eight groups in order. Grid ceil(nout / 32), 256 threads.
__global__ void __launch_bounds__(THREADS) colsum_kernel(const float* in, int R, int Nn,
                                                         const int* idx, int nout, float* out) {
  __shared__ float part[8][33];
  const int lx = threadIdx.x & 31, ly = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lx;
  float s = 0.f;
  if (j < nout) {
    const int n = idx != nullptr ? idx[j] : j;
    for (int r = ly; r < R; r += 8) s += in[(size_t)r * Nn + n];
  }
  part[ly][lx] = s;
  __syncthreads();
  if (ly == 0 && j < nout) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < 8; ++g) t += part[g][lx];
    out[j] = t;
  }
}

// windows a block of the MLP window kernel: two where they fit in 227 KB
inline int mlp_windows(int c, int hidden) {
  return mlp_wg_layout(c, hidden, 2).total <= 232448 ? 2 : 1;
}

template <int NCH>
cudaError_t launch_mlp(const MlpParams& p, int bw, cudaStream_t s) {
  const int nw = mlp_windows(p.c, p.hidden);
  const size_t smem = mlp_wg_layout(p.c, p.hidden, nw).total;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, mlp_bwd_kernel<NCH>);
  if (err != cudaSuccess) return err;
  // setmaxnreg moves registers between the warpgroups of a block: the
  // consumers' 232 need the 168 the compiler gives each thread at launch
  if (attr.numRegs < MLP_MIN_REGS) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(mlp_bwd_kernel<NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int ck = (p.c + TILE - 1) / TILE * TILE;
  const long long packed = 2LL * ck * 64 * ((p.hidden + 63) / 64);
  mlp_pack_kernel<<<(int)(packed / 256 < 1024 ? packed / 256 + 1 : 1024), 256, 0, s>>>(
      p.w1, p.w2, p.c, p.hidden, ck, const_cast<bf16*>(p.wpack));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlp_bwd_kernel<NCH><<<(bw + nw - 1) / nw, (nw + 1) * 128, smem, s>>>(p, bw, nw);
  return cudaGetLastError();
}

// K3 / K9b: checks the widths and alignments, packs the weights and
// launches bw windows.
int run_mlp(MlpParams p, int bw, void* stream) {
  const int c = p.c, cio = p.cio, hidden = p.hidden;
  if (bw <= 0 || c <= 0 || c > MAX_C || c % 4 != 0 || cio <= 0 || cio > c || cio % 2 != 0 ||
      hidden <= 0 || hidden % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned(p.h, 4) || !aligned(p.dout, 4) || !aligned(p.w1, 2) || !aligned(p.w2, 2) ||
      !aligned(p.dh, 4) || !aligned(p.wpack, 16) || !aligned(p.g, 4) || !aligned(p.du, 4))
    return (int)cudaErrorMisalignedAddress;
  p.cp = round16(c);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((c + TILE - 1) / TILE) {
    case 1: return (int)launch_mlp<1>(p, bw, s);
    case 2: return (int)launch_mlp<2>(p, bw, s);
    case 3: return (int)launch_mlp<3>(p, bw, s);
    default: return (int)launch_mlp<4>(p, bw, s);
  }
}

// windows a block of the attention window kernel: two where they fit in 227 KB
inline int attn_windows(int c, int heads) {
  return attn_wg_layout(c, heads, 2).total <= 232448 ? 2 : 1;
}

template <int NCH, int HP>
cudaError_t launch_attn(const AttnWgParams& p, int nw, cudaStream_t s) {
  const AttnWgLayout L = attn_wg_layout(p.c, p.heads, nw);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, attn_wg_kernel<NCH, HP>);
  if (err != cudaSuccess) return err;
  // setmaxnreg moves registers between the warpgroups of a block: the
  // consumers' 232 need the 168 the compiler gives each thread at launch
  if (attr.numRegs < ATT_MIN_REGS) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(attn_wg_kernel<NCH, HP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L.total);
  if (err != cudaSuccess) return err;
  const long long packed = (long long)L.tile / 2 * 4 * p.heads;
  attn_pack_kernel<<<(int)(packed / 256 < 1024 ? packed / 256 + 1 : 1024), 256, 0, s>>>(
      p.wqkv, p.wproj, p.c, p.heads, L.ck, L.hp, p.wpack);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = (p.bw + p.wpw - 1) / p.wpw;  // warpgroups with windows: rows of `part`
  attn_wg_kernel<NCH, HP><<<(rows + nw - 1) / nw, (nw + 1) * 128, L.total, s>>>(p, nw);
  return cudaGetLastError();
}

// K4 / K9c: checks the widths and alignments, packs the weights and
// launches the persistent window kernel, wpw windows a consumer warpgroup.
int run_attn(AttnWgParams p, void* stream) {
  if (p.bw <= 0 || p.wpw <= 0 || !widths_ok(p.c, p.heads) || p.cio <= 0 || p.cio > p.c ||
      p.cio % 2 != 0 || (p.mask != nullptr && p.nmask <= 0))
    return (int)cudaErrorInvalidValue;
  if (!aligned(p.x, 4) || !aligned(p.dh, 4) || !aligned(p.wqkv, 2) || !aligned(p.wproj, 2) ||
      !aligned(p.bias, 8) || !aligned(p.mask, 8) || !aligned(p.dx, 16) || !aligned(p.xn, 16) ||
      !aligned(p.att, 16) || !aligned(p.dqkv, 16) || !aligned(p.dhs, 16) ||
      !aligned(p.part, 8) || !aligned(p.wpack, 16))
    return (int)cudaErrorMisalignedAddress;
  p.hd = p.c / p.heads;
  p.hp = p.hd <= 16 ? 16 : 32;
  p.dw = p.heads * p.hp;
  const int nw = attn_windows(p.c, p.heads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nch = (p.c + TILE - 1) / TILE;
  if (p.hp == 16) {
    switch (nch) {
      case 1: return (int)launch_attn<1, 16>(p, nw, s);
      case 2: return (int)launch_attn<2, 16>(p, nw, s);
      case 3: return (int)launch_attn<3, 16>(p, nw, s);
      default: return (int)launch_attn<4, 16>(p, nw, s);
    }
  }
  switch (nch) {
    case 1: return (int)launch_attn<1, 32>(p, nw, s);
    case 2: return (int)launch_attn<2, 32>(p, nw, s);
    case 3: return (int)launch_attn<3, 32>(p, nw, s);
    default: return (int)launch_attn<4, 32>(p, nw, s);
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


// C entry points, bound with ctypes. Each returns a cudaError_t: the launch
// is asynchronous on `stream`, so 0 means the kernel was accepted.

// K3's window kernel. h, dout: (bw, 64, c) bf16; ln2 w/b, b1 fp32; w1 (c,
// hidden), w2 (hidden, c) bf16. Writes dh (bw, 64, c), hn (bw*64, c), g and
// du (bw*64, hidden) bf16 and vec (bw, hidden + 3c) fp32.
extern "C" int swin_bwd_mlp_bf16(const void* h, const void* dout, const void* ln2_w,
                                 const void* ln2_b, const void* w1, const void* b1,
                                 const void* w2, void* dh, void* hn, void* g, void* du, void* vec,
                                 void* wpack, int bw, int c, int hidden, void* stream) {
  MlpParams p = mlp_params(h, dout, ln2_w, ln2_b, w1, b1, w2, dh, hn, g, du, vec, c, hidden);
  p.wpack = static_cast<const bf16*>(wpack);
  return run_mlp(p, bw, stream);
}

// K9b's window kernel: K3 at the padded width c with windows h, dout and dh
// of cio columns, the MLP branch scaled by dp (bw,) fp32 (null: 1), and
// dm = bf16(dp * dout) (bw*64, c) written for dW2.
extern "C" int hab_bwd_mlp_bf16(const void* h, const void* dout, const void* dp,
                                const void* ln2_w, const void* ln2_b, const void* w1,
                                const void* b1, const void* w2, void* dh, void* hn, void* g,
                                void* du, void* dm, void* vec, void* wpack, int bw, int c, int cio,
                                int hidden, void* stream) {
  MlpParams p = mlp_params(h, dout, ln2_w, ln2_b, w1, b1, w2, dh, hn, g, du, vec, c, hidden);
  p.wpack = static_cast<const bf16*>(wpack);
  p.cio = cio;
  p.dp = static_cast<const float*>(dp);
  p.dm = static_cast<bf16*>(dm);
  return run_mlp(p, bw, stream);
}

// K4's window kernel and its weight packing. x, dh: (bw, 64, c) bf16; ln1
// w/b, bqkv fp32; wqkv (c, 3c), wproj (c, c) bf16; bias (heads, 64, 64)
// fp32. Writes dx (bw, 64, c) and xn (bw*64, c) bf16; att (bw*64, dw) and
// dqkv (bw*64, 3dw) bf16 with every head padded to hp columns (hp = 16 for
// head_dim <= 16, else 32; dw = heads * hp, zeros in the padding); part
// (ceil(bw / wpw), 3dw + 3c + heads*64*64) fp32, each consumer warpgroup's
// row dbqkv (padded as dqkv) | dbproj | dln1s | dln1b | dbias summed over
// its wpw windows; wpack (swin_bwd_attn_pack_bytes) is scratch.
extern "C" int swin_bwd_attn_bf16(const void* x, const void* dh, const void* ln1_w,
                                  const void* ln1_b, const void* wqkv, const void* bqkv,
                                  const void* bias, const void* wproj, void* dx, void* xn,
                                  void* att, void* dqkv, void* part, void* wpack, int bw, int c,
                                  int heads, int wpw, float scale, void* stream) {
  return run_attn(attn_wg_params(x, dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, dx, xn, att, dqkv,
                                 part, wpack, bw, c, heads, wpw, scale),
                  stream);
}

// K9c's window kernel: K4 at the padded width c (heads of c / heads columns)
// with windows x, dh and dx of cio columns, the (nmask, 64, 64) mask (null:
// none), the attention branch scaled by dp (bw,) fp32 (null: 1), and dhs =
// bf16(dp * dh) (bw*64, c) written for dWproj.
extern "C" int hab_bwd_attn_bf16(const void* x, const void* dh, const void* dp, const void* mask,
                                 const void* ln1_w, const void* ln1_b, const void* wqkv,
                                 const void* bqkv, const void* bias, const void* wproj, void* dx,
                                 void* xn, void* att, void* dqkv, void* dhs, void* part,
                                 void* wpack, int bw, int c, int cio, int heads, int nmask, int wpw,
                                 float scale, void* stream) {
  AttnWgParams p = attn_wg_params(x, dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, dx, xn, att, dqkv,
                                  part, wpack, bw, c, heads, wpw, scale);
  p.cio = cio;
  p.dp = static_cast<const float*>(dp);
  p.mask = static_cast<const float*>(mask);
  p.nmask = nmask;
  p.dhs = static_cast<bf16*>(dhs);
  return run_attn(p, stream);
}

// The attention window kernel's weight packing alone (attn_pack_kernel),
// for the check against its plain version: out (swin_bwd_attn_pack_bytes).
extern "C" int swin_bwd_attn_pack_bf16(const void* wqkv, const void* wproj, int c, int heads,
                                       void* out, void* stream) {
  if (!widths_ok(c, heads)) return (int)cudaErrorInvalidValue;
  const AttnWgLayout L = attn_wg_layout(c, heads, 1);
  attn_pack_kernel<<<64, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(wqkv), static_cast<const bf16*>(wproj), c, heads, L.ck, L.hp,
      static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

// part (splits, m, n) fp32 = per-slice a^T . b, a (t, m) and b (t, n) bf16;
// rows_per_split a multiple of 64, m and n multiples of 4.
extern "C" int swin_wgrad_bf16(const void* a, const void* b, int t, int m, int n,
                               int rows_per_split, int splits, void* part, void* stream) {
  if (t <= 0 || rows_per_split <= 0 || rows_per_split % wg::BK != 0 || splits <= 0 ||
      (long long)(splits - 1) * rows_per_split >= t || m <= 0 || m % 4 != 0 || n <= 0 ||
      n % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned(a, 8) || !aligned(b, 8)) return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)wg::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + wg::BN - 1) / wg::BN, (m + wg::BM - 1) / wg::BM, splits);
  wgrad_kernel<<<grid, wg::THREADS, wg::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), t, m, n, rows_per_split,
      m % 8 == 0 && aligned(a, 16), n % 8 == 0 && aligned(b, 16), static_cast<float*>(part));
  return (int)cudaGetLastError();
}

// out (n,) fp32: the column sums of in (r, n), in a fixed order.
extern "C" int swin_colsum_f32(const void* in, int r, int n, void* out, void* stream) {
  if (r <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  colsum_kernel<<<(n + 31) / 32, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), r, n, nullptr, n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// out (nout,) fp32: out[j] = the column sum of column idx[j] (int32, each in
// 0 .. n-1) of in (r, n), in the same fixed order: the sums and a gather of
// the columns kept, in one launch.
extern "C" int swin_colsum_gather_f32(const void* in, int r, int n, const void* idx, int nout,
                                      void* out, void* stream) {
  if (r <= 0 || n <= 0 || nout <= 0 || idx == nullptr) return (int)cudaErrorInvalidValue;
  colsum_kernel<<<(nout + 31) / 32, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), r, n, static_cast<const int*>(idx), nout,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the two window kernels, for the wrappers' checks.
extern "C" size_t swin_bwd_mlp_smem_bytes(int c, int hidden) {
  return mlp_wg_layout(c, hidden, mlp_windows(c, hidden)).total;
}

extern "C" size_t swin_wgrad_smem_bytes() { return wg::SMEM; }

// Bytes of the packed weights the MLP window kernel streams (the wrappers'
// scratch `wpack`).
extern "C" size_t swin_bwd_mlp_pack_bytes(int c, int hidden) {
  return mlp_wg_layout(c, hidden, 1).tile * 2 * ((hidden + TILE - 1) / TILE);
}

// The attention window kernel: consumer windows a block, dynamic shared
// memory, and bytes of the packed weights it streams (the wrappers' scratch
// `wpack`).
extern "C" int swin_bwd_attn_windows(int c, int heads) { return attn_windows(c, heads); }

extern "C" size_t swin_bwd_attn_smem_bytes(int c, int heads) {
  return attn_wg_layout(c, heads, attn_windows(c, heads)).total;
}

extern "C" size_t swin_bwd_attn_pack_bytes(int c, int heads) {
  return attn_wg_layout(c, heads, 1).tile * 4 * heads;
}
