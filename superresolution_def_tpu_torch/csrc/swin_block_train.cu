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
//   1. a window kernel computes everything that is per token: dh (K3) or
//      dx (K4), and writes the bf16 operands of the weight-gradient
//      products (K3: LN2 output hn, GELU output g, du; K4: LN1 output xn,
//      attention output, dq|dk|dv) plus one fp32 row per window of its
//      bias and LayerNorm gradients (K4 also the window's (heads, 64, 64)
//      bias-table gradient);
//   2. wgrad_kernel: dW = A^T . B over all Bw*64 tokens, bf16 operands and
//      fp32 sums, each thread block summing one 192 x 192 tile over one
//      contiguous slice of tokens into its own partial;
//   3. colsum_kernel: sums the partials, and the per-window rows, in a
//      fixed order, one launch each.
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
// them back).
//
// K3's window kernel (mlp_bwd_kernel) runs the MLP's products on wgmma, two
// windows a block, one consumer warpgroup per window, so each weight tile
// that lands in shared memory serves 128 token rows; the weights, packed
// once per call into the layout the products read (mlp_pack_kernel), come
// in by TMA bulk copies into a 4-tile ring under mbarriers, with no
// block-wide barrier per tile; du stays in registers as the A operand of
// dhn's product. K4's window kernel (attn_bwd_kernel) is the first design:
// one 8x8 window per block on mma.sync behind a 2-deep cp.async ring.
//
// The window kernels' phases live in swin_bwd_phases.cuh, shared with K4b
// (swin_block_bwd.cu), which also uses steps 2 and 3 from here.

#include "hopper.cuh"
#include "swin_bwd_phases.cuh"

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

// byte offset of (row r, column k) in a 64-row operand of ck columns stored
// K-major interleaved: 8 x 8 core matrices, K-adjacent ones 128 bytes apart
__device__ __forceinline__ int kmaj(int r, int k, int ck) {
  return (r >> 3) * ck * 16 + (k >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2;
}

// The packed weights: per 64-wide hidden chunk j, two tiles of ck x 64 bf16,
// w1[:, j] then w2[j, :]^T, element (c, jj) at byte (c/8) 1024 + (jj/8) 128 +
// (c%8) 16 + (jj%8) 2 (zero past C and hidden). One tile serves u = hn . w1
// as its MN-major B and dhn = du . w1^T as its K-major B.
__global__ void mlp_pack_kernel(const bf16* w1, const bf16* w2, int C, int hidden, int ck,
                                bf16* out) {
  const long long per = 2LL * ck * 64, total = per * ((hidden + 63) / 64);
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(idx / per), rem = (int)(idx - j * per), which = rem / (ck * 64);
    const int e = rem - which * ck * 64, r = e & 511;
    const int c = (e >> 9) * 8 + ((r & 63) >> 3), hcol = j * 64 + (r >> 6) * 8 + (r & 7);
    bf16 v = __float2bfloat16(0.f);
    if (c < C && hcol < hidden) v = which == 0 ? w1[(size_t)c * hidden + hcol] : w2[(size_t)hcol * C + c];
    out[idx] = v;
  }
}

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

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

// out[n] = the sum of in[r][n] over all R rows in a fixed order: eight row
// groups (r = g, g + 8, ..) in ascending r, then the eight groups in order.
// Grid ceil(N / 32), 256 threads.
__global__ void __launch_bounds__(THREADS) colsum_kernel(const float* in, int R, int Nn,
                                                         float* out) {
  __shared__ float part[8][33];
  const int lx = threadIdx.x & 31, ly = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lx;
  float s = 0.f;
  if (n < Nn)
    for (int r = ly; r < R; r += 8) s += in[(size_t)r * Nn + n];
  part[ly][lx] = s;
  __syncthreads();
  if (ly == 0 && n < Nn) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < 8; ++g) t += part[g][lx];
    out[n] = t;
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
      static_cast<const float*>(in), r, n, static_cast<float*>(out));
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

extern "C" size_t swin_bwd_attn_smem_bytes(int c) { return attn_layout(c, round16(c)).total; }
