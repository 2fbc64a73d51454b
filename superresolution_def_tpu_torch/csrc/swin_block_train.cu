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
//     reading mask[w mod nW] as K5 and K9a do.
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
// leave in 16-byte runs through shared memory. The header of attn_wg_body
// says how a window runs; K4 and K9c divide once per softmax row and
// multiply (a masked key's exp is denormal, and dividing each takes the
// division's slow path).
//
// The two window kernels live in swin_bwd_wg.cuh, which K4b
// (swin_block_bwd.cu) shares for its MLP and attention phases; K4b takes
// steps 2 and 3 from here.

#include "swin_bwd_wg.cuh"

namespace {

using namespace swin;

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
  return run_mlp<false>(p, bw, stream);
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
  return run_mlp<false>(p, bw, stream);
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
  return run_attn<false>(attn_wg_params(x, dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, dx, xn,
                                        att, dqkv, part, wpack, bw, c, heads, wpw, scale),
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
  return run_attn<false>(p, stream);
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
