// K4b: the fused Swin block's whole backward from x and dout alone, the
// forward recomputed, for Hopper; bf16 activations and weights, fp32 sums.
//
// Replaces superresolution_def_tpu/kernels/swin_block.py::
// fused_swin_block_bwd (body _make_bwd_kernel), so the training forward
// (K1) need not keep h. Its rounding points are the TPU kernel's, which
// differ from K2 + K3 + K4 in three places:
//   1. h stays fp32: LN2's statistics and x-hat come from the fp32 h (K3
//      reads K2's bf16 h);
//   2. dh = LN2^T(dhn) + dout stays fp32 into dbproj and into dx's
//      residual; only do's and dWproj's operands are bf16(dh) (K3 rounds dh
//      to bf16 for K4);
//   3. the attention half works on xn recomputed from x.
//
// Design: three phases on the port's wgmma window kernels, launched one
// after another on the caller's stream. Each runs two windows a block (two
// consumer warpgroups and a producer warpgroup that gives its registers to
// the consumers by setmaxnreg, 40/232) and streams its weight tiles by TMA
// through an mbarrier ring; every product runs on wgmma but the per-head
// 64 x 64 products of phase 3, which run on mma.sync as K4's do.
//   1. The recompute to h: K1/K2's body (swin_fwd_wg.cuh) in its H32 mode,
//      swin_fwd_h32_wg_kernel: LN1, qkv, the attention (one reciprocal a
//      softmax row), proj, and h = x + (proj + bproj) written in fp32 to
//      h32. No LN2 and no MLP: phase 2 recomputes them, so phase 1 does 20
//      of the forward's 53 MFLOP a window at the flagship widths.
//   2. The MLP phase: K3's body (swin_bwd_wg.cuh) in its F32 mode,
//      mlp_bwd_f32_kernel: LN2 of the fp32 h, the hidden loop, LN2's
//      backward; dh in fp32 (dh32) and in bf16 (dhb), dbproj as the fp32
//      dh's column sums in its window's row of vec.
//   3. The attention phase: K4's body in its F32 mode, attn_wg_f32_kernel:
//      LN1, qkv and each head's softmax recomputed from x, do from bf16(dh),
//      the attention's backward, LN1's backward, dx = LN1^T(dxn) + the fp32
//      dh.
// The attention's weight tiles are packed once (attn_pack_kernel) for
// phases 1 and 3, the MLP's (mlp_pack_kernel) for phase 2. The weight
// gradients then take K3/K4's steps 2 and 3 (wgrad_kernel, colsum_kernel in
// swin_block_train.cu): a fixed summation order and no atomics, so two runs
// give the same bits.
//
// Three launches, not one persistent kernel: the three bodies share the
// thread layout and the register split, but each carves its own 161-227 KB
// of shared memory, and h and dh would still pass through device memory
// between the phases (94 MB each in fp32 at Bw = 2048, more than the 50 MB
// L2). What a fused kernel would save is two launch gaps and two tails,
// a few microseconds each against a call of milliseconds.
//
// Device memory: h32 and dh32 (Bw * 64 * C fp32 each), dhb, hn, g and du
// of the MLP phase; xn, att, dqkv and the per-warpgroup partial sums of the
// attention phase (the K4 sizes); no per-window bias-gradient rows.
//
// What bounds it: its function needs 141.5 MFLOP a window at the flagship
// widths (C = 180, 6 heads, hidden 720: qkv, proj and the attention's two
// products forward, fc1 forward, and the backward's 14 products), 0.293 ms
// at Bw = 2048 at the bf16 peak. This design does 19.5 MFLOP more (phase 3
// recomputes qkv and the softmax, as K4 does) and moves the fp32 h and dh
// and K3's and K4's intermediates through device memory.

#include "swin_bwd_wg.cuh"
#include "swin_fwd_wg.cuh"

namespace {

// K4b's shared memory: the largest of its three phases'.
size_t block_bwd_smem(int c, int heads, int hidden) {
  const size_t f =
      fwd_wg_layout(c, c, heads, hidden, fwd_windows(c, c, heads, hidden, false), false).total;
  const size_t m = mlp_wg_layout(c, hidden, mlp_windows(c, hidden)).total;
  const size_t a = attn_wg_layout(c, heads, attn_windows(c, heads)).total;
  return f > m ? (f > a ? f : a) : (m > a ? m : a);
}

}  // namespace

// K4b's three phases and their weight packings, on `stream`. x, dout: (bw,
// 64, c) bf16; ln1 w/b, bqkv, bproj, ln2 w/b, b1 fp32; wqkv (c, 3c), wproj
// (c, c), w1 (c, hidden), w2 (hidden, c) bf16; bias (heads, 64, 64) fp32.
// Writes dx (bw, 64, c) bf16; phase 3's xn, att, dqkv and part as
// swin_bwd_attn_bf16 writes them (dbproj's columns of part left unwritten),
// wpw windows a consumer warpgroup; phase 2's dhb = bf16(dh), hn (bw*64, c),
// g and du (bw*64, hidden) bf16 and vec (bw, hidden + 4c) fp32 (db1 | db2 |
// dln2s | dln2b | dbproj of each window); h32 and dh32 (bw, 64, c) fp32 are
// scratch, wattn (swin_bwd_attn_pack_bytes) and wmlp
// (swin_bwd_mlp_pack_bytes) the packed weights.
extern "C" int swin_bwd_block_bf16(const void* x, const void* dout, const void* ln1_w,
                                   const void* ln1_b, const void* wqkv, const void* bqkv,
                                   const void* bias, const void* wproj, const void* bproj,
                                   const void* ln2_w, const void* ln2_b, const void* w1,
                                   const void* b1, const void* w2, void* dx, void* xn, void* att,
                                   void* dqkv, void* part, void* wattn, void* h32, void* dh32,
                                   void* dhb, void* hn, void* g, void* du, void* vec, void* wmlp,
                                   int bw, int c, int heads, int hidden, int wpw, float scale,
                                   void* stream) {
  if (bw <= 0 || wpw <= 0 || !widths_ok(c, heads) || !fwd_widths_ok(c, heads, hidden))
    return (int)cudaErrorInvalidValue;
  if (!aligned(x, 16) || !aligned(dout, 4) || !aligned(wqkv, 2) || !aligned(wproj, 2) ||
      !aligned(w1, 2) || !aligned(w2, 2) || !aligned(bias, 8) || !aligned(dx, 16) ||
      !aligned(xn, 16) || !aligned(att, 16) || !aligned(dqkv, 16) || !aligned(part, 8) ||
      !aligned(wattn, 16) || !aligned(h32, 8) || !aligned(dh32, 8) || !aligned(dhb, 4) ||
      !aligned(hn, 4) || !aligned(g, 4) || !aligned(du, 4) || !aligned(wmlp, 16))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  // the attention's tiles, packed once for phases 1 and 3
  const AttnWgLayout La = attn_wg_layout(c, heads, 1);
  const long long packed = (long long)La.tile / 2 * 4 * heads;
  attn_pack_kernel<<<(int)(packed / 256 < 1024 ? packed / 256 + 1 : 1024), 256, 0, s>>>(
      static_cast<const bf16*>(wqkv), static_cast<const bf16*>(wproj), c, heads, La.ck, La.hp,
      static_cast<bf16*>(wattn));
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  // 1. the recompute to the fp32 h
  FwdWgParams f = {};
  f.x = static_cast<const bf16*>(x);
  f.ln1_w = static_cast<const float*>(ln1_w);
  f.ln1_b = static_cast<const float*>(ln1_b);
  f.bqkv = static_cast<const float*>(bqkv);
  f.bias = static_cast<const float*>(bias);
  f.bproj = static_cast<const float*>(bproj);
  f.wattn = static_cast<const bf16*>(wattn);
  f.c = f.cio = c;
  f.heads = heads;
  f.hidden = hidden;
  f.bw = bw;
  f.scale = scale;
  FwdWgExtra e = {};
  e.h32 = static_cast<float*>(h32);
  err = run_fwd_wg<false, false, true>(f, 0, stream, e);
  if (err != 0) return err;

  // 2. the MLP phase on the fp32 h
  MlpParams m = mlp_params(nullptr, dout, ln2_w, ln2_b, w1, b1, w2, dhb, hn, g, du, vec, c,
                           hidden);
  m.wpack = static_cast<const bf16*>(wmlp);
  err = run_mlp<true>(m, bw, stream, static_cast<const float*>(h32), static_cast<float*>(dh32));
  if (err != 0) return err;

  // 3. the attention phase on x, bf16(dh) and the fp32 dh
  return run_attn<true>(attn_wg_params(x, dhb, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, dx, xn,
                                       att, dqkv, part, wattn, bw, c, heads, wpw, scale),
                        stream, static_cast<const float*>(dh32));
}

// K4b's dynamic shared memory at its widths: the largest of its phases'.
extern "C" size_t swin_bwd_block_smem_bytes(int c, int heads, int hidden) {
  return block_bwd_smem(c, heads, hidden);
}
