// K5: HAT's hybrid attention block (HAB, inference) for Hopper, bf16 in and
// out, and K9a, the same block for training.
//
// K5 replaces the TPU kernel superresolution_def_tpu/kernels/swin_block.py::
// fused_hab_block (kernel body _make_hab_kernel): K1's block with two more
// operands:
//
//   - an additive (nW, 64, 64) fp32 mask added to every head's scores with
//     the relative-position bias; window w of the batch uses mask[w mod nW]
//     (the JAX package tiles the same mask over the batch). Unshifted blocks
//     pass no mask, and the kernel reads none;
//   - conv_x, HAT's channel-attention conv branch in window layout, added to
//     the residual as h = x + proj(attn) + conv_scale * conv_x in fp32 before
//     LN2 (the wrapper gathers it with x's roll and window permutation).
//
// It is the HAB instantiation of K1's and K2's wgmma kernel,
// hab_fwd_wg_kernel<NCH, HP> (swin_fwd_wg.cuh says how): persistent blocks
// of two windows, the weight tiles streamed by TMA through an mbarrier ring,
// every product on wgmma. HAT's widths (C = 90, six heads of 15) are padded
// by the wrapper: each head to 16 columns and the weights' channel rows to
// c = 96, while the windows keep their 90 columns in device memory (cio =
// 90) and LayerNorm keeps its statistics over those 90. The weights come
// packed (hab_block_pack_bf16): the inference forward packs each block's
// once. Rounding points are K1's: q scaled and rounded before QK^T, the
// probabilities, attention output, LN outputs and the GELU (tanh) output
// rounded to bf16, LN2 reading h rounded to bf16.
//
// What bounds it: 13.9 MFLOP per window against 989 TFLOP/s bf16, while its
// device-memory traffic is x, conv_x and out (3 x 11.5 KB per window) plus a
// mask slice when shifted: operation-bound at the tensor cores' peak. The
// padding to 96 adds 7% to every product, and the 64-column chunks of the
// packing (128 for 96) a third more to qkv's and fc1's K and to proj's and
// fc2's N.
//
// K9a replaces superresolution_def_tpu/kernels/hab_train.py::_hab_fwd_h
// (kernel body _make_hab_fwd_h_kernel): K5's function with K2's store of h
// for the backward, and per-sample drop-path on both branches, h = x + dp1
// * (proj + bproj) + conv_scale * conv_x and out = h + dp2 * (mlp + b2). The
// JAX kernel takes dp1, dp2 as (Bw, 1, C) windows of one value each; here
// they are that value, one fp32 per window. It is the third instantiation
// of the same body, hab_fwd_h_wg_kernel<NCH, HP>: h leaves as bf16(h), the
// value LN2 reads and K9b reads back, in one dense window of 16-byte runs at
// cio columns, as out does;
// the MLP accumulates into h's registers, so a window whose dp2 is neither
// 0 nor 1 divides h by dp2 before it and multiplies the sum after, and a
// window with dp2 = 0 skips the MLP's products. Its weights are live: the
// wrapper packs them on every call (hab_block_pack_bf16's two launches into
// the scratch wpack), as K2 does. Its bound is K5's plus the h store (11.5
// KB more per window) and the scales: operation-bound at the tensor cores'
// peak.

#include "swin_fwd_wg.cuh"

using namespace swin;

namespace {

FwdWgParams hab_params(const void* x, const void* convx, const void* mask, const void* ln1_w,
                       const void* ln1_b, const void* bqkv, const void* bias, const void* bproj,
                       const void* ln2_w, const void* ln2_b, const void* b1, const void* b2,
                       const void* wpack, void* out, int bw, int c, int cio, int heads,
                       int hidden, int nw, float scale, float conv_scale) {
  FwdWgParams p = {};
  p.x = static_cast<const bf16*>(x);
  p.convx = static_cast<const bf16*>(convx);
  p.mask = static_cast<const float*>(mask);
  p.ln1_w = static_cast<const float*>(ln1_w);
  p.ln1_b = static_cast<const float*>(ln1_b);
  p.bqkv = static_cast<const float*>(bqkv);
  p.bias = static_cast<const float*>(bias);
  p.bproj = static_cast<const float*>(bproj);
  p.ln2_w = static_cast<const float*>(ln2_w);
  p.ln2_b = static_cast<const float*>(ln2_b);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<bf16*>(out);
  p.c = c;
  p.cio = cio;
  p.heads = heads;
  p.hidden = hidden;
  p.bw = bw;
  p.nmask = nw;
  p.scale = scale;
  p.conv_scale = conv_scale;
  size_t attn = 0;
  fwd_pack_elems(c, heads, hidden, &attn);
  p.wattn = static_cast<const bf16*>(wpack);
  p.wmlp = p.wattn + attn;
  return p;
}

}  // namespace

// C entry points, bound with ctypes; each returns a cudaError_t. x, conv_x
// and out (and K9a's h) are (bw, 64, cio) bf16; the weights (in, out) bf16 at
// the padded width c; LN parameters, biases, the (heads, 64, 64) bias and the
// (nw, 64, 64) mask fp32 (mask may be null).

// K5's weights (wqkv, wproj, w1, w2 at the padded width c) packed into
// wpack (hab_block_pack_elems bf16, 16-byte aligned): two launches.
extern "C" int hab_block_pack_bf16(const void* wqkv, const void* wproj, const void* w1,
                                   const void* w2, int c, int heads, int hidden, void* wpack,
                                   void* stream) {
  return pack_fwd_wg(static_cast<const bf16*>(wqkv), static_cast<const bf16*>(wproj),
                     static_cast<const bf16*>(w1), static_cast<const bf16*>(w2), c, heads,
                     hidden, static_cast<bf16*>(wpack), static_cast<cudaStream_t>(stream));
}

// K5 on weights packed by hab_block_pack_bf16.
extern "C" int hab_block_bf16(const void* x, const void* convx, const void* mask,
                              const void* ln1_w, const void* ln1_b, const void* bqkv,
                              const void* bias, const void* bproj, const void* ln2_w,
                              const void* ln2_b, const void* b1, const void* b2,
                              const void* wpack, void* out, int bw, int c, int cio, int heads,
                              int hidden, int nw, float scale, float conv_scale, void* stream) {
  return run_fwd_wg<false, true>(hab_params(x, convx, mask, ln1_w, ln1_b, bqkv, bias, bproj,
                                            ln2_w, ln2_b, b1, b2, wpack, out, bw, c, cio, heads,
                                            hidden, nw, scale, conv_scale),
                                 0, stream);
}

extern "C" size_t hab_block_pack_elems(int c, int heads, int hidden) {
  size_t attn = 0;
  return fwd_pack_elems(c, heads, hidden, &attn);
}

// K5's dynamic shared memory at padded width c, with its windows a block.
extern "C" size_t hab_block_smem_bytes(int c, int cio, int heads, int hidden) {
  return fwd_wg_layout(c, cio, heads, hidden, fwd_windows(c, cio, heads, hidden, true), true)
      .total;
}

extern "C" int hab_block_windows(int c, int cio, int heads, int hidden) {
  return fwd_windows(c, cio, heads, hidden, true);
}

// K9a: as hab_block_bf16, plus h (bw, 64, cio) bf16 and the per-window
// branch scales dp1, dp2 (bw,) fp32 (either may be null: all one), on the
// weights wqkv, wproj, w1, w2 (at the padded width c), which it packs into
// the scratch wpack (hab_block_pack_elems bf16, 16-byte aligned) first.
extern "C" int hab_block_fwd_h_bf16(const void* x, const void* convx, const void* mask,
                                    const void* dp1, const void* dp2, const void* ln1_w,
                                    const void* ln1_b, const void* wqkv, const void* bqkv,
                                    const void* bias, const void* wproj, const void* bproj,
                                    const void* ln2_w, const void* ln2_b, const void* w1,
                                    const void* b1, const void* w2, const void* b2, void* out,
                                    void* h, void* wpack, int bw, int c, int cio, int heads,
                                    int hidden, int nw, float scale, float conv_scale,
                                    void* stream) {
  const int err = hab_block_pack_bf16(wqkv, wproj, w1, w2, c, heads, hidden, wpack, stream);
  if (err != 0) return err;
  FwdWgParams p = hab_params(x, convx, mask, ln1_w, ln1_b, bqkv, bias, bproj, ln2_w, ln2_b, b1,
                             b2, wpack, out, bw, c, cio, heads, hidden, nw, scale, conv_scale);
  p.h_out = static_cast<bf16*>(h);
  FwdWgExtra e = {};
  e.dp1 = static_cast<const float*>(dp1);
  e.dp2 = static_cast<const float*>(dp2);
  return run_fwd_wg<true, true>(p, 0, stream, e);
}
