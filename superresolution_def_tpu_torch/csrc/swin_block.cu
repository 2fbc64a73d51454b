// Fused Swin transformer block (inference, K1, and its training forward,
// K2) for Hopper, bf16 in and out.
//
// K1 replaces the TPU kernel superresolution_def_tpu/kernels/swin_block.py::
// fused_swin_block (kernel body _make_kernel):
//
//   LN1 (fp32 stats) -> QKV (+bqkv, rounded to bf16)
//   -> per head: softmax(q*scale . k^T + bias[h]) . v   (softmax in fp32)
//   -> proj (+bproj) -> h = x + proj                     (residual in fp32)
//   -> LN2 of bf16(h) -> fc1 -> tanh GELU -> fc2 -> out = h + mlp
//
// Rounding points follow _make_kernel: the LN outputs, qkv, q*scale, the
// softmax probabilities, the attention output and the GELU output are
// rounded to bf16; everything else stays fp32.
//
// K2 replaces superresolution_def_tpu/kernels/swin_block.py::
// fused_swin_block_fwd_h (body _make_kernel_fwd_h): K1's function that also
// stores h = x + proj(attn), rounded to bf16, for the backward (K3 and K4
// in swin_block_train.cu). The TPU kernel feeds LN2 the fp32 h and stores h
// in bf16; here LN2 reads the bf16 h, as K1 does, so the stored h is
// exactly what LN2 saw and K3's recomputation of LN2 from it matches the
// forward.
//
// Both are instantiations of one wgmma kernel (swin_fwd_wg.cuh says how):
// persistent blocks of two windows sharing one TMA-fed mbarrier ring of the
// weight tiles that K3's and K4's packings lay out (swin_pack.cuh),
// swin_fwd_wg_kernel<NCH, HP, STORE_H> with STORE_H false for K1 and true
// for K2. K2 packs the weights on every call. K1 takes them packed
// (swin_block_pack_bf16): the inference forward packs each block's frozen
// weights once, about 0.9 MB a block at the flagship widths.
//
// What bounds them: the block does 823,680 FLOP per token, about 0.52
// TFLOP for one 128x128 patch (36 blocks x 16,384 tokens), against 989
// TFLOP/s bf16 on an H100, while its device-memory traffic is only the
// window in and out (the weights stay resident in the 50 MB L2): compute-
// bound at the flagship widths. K2's bound is K1's plus one more (Bw, 64,
// C) bf16 store.

#include "swin_fwd_wg.cuh"

namespace {

FwdWgParams fwd_params(const void* x, const void* ln1_w, const void* ln1_b, const void* bqkv,
                       const void* bias, const void* bproj, const void* ln2_w,
                       const void* ln2_b, const void* b1, const void* b2, void* out, int bw,
                       int c, int heads, int hidden, float scale) {
  FwdWgParams p = {};
  p.x = static_cast<const bf16*>(x);
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
  p.c = p.cio = c;
  p.heads = heads;
  p.hidden = hidden;
  p.bw = bw;
  p.scale = scale;
  return p;
}

void set_packed(FwdWgParams& p, const void* wpack) {
  size_t attn = 0;
  fwd_pack_elems(p.c, p.heads, p.hidden, &attn);
  p.wattn = static_cast<const bf16*>(wpack);
  p.wmlp = p.wattn + attn;
}

}  // namespace

// C entry points, bound with ctypes. Each returns a cudaError_t: a launch
// is asynchronous on `stream`, so 0 means the kernel was accepted, not
// finished. Weights are (in, out) row-major bf16; LN parameters, biases and
// the (heads, 64, 64) relative-position bias are fp32.

// The weights wqkv, wproj, w1, w2 packed for K1 and K2 into wpack
// (swin_block_pack_elems bf16, 16-byte aligned): two launches.
extern "C" int swin_block_pack_bf16(const void* wqkv, const void* wproj, const void* w1,
                                    const void* w2, int c, int heads, int hidden, void* wpack,
                                    void* stream) {
  return pack_fwd_wg(static_cast<const bf16*>(wqkv), static_cast<const bf16*>(wproj),
                     static_cast<const bf16*>(w1), static_cast<const bf16*>(w2), c, heads,
                     hidden, static_cast<bf16*>(wpack), static_cast<cudaStream_t>(stream));
}

// K1 on weights packed by swin_block_pack_bf16. `windows`: windows a block
// (1 or 2; 0: as many as fit).
extern "C" int swin_block_bf16(const void* x, const void* ln1_w, const void* ln1_b,
                               const void* bqkv, const void* bias, const void* bproj,
                               const void* ln2_w, const void* ln2_b, const void* b1,
                               const void* b2, const void* wpack, void* out, int bw, int c,
                               int heads, int hidden, float scale, int windows, void* stream) {
  FwdWgParams p = fwd_params(x, ln1_w, ln1_b, bqkv, bias, bproj, ln2_w, ln2_b, b1, b2, out, bw,
                             c, heads, hidden, scale);
  set_packed(p, wpack);
  return run_fwd_wg<false, false>(p, windows, stream);
}

// K2: K1's function, and also h = x + proj(attn) in bf16 to h_out (same
// shape as out). wpack is scratch of swin_block_pack_elems bf16, 16-byte
// aligned: the weights packed into it on every call.
extern "C" int swin_block_fwd_h_bf16(const void* x, const void* ln1_w, const void* ln1_b,
                                     const void* wqkv, const void* bqkv, const void* bias,
                                     const void* wproj, const void* bproj, const void* ln2_w,
                                     const void* ln2_b, const void* w1, const void* b1,
                                     const void* w2, const void* b2, void* out, void* h_out,
                                     void* wpack, int bw, int c, int heads, int hidden,
                                     float scale, void* stream) {
  FwdWgParams p = fwd_params(x, ln1_w, ln1_b, bqkv, bias, bproj, ln2_w, ln2_b, b1, b2, out, bw,
                             c, heads, hidden, scale);
  p.h_out = static_cast<bf16*>(h_out);
  const int err = swin_block_pack_bf16(wqkv, wproj, w1, w2, c, heads, hidden, wpack, stream);
  if (err != 0) return err;
  set_packed(p, wpack);
  return run_fwd_wg<true, false>(p, 0, stream);
}

// The packed weights (bf16 elements), and each kernel's dynamic shared
// memory with its windows a block, for the wrappers' scratch and shape
// checks.
extern "C" size_t swin_block_pack_elems(int c, int heads, int hidden) {
  size_t attn = 0;
  return fwd_pack_elems(c, heads, hidden, &attn);
}

extern "C" size_t swin_block_smem_bytes(int c, int heads, int hidden) {
  return fwd_wg_layout(c, c, heads, hidden, fwd_windows(c, c, heads, hidden, false), false)
      .total;
}

extern "C" int swin_block_windows(int c, int heads, int hidden) {
  return fwd_windows(c, c, heads, hidden, false);
}
