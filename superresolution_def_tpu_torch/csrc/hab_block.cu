// K5: HAT's hybrid attention block (HAB, inference) for Hopper, bf16 in and out.
//
// Replaces the TPU kernel superresolution_def_tpu/kernels/swin_block.py::
// fused_hab_block (kernel body _make_hab_kernel). It is K1's kernel
// (swin_block_kernel.cuh) compiled with two more operands:
//
//   - an additive (nW, 64, 64) fp32 mask added to every head's scores after
//     the relative-position bias; window w of the batch uses mask[w mod nW]
//     (the JAX package tiles the same mask over the batch). Unshifted blocks
//     pass no mask, and the kernel reads none;
//   - conv_x, HAT's channel-attention conv branch in window layout, added to
//     the residual as h = x + proj(attn) + conv_scale * conv_x in fp32 before
//     LN2 (the wrapper gathers it with x's roll and window permutation).
//
// HAT's widths (C = 90, six heads of 15) are not K1's: a 15-wide head cannot
// be copied in 4-element vectors and a 90-wide row is only 4-byte aligned.
// The wrapper zero-pads each head to 16 columns and the weights' channel rows
// to 96, so the kernel runs with c = 96 inside while the windows keep their
// 90 columns in device memory (cio = 90) and LayerNorm keeps its statistics
// over those 90. Rounding points are K1's: q scaled and rounded before QK^T,
// the probabilities, attention output, LN outputs and the GELU (tanh) output
// rounded to bf16, LN2 reading h rounded to bf16.
//
// What bounds it: 13.9 MFLOP per window against 989 TFLOP/s bf16, while its
// device-memory traffic is x, conv_x and out (3 x 11.5 KB per window) plus a
// mask slice when shifted: operation-bound at the tensor cores' peak, and
// like K1 latency-bound in this simple design (every window streams the
// weights through shared memory in 64 x 64 tiles; the padding to 96 adds 7%
// to every product).

#include "swin_block_kernel.cuh"

using namespace swin;

// C entry point, bound with ctypes; returns a cudaError_t. x, conv_x and out
// are (bw, 64, cio) bf16; the weights (in, out) bf16 at the padded width c;
// LN parameters, biases, the (heads, 64, 64) bias and the (nw, 64, 64) mask
// fp32 (mask may be null).
extern "C" int hab_block_bf16(const void* x, const void* convx, const void* mask, const void* ln1_w,
                              const void* ln1_b, const void* wqkv, const void* bqkv,
                              const void* bias, const void* wproj, const void* bproj,
                              const void* ln2_w, const void* ln2_b, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* out, int bw, int c, int cio,
                              int heads, int hidden, int nw, float scale, float conv_scale,
                              void* stream) {
  Params p = {};
  p.x = static_cast<const bf16*>(x);
  p.convx = static_cast<const bf16*>(convx);
  p.mask = static_cast<const float*>(mask);
  p.ln1_w = static_cast<const float*>(ln1_w);
  p.ln1_b = static_cast<const float*>(ln1_b);
  p.wqkv = static_cast<const bf16*>(wqkv);
  p.bqkv = static_cast<const float*>(bqkv);
  p.bias = static_cast<const float*>(bias);
  p.wproj = static_cast<const bf16*>(wproj);
  p.bproj = static_cast<const float*>(bproj);
  p.ln2_w = static_cast<const float*>(ln2_w);
  p.ln2_b = static_cast<const float*>(ln2_b);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<bf16*>(out);
  p.c = c;
  p.cio = cio;
  p.heads = heads;
  p.hidden = hidden;
  p.nw = nw;
  p.scale = scale;
  p.conv_scale = conv_scale;
  return run_block<false, true>(p, bw, stream);
}

// Dynamic shared memory one block needs at padded width c.
extern "C" size_t hab_block_smem_bytes(int c, int hidden) {
  return make_layout(c, round16(c), round16(hidden)).total;
}
