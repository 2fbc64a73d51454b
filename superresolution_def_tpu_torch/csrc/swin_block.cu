// Fused Swin transformer block (inference) for Hopper, bf16 in and out.
//
// Replaces the TPU kernel superresolution_def_tpu/kernels/swin_block.py::
// fused_swin_block (kernel body _make_kernel). One thread block computes one
// pre-rolled, pre-partitioned 8x8 window (N = 64 tokens) end to end:
//
//   LN1 (fp32 stats) -> QKV (+bqkv, rounded to bf16)
//   -> per head: softmax(q*scale . k^T + bias[h]) . v   (softmax in fp32)
//   -> proj (+bproj) -> h = x + proj                     (residual in fp32)
//   -> LN2 of bf16(h) -> fc1 -> tanh GELU -> fc2 -> out = h + mlp
//
// Every matrix product runs on the tensor cores (mma.sync m16n8k16 bf16 with
// fp32 accumulators, operands through ldmatrix). Rounding points follow
// _make_kernel exactly: the LN outputs, qkv, q*scale, the softmax
// probabilities, the attention output and the GELU output are rounded to
// bf16; everything else stays fp32.
//
// The kernel itself lives in swin_block_kernel.cuh, shared with K5 (HAT's
// HAB block, hab_block.cu).
//
// What bounds it: the block does 823,680 FLOP per token, about 0.52 TFLOP for
// one 128x128 patch (36 blocks x 16,384 tokens), against 989 TFLOP/s bf16 on
// an H100, while its device-memory traffic is only the window in and out
// (the ~0.8 MB of weights stay resident in the 50 MB L2). So it is
// compute-bound once it is fast. This design is not there yet: every window
// streams all the weights from L2 through shared memory in 64 x 64 tiles
// (cp.async, one barrier per tile), and the latency of each tile's copies,
// products and epilogue, not the tensor cores, sets its speed (PERF.md has
// the phase breakdown). To hide it with more warps, a block keeps under
// ~110 KB of shared memory so that two fit on an SM: the fp32 residual h
// lives in the accumulator registers (proj and fc2 accumulate into it, LN2
// reads it there), q/k/v are produced two heads at a time and consumed at
// once by register-resident attention (scores, softmax and probabilities
// never touch shared memory), and the MLP streams its hidden dimension in
// 64-wide chunks.
//
// What this simple design gives up, for later work:
//   - mma.sync, not wgmma: at most about half the tensor-core rate; no TMA;
//   - one window per block, so every window re-reads the weights from L2;
//   - C = 180 is padded to 192 and head_dim 30 to 32 with zeros (6% and 7%
//     wasted tensor-core work).
//
// K2, the training forward, is the same kernel compiled with STORE_H: it also
// stores h = x + proj(attn), rounded to bf16, for the backward (K3 and K4 in
// swin_block_train.cu). It replaces superresolution_def_tpu/kernels/
// swin_block.py::fused_swin_block_fwd_h (body _make_kernel_fwd_h). The one
// store changes no arithmetic, so K2's `out` is bit-identical to K1's. The
// TPU kernel feeds LN2 the fp32 h and stores h in bf16; here LN2 reads the
// bf16 h, as K1 does, so the stored h is exactly what LN2 saw and K3's
// recomputation of LN2 from it matches the forward. Its bound is K1's plus
// one more (Bw, 64, C) bf16 store: compute-bound at the flagship widths.

#include "swin_block_kernel.cuh"

namespace {

using namespace swin;

Params block_params(const void* x, const void* ln1_w, const void* ln1_b, const void* wqkv,
                    const void* bqkv, const void* bias, const void* wproj, const void* bproj,
                    const void* ln2_w, const void* ln2_b, const void* w1, const void* b1,
                    const void* w2, const void* b2, void* out, void* h_out, int c, int heads,
                    int hidden, float scale) {
  Params p = {};
  p.x = static_cast<const bf16*>(x);
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
  p.h_out = static_cast<bf16*>(h_out);
  p.c = c;
  p.cio = c;
  p.heads = heads;
  p.hidden = hidden;
  p.scale = scale;
  return p;
}

}  // namespace

// C entry point, bound with ctypes. Returns a cudaError_t: the launch is
// asynchronous on `stream`, so 0 means the kernel was accepted, not finished.
// Weights are (in, out) row-major bf16; LN parameters, biases and the
// (heads, 64, 64) relative-position bias are fp32.
extern "C" int swin_block_bf16(const void* x, const void* ln1_w, const void* ln1_b,
                               const void* wqkv, const void* bqkv, const void* bias,
                               const void* wproj, const void* bproj, const void* ln2_w,
                               const void* ln2_b, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, int bw, int c, int heads, int hidden,
                               float scale, void* stream) {
  return run_block<false, false>(block_params(x, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj,
                                              ln2_w, ln2_b, w1, b1, w2, b2, out, nullptr, c,
                                              heads, hidden, scale),
                                 bw, stream);
}

// K2: as swin_block_bf16, and also h = x + proj(attn) in bf16 to h_out
// (same shape as out).
extern "C" int swin_block_fwd_h_bf16(const void* x, const void* ln1_w, const void* ln1_b,
                                     const void* wqkv, const void* bqkv, const void* bias,
                                     const void* wproj, const void* bproj, const void* ln2_w,
                                     const void* ln2_b, const void* w1, const void* b1,
                                     const void* w2, const void* b2, void* out, void* h_out,
                                     int bw, int c, int heads, int hidden, float scale,
                                     void* stream) {
  return run_block<true, false>(block_params(x, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj,
                                             ln2_w, ln2_b, w1, b1, w2, b2, out, h_out, c, heads,
                                             hidden, scale),
                                bw, stream);
}

// Dynamic shared memory one block needs, for the wrapper's shape check.
extern "C" size_t swin_block_smem_bytes(int c, int heads, int hidden) {
  (void)heads;
  return make_layout(c, round16(c), round16(hidden)).total;
}
