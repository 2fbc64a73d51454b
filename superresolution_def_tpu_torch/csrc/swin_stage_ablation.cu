// K13: the fused Swin block with swappable stages, for attributing the
// time of the block's first design to its stages on Hopper. bf16 in and
// out.
//
// Replaces the TPU kernel scripts/swin_stage_ablation.py::block (kernel body
// _make_kernel(mode)), the JAX package's op-class ablation of its fused
// block. It is the first design of K1 (swin_block_kernel.cuh: mma.sync, one
// window a block, which K1 ran until its wgmma redesign, swin_fwd_wg.cuh),
// not a copy: the stage and the activation are the
// kernel's compile-time switches STAGE and ACT, one instantiation per mode,
// so a mode's time differs from the full block's only by the work it
// removes or swaps. The nine modes, in the script's order:
//
//   full          the whole block with the A&S erf GELU (the script's
//                 _gelu_exact, also in bf16; K1 uses tanh there)
//   noattn        proj reads the unscaled q columns of qkv, no attention
//   attnonly      out = h = x + proj(attention): no LN2, no MLP
//   mlponly       h = x: no LN1, qkv, attention or proj
//   allheads      full's function; on the TPU it retried a packed-head
//                 layout that Mosaic could not lower. Here the heads are
//                 already processed two at a time in registers, so it IS
//                 full's instantiation and equals full bit for bit
//   mlp_nogelu    full with no activation
//   mlp_tanhgelu  full with the tanh GELU: K1's function on the first
//                 design; within K1's bound of K1 (the products sum in
//                 other orders on wgmma)
//   mlp_siggelu   full with x * sigmoid(1.702 x)
//   mlp_polygelu  full with erf as a degree-25 polynomial of x / sqrt(2)
//                 clipped to [-4, 4], Horner from the highest power; the
//                 26 fp32 coefficients come from the caller (the script's
//                 Chebyshev fit, kernels/swin_stage_ablation.py) into this
//                 source's constant memory, which no other kernel reads
//
// LN2 reads bf16(h), as K1 and the script do. What bounds it: as K1
// (compute at the flagship widths; latency of the tile steps in this
// design). Compiled for C in 129..192 (the flagship's 180) only: the tool
// runs that width, and the seven instantiations of one width class keep
// the build short.

#include "swin_block_kernel.cuh"

namespace swin {

constexpr int ERF_TERMS = 26;  // degree 25

// mlp_polygelu's coefficients, lowest power first: the same for every
// thread, so they sit in constant memory, set before each such launch
__constant__ float erf_coef[ERF_TERMS];

// ACT_POLY's erf (declared in swin_block_kernel.cuh): Horner from the
// highest power on u already clipped to [-4, 4]
__device__ float erf_poly(float u) {
  float acc = erf_coef[ERF_TERMS - 1];
#pragma unroll
  for (int i = ERF_TERMS - 2; i >= 0; --i) acc = acc * u + erf_coef[i];
  return acc;
}

}  // namespace swin

namespace {

using namespace swin;

enum Mode {
  FULL, NOATTN, ATTNONLY, MLPONLY, ALLHEADS, MLP_NOGELU, MLP_TANHGELU, MLP_SIGGELU, MLP_POLYGELU
};

template <int STAGE, int ACT>
int run(const Params& p, int bw, void* stream) {
  return run_block<false, false, STAGE, ACT, 3>(p, bw, stream);
}

}  // namespace

// C entry point, bound with ctypes; the arguments are K1's
// (swin_block_bf16) plus `mode` (0..8 in the order above) and `coef`, a
// host array of 26 floats (lowest power first) that mlp_polygelu copies to
// constant memory on `stream` and the other modes ignore (may be null).
// Returns a cudaError_t: the launch is asynchronous on `stream`.
extern "C" int swin_stage_block_bf16(const void* x, const void* ln1_w, const void* ln1_b,
                                     const void* wqkv, const void* bqkv, const void* bias,
                                     const void* wproj, const void* bproj, const void* ln2_w,
                                     const void* ln2_b, const void* w1, const void* b1,
                                     const void* w2, const void* b2, void* out, int bw, int c,
                                     int heads, int hidden, float scale, int mode,
                                     const float* coef, void* stream) {
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
  p.c = p.cio = c;
  p.heads = heads;
  p.hidden = hidden;
  p.scale = scale;
  if (mode == MLP_POLYGELU) {
    if (coef == nullptr) return (int)cudaErrorInvalidValue;
    const cudaError_t err =
        cudaMemcpyToSymbolAsync(erf_coef, coef, sizeof(erf_coef), 0, cudaMemcpyHostToDevice,
                                static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
  }
  switch (mode) {
    case FULL:
    case ALLHEADS: return run<STAGE_FULL, ACT_ERF>(p, bw, stream);
    case NOATTN: return run<STAGE_NOATTN, ACT_ERF>(p, bw, stream);
    case ATTNONLY: return run<STAGE_ATTNONLY, ACT_ERF>(p, bw, stream);
    case MLPONLY: return run<STAGE_MLPONLY, ACT_ERF>(p, bw, stream);
    case MLP_NOGELU: return run<STAGE_FULL, ACT_NONE>(p, bw, stream);
    case MLP_TANHGELU: return run<STAGE_FULL, ACT_TANH>(p, bw, stream);
    case MLP_SIGGELU: return run<STAGE_FULL, ACT_SIGMOID>(p, bw, stream);
    case MLP_POLYGELU: return run<STAGE_FULL, ACT_POLY>(p, bw, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory one block needs (the first design's), for the wrapper's check.
extern "C" size_t swin_stage_block_smem_bytes(int c, int hidden) {
  return make_layout(c, round16(c), round16(hidden)).total;
}
