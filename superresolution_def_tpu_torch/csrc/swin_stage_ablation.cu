// K13: the fused Swin block with swappable stages, for attributing the
// time of the wgmma forward body (swin_fwd_wg.cuh: K1, K2, K5, K9a, K4b's
// recompute, K6, K10a) to its stages on Hopper. bf16 in and out.
//
// Replaces the TPU kernel scripts/swin_stage_ablation.py::block (kernel body
// _make_kernel(mode)), the JAX package's op-class ablation of its fused
// block. It is K1's kernel, not a copy: the stage and the activation are
// the body's compile-time modes STAGE and ACT (swin_fwd_wg.cuh), one
// instantiation per mode, each of which only takes work away (tiles from
// the producer's stream as well as products from the consumers), so a
// mode's time differs from the full block's only by the work it removes
// or swaps. The nine modes, in the script's order:
//
//   full          the whole block with the A&S erf GELU (the script's
//                 _gelu_exact, also in bf16; K1 uses tanh there)
//   noattn        per head only wq and wproj stream: proj reads bf16(q +
//                 bq), unscaled; no k, v, scores, softmax or P . v
//   attnonly      out = bf16(h), h = x + proj(attention): no LN2, no MLP
//   mlponly       h = x: no LN1, qkv, attention or proj
//   allheads      full's function; on the TPU it retried a packed-head
//                 layout that Mosaic could not lower. Here every head runs
//                 on wgmma already, so it IS full's instantiation and equals
//                 full bit for bit
//   mlp_nogelu    full with no activation
//   mlp_tanhgelu  full with the tanh GELU: K1's function, and K1's own
//                 instantiation (swin_fwd_wg_kernel<3, 32, false>): K1's
//                 bits
//   mlp_siggelu   full with x * sigmoid(1.702 x)
//   mlp_polygelu  full with erf as a degree-25 polynomial of x / sqrt(2)
//                 clipped to [-4, 4], Horner from the highest power; the
//                 26 fp32 coefficients come from the caller (the script's
//                 Chebyshev fit, kernels/swin_stage_ablation.py) into this
//                 source's constant memory, which no other kernel reads
//
// The weights come packed as K1 takes them (swin_block.cu's
// swin_block_pack_bf16); NOATTN and MLPONLY stream a subset of the same
// tiles. LN2 reads bf16(h), as K1 and the script do. What bounds it: as K1
// (compute at the flagship widths). Compiled for C in 129..192 with
// head_dim 17..32 (NCH 3, HP 32; the flagship's 180 with 6 heads of 30)
// only: the tool runs that width, and one width class keeps the build
// short.

#include "swin_fwd_wg.cuh"

namespace swin {

constexpr int ERF_TERMS = 26;  // degree 25

// mlp_polygelu's coefficients, lowest power first: the same for every
// thread, so they sit in constant memory, set before each such launch
__constant__ float erf_coef[ERF_TERMS];

// ACT_POLY's erf (declared in swin_fwd_wg.cuh): Horner from the highest
// power on u already clipped to [-4, 4]
__device__ float erf_poly(float u) {
  float acc = erf_coef[ERF_TERMS - 1];
#pragma unroll
  for (int i = ERF_TERMS - 2; i >= 0; --i) acc = acc * u + erf_coef[i];
  return acc;
}

}  // namespace swin

namespace {

enum Mode {
  FULL, NOATTN, ATTNONLY, MLPONLY, ALLHEADS, MLP_NOGELU, MLP_TANHGELU, MLP_SIGGELU, MLP_POLYGELU
};

constexpr int NCH = 3, HP = 32;  // C in 129..192, head_dim 17..32

template <int NCH_, int HP_, int STAGE, int ACT>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    swin_stage_wg_kernel(const __grid_constant__ FwdWgParams p, int nw) {
  extern __shared__ __align__(1024) unsigned char fsm[];
  fwd_wg_body<NCH_, HP_, false, false, false, false, STAGE, ACT>(p, nw, fsm);
}

// the mode's instantiation; the full block with the tanh GELU is K1's
template <int STAGE, int ACT>
int run(const FwdWgParams& p, int nw, cudaStream_t s) {
  if constexpr (STAGE == STAGE_FULL && ACT == ACT_TANH)
    return (int)launch_fwd_wg(swin_fwd_wg_kernel<NCH, HP, false>, p, nw, false, s);
  else
    return (int)launch_fwd_wg(swin_stage_wg_kernel<NCH, HP, STAGE, ACT>, p, nw, false, s);
}

}  // namespace

// C entry point, bound with ctypes; the arguments are K1's (swin_block_bf16:
// wpack holds the weights packed by swin_block_pack_bf16) plus `mode` (0..8
// in the order above) and `coef`, a host array of 26 floats (lowest power
// first) that mlp_polygelu copies to constant memory on `stream` and the
// other modes ignore (may be null). Returns a cudaError_t: the launch is
// asynchronous on `stream`. A width outside the compiled class, or a mode
// whose kernel cannot launch (registers under FWD_MIN_REGS), returns an
// error; nothing falls back.
extern "C" int swin_stage_block_bf16(const void* x, const void* ln1_w, const void* ln1_b,
                                     const void* bqkv, const void* bias, const void* bproj,
                                     const void* ln2_w, const void* ln2_b, const void* b1,
                                     const void* b2, const void* wpack, void* out, int bw, int c,
                                     int heads, int hidden, float scale, int mode,
                                     const float* coef, void* stream) {
  if (bw <= 0 || !fwd_widths_ok(c, heads, hidden) || (c + TILE - 1) / TILE != NCH ||
      c / heads <= 16)
    return (int)cudaErrorInvalidValue;
  if (!fwd_aligned(x, 16) || !fwd_aligned(out, 16) || !fwd_aligned(bias, 8) ||
      !fwd_aligned(wpack, 16))
    return (int)cudaErrorMisalignedAddress;
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
  p.hd = c / heads;
  p.hidden = hidden;
  p.bw = bw;
  p.scale = scale;
  size_t attn = 0;
  fwd_pack_elems(c, heads, hidden, &attn);
  p.wattn = static_cast<const bf16*>(wpack);
  p.wmlp = p.wattn + attn;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == MLP_POLYGELU) {
    if (coef == nullptr) return (int)cudaErrorInvalidValue;
    const cudaError_t err =
        cudaMemcpyToSymbolAsync(erf_coef, coef, sizeof(erf_coef), 0, cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return (int)err;
  }
  const int nw = fwd_windows(c, c, heads, hidden, false);
  switch (mode) {
    case FULL:
    case ALLHEADS: return run<STAGE_FULL, ACT_ERF>(p, nw, s);
    case NOATTN: return run<STAGE_NOATTN, ACT_ERF>(p, nw, s);
    case ATTNONLY: return run<STAGE_ATTNONLY, ACT_ERF>(p, nw, s);
    case MLPONLY: return run<STAGE_MLPONLY, ACT_ERF>(p, nw, s);
    case MLP_NOGELU: return run<STAGE_FULL, ACT_NONE>(p, nw, s);
    case MLP_TANHGELU: return run<STAGE_FULL, ACT_TANH>(p, nw, s);
    case MLP_SIGGELU: return run<STAGE_FULL, ACT_SIGMOID>(p, nw, s);
    case MLP_POLYGELU: return run<STAGE_FULL, ACT_POLY>(p, nw, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory one block needs (K1's layout, at its windows a
// block), for the wrapper's check.
extern "C" size_t swin_stage_block_smem_bytes(int c, int heads, int hidden) {
  return fwd_wg_layout(c, c, heads, hidden, fwd_windows(c, c, heads, hidden, false), false)
      .total;
}
