// K12: the hybrid's residual dense block (RRDB trunk, inference) for Hopper,
// bf16 in and out, channel-last (B, H, W, F).
//
// Replaces the TPU kernel superresolution_def_tpu/kernels/fused_rdb.py::
// fused_rdb (kernel body _make_rdb_kernel), which the JAX package's
// make_fused_hybrid(trunk_impl="kernel") runs 36 times a forward through
// fused_rrdb_trunk. It computes the same function as K7 (rdb_cm.cu) on the
// other layout:
//
//   x1 = lrelu(conv1(x)),  x2 = lrelu(conv2([x, x1])),  ...,
//   x5 = conv5([x, x1, x2, x3, x4]),  out = x5 * 0.2 + x      (lrelu slope 0.2)
//
// with the TPU kernel's rounding points: fp32 sums; x1..x4 = lrelu(sum +
// bias) in fp32, zero outside the image, rounded to bf16; out = (sum5 + b5)
// * 0.2 + x in fp32, then rounded.
//
// Design. The TPU kernel DMAs a (tile_h+10) x (tile_w+10) NHWC halo into
// VMEM and expands each source to im2col patches there; its tile_h, tile_w
// and tap_matmul switches choose among TPU formulations of that one
// function. Here the block is K7's kernel (rdb_block.cuh): one 512-thread
// block computes a 16 x 16 output tile at F/G = 48/24 (12 at 64/32), with x
// (65 KB at 48/24 with its halo) and x1..x4 held pixel-major in shared
// memory and each conv an implicit GEMM on mma.sync with fp32 accumulators;
// it picks its own tile and takes no such switch. NHWC is shared memory's
// own layout, so the halo moves as 16-byte cp.async vectors (zero-filled
// outside the image) and each output channel pair is one 4-byte store,
// where K7 gathers and scatters single channels. H and W need not be tile
// multiples: the halo load and the store check the image's bounds.
//
// What bounds it: K7's work, 269,568 FLOP per output pixel at 48/24 (141
// GFLOP at 8 x 256^2) against 2 x 48 x 2 bytes per pixel in and out:
// operation-bound at the tensor cores' peak (0.143 ms at 8 x 256^2). The
// design gives up what K7's does (rdb_cm.cu): the halo recompute, mma.sync
// rather than wgmma, no copy overlapping the products.

#include "rdb_block.cuh"

using namespace rdb;

// C entry point, bound with ctypes; returns a cudaError_t. x and out are
// (bsz, h, w, f) bf16, x 16-byte aligned; wfrag holds the five convs'
// weights in B-fragment order (fused_rdb_cm.pack_rdb_weights) at word
// offsets woff; bias is b1..b5 fp32. Takes F/G = 48/24, 64/32 and 16/8.
extern "C" int rdb_nhwc_bf16(const void* x, const void* wfrag, const int* woff, const void* bias,
                             void* out, int bsz, int f, int g, int h, int w, void* stream) {
  return run_rdb<true>(x, wfrag, woff, bias, out, nullptr, bsz, f, g, h, w, stream);
}
