// K7: the hybrid's residual dense block (RRDB trunk, inference) for Hopper,
// bf16 in and out, channels-major (B, F, H*W) as the JAX package keeps it.
//
// Replaces the TPU kernel superresolution_def_tpu/kernels/fused_rdb_cm.py::
// fused_rdb_cm (kernel body _make_kernel). One dense block is five 3x3 convs
// on the growing concatenation of its inputs:
//
//   x1 = lrelu(conv1(x)),  x2 = lrelu(conv2([x, x1])),  ...,
//   x5 = conv5([x, x1, x2, x3, x4]),  out = x5 * 0.2 + x      (lrelu slope 0.2)
//
// with F = 48 feature and G = 24 growth channels at the hybrid's widths.
// Rounding points follow the TPU kernel: every conv sums in fp32; x1..x4 are
// lrelu(sum + bias) in fp32, zeroed outside the image (so every later conv
// zero-pads, as the reference's convs do) and rounded to bf16 before they
// feed the next convs; x5 = sum + bias and out = x5 * 0.2 + x in fp32, then
// rounded. The RRDB residual (u * 0.2 + t) stays outside, in PyTorch.
//
// Training: given a stash pointer, each block also writes x, x1..x4 of its
// output tile, pixel-major (B, H*W, F + 4G) bf16, for the backward kernel K8
// (rdb_cm_bwd.cu). x1..x4 are the values the block computed and rounded, so
// the backward sees exactly what a recompute would give.
//
// Design. The TPU kernel keeps whole 256-pixel rows with channels on
// sublanes in its many megabytes of VMEM. Here one thread block (16 warps)
// computes one TS x TS output tile (TS = 16 at F/G = 48/24) from a (TS+10)^2
// input halo: conv1 runs on the (TS+8)^2 region, conv2 on (TS+6)^2, ...,
// conv5 on TS^2, so all five convs and the four intermediates stay in shared
// memory (161.5 KB at 48/24, pixel-major with each pixel's channels
// contiguous). Each conv is an implicit GEMM on mma.sync (m16n8k16 bf16, and
// m16n8k8 for a 24-channel source's last 8 channels) with fp32 accumulators:
// rows are 16 consecutive pixels of the conv's region, read by ldmatrix at
// the tap's shifted address in each source; the K dimension walks the 9 taps,
// then the sources, then 16-channel chunks. The wrapper lays the weights out
// in the tensor cores' B-fragment order, G output channels to a group; each
// group (conv5 has two) is copied once into shared memory (62.2 KB at
// 48/24), where every warp reads its fragments with one 8-byte load per
// lane. Warps take one or two m-tiles to a unit of work, whichever needs
// fewer rounds of the 16 warps, two letting each fragment feed two products.
//
// What bounds it: 269,568 FLOP per output pixel (141 GFLOP at 8 x 256^2)
// against 2 x 48 x 2 bytes per pixel in and out: operation-bound at the
// tensor cores' peak (0.143 ms at 8 x 256^2). This first design gives up:
// the halo recompute (conv1 runs on 2.25x the output pixels, 1.34x the
// block's useful FLOP in all), mma.sync rather than wgmma, one block of
// 16 warps per SM (224 KB of shared memory) with no copy overlapping the
// products, and idle warps in the rounds that do not divide evenly.
//
// The kernel body is rdb_block.cuh, which K12 (fused_rdb.cu, the same block
// on NHWC activations) shares.

#include "rdb_block.cuh"

using namespace rdb;

// The widest output tile whose buffers fit in shared memory (16, 12 or 8),
// or 0 when none does.
extern "C" int rdb_cm_tile(int f, int g) { return tile_side(f, g); }

// C entry point, bound with ctypes; returns a cudaError_t. x and out are
// (bsz, f, h*w) bf16; wfrag holds the five convs' weights in B-fragment order
// (the wrapper's pack_rdb_weights) at word offsets woff; bias is b1..b5 fp32;
// stash, when not null, receives x, x1..x4 as (bsz, h*w, f + 4g) bf16.
// Takes F/G = 48/24, 64/32 and 16/8.
extern "C" int rdb_cm_bf16(const void* x, const void* wfrag, const int* woff, const void* bias,
                           void* out, void* stash, int bsz, int f, int g, int h, int w,
                           void* stream) {
  return run_rdb<false>(x, wfrag, woff, bias, out, stash, bsz, f, g, h, w, stream);
}
