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
// function. Here each conv is K7's wgmma implicit GEMM (rdb_conv.cuh: 64 x 4
// output tiles, persistent blocks, a TMA ring of 16-channel k-step boxes on
// the tile's halo, K7's packed weights), and the layout needs no transpose:
// x is already pixel-major, so the k steps over x's F channels read it in
// place through a tensor map of its own (row stride F), and those over
// x1..x4 read a (B, H*W, 4G) scratch through a second map, into which
// conv1..conv4 write. The k steps are K7's (3 + 0, 3 + 2, 3 + 3, 3 + 5 and
// 3 + 6 at 48/24): only F/G = 16/8's conv2 has a step across the two, which
// reads the scratch map from channel -8 (zeros, under zero weights). conv5
// writes out = (acc + b5) * 0.2 + x NHWC, 16-byte runs of 8 channels of a
// pixel with x read the same way. H and W need not be tile multiples: TMA
// fills the halo outside the image with zeros and the stores check bounds.
// Six launches of K7 become five: no stash_x_kernel.
//
// What bounds it: K7's work, 269,568 FLOP per output pixel at 48/24 (141
// GFLOP at 8 x 256^2) against 2 x 48 x 2 bytes per pixel in and out:
// operation-bound at the tensor cores' peak (0.143 ms at 8 x 256^2). It
// gives up what K7's convs do (rdb_cm.cu): the sources' round trip through
// L2, the k-step padding of conv2 and conv4, the thin N = 24 products.

#include "rdb_conv.cuh"

namespace {

// conv1..conv5 at widths F/G, x1..x4 into the scratch's channels 0 .. 4G-1
template <int F, int G>
cudaError_t launch_nhwc_block(const CUtensorMap& smap, const CUtensorMap& xmap,
                              const ConvParams& P, const bf16* wp, const int* woff,
                              const float* bias, cudaStream_t s) {
  const int sms = device_sms();
  cudaError_t err = launch_nhwc_conv<F, F, G, false>(smap, xmap, P, wp + woff[0], bias, 0, sms, s);
  if (err == cudaSuccess)
    err = launch_nhwc_conv<F, F + G, G, false>(smap, xmap, P, wp + woff[1], bias + G, G, sms, s);
  if (err == cudaSuccess)
    err = launch_nhwc_conv<F, F + 2 * G, G, false>(smap, xmap, P, wp + woff[2], bias + 2 * G,
                                                    2 * G, sms, s);
  if (err == cudaSuccess)
    err = launch_nhwc_conv<F, F + 3 * G, G, false>(smap, xmap, P, wp + woff[3], bias + 3 * G,
                                                    3 * G, sms, s);
  if (err == cudaSuccess)
    err = launch_nhwc_conv<F, F + 4 * G, F, true>(smap, xmap, P, wp + woff[4], bias + 4 * G, 0,
                                                   sms, s);
  return err;
}

template <int F, int G>
void smem_of(long long* out) {
  out[0] = (long long)Plan<F, G, false, F>::SMEM;
  out[1] = (long long)Plan<F + G, G, false, F>::SMEM;
  out[2] = (long long)Plan<F + 2 * G, G, false, F>::SMEM;
  out[3] = (long long)Plan<F + 3 * G, G, false, F>::SMEM;
  out[4] = (long long)Plan<F + 4 * G, F, true, F>::SMEM;
}

}  // namespace

// Dynamic shared memory of the five conv kernels at widths f/g, in bytes,
// into out[0..4]; returns 0, or a cudaError_t for widths that are not
// compiled.
extern "C" int rdb_nhwc_smem_bytes(int f, int g, long long* out) {
  if (f == 48 && g == 24) smem_of<48, 24>(out);
  else if (f == 64 && g == 32) smem_of<64, 32>(out);
  else if (f == 16 && g == 8) smem_of<16, 8>(out);
  else return (int)cudaErrorInvalidValue;
  return 0;
}

// C entry point, bound with ctypes; returns a cudaError_t. x and out are
// (bsz, h, w, f) bf16; scratch, (bsz, h*w, 4g) bf16, receives x1..x4; wpack
// holds the five convs' weights packed per k step (K7's packing,
// fused_rdb_cm.pack_rdb_cm_weights) at element offsets woff (multiples of
// 8); bias is b1..b5 fp32. Takes F/G = 48/24, 64/32 and 16/8.
extern "C" int rdb_nhwc_bf16(const void* x, const void* wpack, const int* woff, const void* bias,
                             void* out, void* scratch, int bsz, int f, int g, int h, int w,
                             void* stream) {
  if (bsz <= 0 || h <= 0 || w <= 0 || !widths_ok(f, g) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, wpack, out, scratch};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  for (int i = 0; i < 5; ++i)
    if (woff[i] % 8 != 0) return (int)cudaErrorMisalignedAddress;
  CUtensorMap smap, xmap;
  cudaError_t err = source_map(&smap, scratch, 4 * g, w, h, bsz);
  if (err == cudaSuccess) err = source_map(&xmap, x, f, w, h, bsz);
  if (err != cudaSuccess) return (int)err;
  ConvParams P = {};
  P.x = static_cast<const bf16*>(x);
  P.out = static_cast<bf16*>(out);
  P.src = static_cast<bf16*>(scratch);
  P.h = h;
  P.w_ = w;
  P.c = 4 * g;
  P.tiles_x = (w + TW - 1) / TW;
  P.tiles_img = P.tiles_x * ((h + TH - 1) / TH);
  P.ntiles = bsz * P.tiles_img;
  const bf16* wp = static_cast<const bf16*>(wpack);
  const float* b = static_cast<const float*>(bias);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f == 48) return (int)launch_nhwc_block<48, 24>(smap, xmap, P, wp, woff, b, s);
  if (f == 64) return (int)launch_nhwc_block<64, 32>(smap, xmap, P, wp, woff, b, s);
  return (int)launch_nhwc_block<16, 8>(smap, xmap, P, wp, woff, b, s);
}
