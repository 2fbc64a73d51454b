// K7: the hybrid's residual dense block (RRDB trunk) for Hopper, bf16 in and
// out, channels-major (B, F, H*W) as the JAX package keeps it.
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
// lrelu(sum + bias) in fp32, zero outside the image (every later conv
// zero-pads, as the reference's convs do) and rounded to bf16 before they
// feed the next convs; out = (sum5 + b5) * 0.2 + x in fp32, then rounded.
// The RRDB residual (u * 0.2 + t) stays outside, in PyTorch.
//
// Design. The five sources live pixel-major in one (B, H*W, F + 4G) bf16
// tensor: x, then x1..x4 as the convs produce them. For training that tensor
// is the stash the backward K8 (rdb_cm_bwd.cu) reads, so x1..x4 there are
// the values the convs computed and rounded; at inference the wrapper passes
// scratch of the same shape. Six launches on the call's stream:
//
// 1. stash_x_kernel writes x into channels 0..F-1: 16-byte reads of 8
//    consecutive pixels of a channel, a transpose in shared memory, 16-byte
//    writes of 8 channels of a pixel.
// 2. conv_kernel (rdb_conv.cuh), once per conv: an implicit GEMM on wgmma (m64 x COUT x
//    k16, fp32 accumulators) with M = one 64-pixel row of a 64 x 4 output
//    tile (two consumer warpgroups of two rows each), N = the conv's output
//    channels (G, or F for conv5) and K = 9 taps x the conv's input
//    channels, walked 16 channels (a k step) at a time. Per k step a
//    producer thread brings in by TMA one 5-D box of the sources on the
//    tile's halo (66 pixels x 6 rows x 2 groups of 8 channels: 16-byte rows
//    of 8 channels, pixel after pixel, the interleaved K-major layout; zero
//    outside the image), so tap (dy, dx) of an output row is the same bytes
//    from pixel (row + 1 + dy, 1 + dx) on: nine taps from one copy. The
//    conv's weights (packed once per model, pack_rdb_cm_weights: per k step
//    [tap][COUT/8][2][8][8] bf16, wgmma's K-major B) come in once per block
//    by TMA bulk copies and stay in shared memory where they fit (all but
//    conv5 at F/G = 64/32, whose k steps arrive with their boxes); the
//    blocks are persistent, walk the tiles, and keep a 3- or 4-stage ring of
//    boxes ahead of the products under mbarriers. A source width that is
//    not a multiple of 16 (conv2 and conv4 at 48/24) ends on a k step that
//    starts 8 channels early, the repeated channels' weights zero. conv1..4
//    write x_k = bf16(lrelu(acc + b)) through shared memory as 16-byte runs
//    into their channels of the sources; conv5 writes out = (acc + b5) *
//    0.2 + x channels-major through shared memory, 16-byte runs of 8 pixels
//    of one channel.
//
// What bounds it: 269,568 FLOP per output pixel at 48/24 (141 GFLOP at
// 8 x 256^2) against 2 x 48 x 2 bytes per pixel in and out: operation-bound
// at the tensor cores' peak (0.143 ms at 8 x 256^2). The design does no
// halo recompute and runs every product on wgmma; what it gives up is the
// sources' round trip through device memory (each conv reads its inputs
// back, 1,536 bytes a pixel in all at 48/24 against the 192 a fused block
// needs, mostly from L2), the k-step padding of conv2 and conv4 (5 and 8
// k steps where 4.5 and 7.5 would do), and N = 24 products, whose A operand
// (2 KB a k16 step read from shared memory) costs more than their math.
// K12 (fused_rdb.cu, on NHWC activations) runs the same conv kernels
// (rdb_conv.cuh) with x read in place through a second tensor map, so it
// needs no transpose.

#include "rdb_conv.cuh"

namespace {

// ------------------------------------------------------------ x -> sources --

constexpr int XT_PIX = 64;  // pixels of one transpose tile

// x (B, F, hw) channels-major into channels 0..F-1 of the sources (B, hw, C).
// One block per 64 pixels of an image.
__global__ void __launch_bounds__(256) stash_x_kernel(const bf16* x, bf16* src, int F, int C,
                                                      int hw) {
  __shared__ __align__(16) bf16 tile[XT_PIX * (64 + 8)];
  const int ld = F + 8;  // a pixel's row: 16-byte multiple
  const int tiles = (hw + XT_PIX - 1) / XT_PIX;
  const int b = blockIdx.x / tiles, p0 = (blockIdx.x - b * tiles) * XT_PIX;
  const bf16* xb = x + (size_t)b * F * hw;
  const bool vec = hw % 8 == 0;
  for (int i = threadIdx.x; i < F * (XT_PIX / 8); i += blockDim.x) {
    const int c = i / (XT_PIX / 8), v = i - c * (XT_PIX / 8), p = p0 + 8 * v;
    bf16 e[8];
    if (vec && p + 8 <= hw) {
      *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(xb + (size_t)c * hw + p);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        e[k] = p + k < hw ? xb[(size_t)c * hw + p + k] : __float2bfloat16(0.f);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) tile[(8 * v + k) * ld + c] = e[k];
  }
  __syncthreads();
  const int per = F / 8;
  for (int i = threadIdx.x; i < XT_PIX * per; i += blockDim.x) {
    const int px = i / per, q = i - px * per;
    if (p0 + px < hw)
      *reinterpret_cast<uint4*>(src + ((size_t)b * hw + p0 + px) * C + 8 * q) =
          *reinterpret_cast<const uint4*>(tile + px * ld + 8 * q);
  }
}

// x -> sources, then conv1..conv5 at widths F/G
template <int F, int G>
cudaError_t launch_block(const CUtensorMap& map, const ConvParams& P, int bsz, const bf16* wp,
                         const int* woff, const float* bias, cudaStream_t s) {
  const int hw = P.h * P.w_;
  stash_x_kernel<<<bsz * ((hw + XT_PIX - 1) / XT_PIX), 256, 0, s>>>(P.x, P.src, F, P.c, hw);
  cudaError_t err = cudaGetLastError();
  const int sms = device_sms();
  if (err == cudaSuccess)
    err = launch_conv<F, G, false>(map, P, wp + woff[0], bias, F, sms, s);
  if (err == cudaSuccess)
    err = launch_conv<F + G, G, false>(map, P, wp + woff[1], bias + G, F + G, sms, s);
  if (err == cudaSuccess)
    err = launch_conv<F + 2 * G, G, false>(map, P, wp + woff[2], bias + 2 * G, F + 2 * G, sms, s);
  if (err == cudaSuccess)
    err = launch_conv<F + 3 * G, G, false>(map, P, wp + woff[3], bias + 3 * G, F + 3 * G, sms, s);
  if (err == cudaSuccess)
    err = launch_conv<F + 4 * G, F, true>(map, P, wp + woff[4], bias + 4 * G, 0, sms, s);
  return err;
}

template <int F, int G>
void smem_of(long long* out) {
  out[0] = (long long)Plan<F, G, false>::SMEM;
  out[1] = (long long)Plan<F + G, G, false>::SMEM;
  out[2] = (long long)Plan<F + 2 * G, G, false>::SMEM;
  out[3] = (long long)Plan<F + 3 * G, G, false>::SMEM;
  out[4] = (long long)Plan<F + 4 * G, F, true>::SMEM;
}

}  // namespace

// Dynamic shared memory of the five conv kernels at widths f/g, in bytes,
// into out[0..4]; returns 0, or a cudaError_t for widths that are not
// compiled.
extern "C" int rdb_cm_smem_bytes(int f, int g, long long* out) {
  if (f == 48 && g == 24) smem_of<48, 24>(out);
  else if (f == 64 && g == 32) smem_of<64, 32>(out);
  else if (f == 16 && g == 8) smem_of<16, 8>(out);
  else return (int)cudaErrorInvalidValue;
  return 0;
}

// C entry point, bound with ctypes; returns a cudaError_t. x and out are
// (bsz, f, h*w) bf16; stash, (bsz, h*w, f + 4g) bf16, receives x, x1..x4
// (the training stash K8 reads, or scratch); wpack holds the five convs'
// weights packed per k step (the wrapper's pack_rdb_cm_weights) at element
// offsets woff (multiples of 8); bias is b1..b5 fp32. Takes F/G = 48/24,
// 64/32 and 16/8.
extern "C" int rdb_cm_bf16(const void* x, const void* wpack, const int* woff, const void* bias,
                           void* out, void* stash, int bsz, int f, int g, int h, int w,
                           void* stream) {
  if (bsz <= 0 || h <= 0 || w <= 0 || !widths_ok(f, g) || stash == nullptr)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, wpack, out, stash};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  for (int i = 0; i < 5; ++i)
    if (woff[i] % 8 != 0) return (int)cudaErrorMisalignedAddress;
  const int c = f + 4 * g;
  CUtensorMap map;
  cudaError_t err = source_map(&map, stash, c, w, h, bsz);
  if (err != cudaSuccess) return (int)err;
  ConvParams P = {};
  P.x = static_cast<const bf16*>(x);
  P.out = static_cast<bf16*>(out);
  P.src = static_cast<bf16*>(stash);
  P.h = h;
  P.w_ = w;
  P.c = c;
  P.tiles_x = (w + TW - 1) / TW;
  P.tiles_img = P.tiles_x * ((h + TH - 1) / TH);
  P.ntiles = bsz * P.tiles_img;
  const bf16* wp = static_cast<const bf16*>(wpack);
  const float* b = static_cast<const float*>(bias);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f == 48) return (int)launch_block<48, 24>(map, P, bsz, wp, woff, b, s);
  if (f == 64) return (int)launch_block<64, 32>(map, P, bsz, wp, woff, b, s);
  return (int)launch_block<16, 8>(map, P, bsz, wp, woff, b, s);
}
