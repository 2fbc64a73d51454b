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
// 2. conv_kernel, once per conv: an implicit GEMM on wgmma (m64 x COUT x
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
// K12 (fused_rdb.cu, on NHWC activations) takes the other road: all five
// convs fused in one 16 x 16 tile with a 26 x 26 halo held in shared memory
// (1.34x recompute, mma.sync).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "swin_common.cuh"

using namespace swin;

namespace {

constexpr int TW = 64, TH = 4;                 // the output tile: 4 rows of 64 pixels
constexpr int HPIX = (TH + 2) * (TW + 2);      // its halo: 396 pixels
constexpr int GROUP = HPIX * 16;               // one 8-channel group of the box
constexpr int BOX = 2 * GROUP;                 // a k step's box: 12,672 bytes
constexpr int CTHREADS = 3 * 128;              // two consumer warpgroups and a producer
constexpr size_t MAX_SMEM = 232448;            // one block on an SM
constexpr size_t MAX_SMEM2 = 115712;           // each of two blocks on an SM
constexpr int OUT_LD = 2 * TW + 4;             // conv5's fp32 staging row (a channel)

template <int CIN>
__host__ __device__ constexpr int ksteps() {
  return (CIN + 15) / 16;
}

template <int COUT>
__host__ __device__ constexpr int wstep() {  // bytes of one k step's weights
  return 9 * 16 * COUT * 2;
}

// a consumer warpgroup's output staging: conv1..4 bf16 [2 rows x 64 px][COUT];
// conv5 fp32 [COUT][2 rows x 64 px + 4]
template <int COUT, bool LAST>
__host__ __device__ constexpr int out_bytes() {
  return LAST ? COUT * OUT_LD * 4 : 2 * TW * COUT * 2;
}

// The conv's plan: weights resident where they fit beside three stages;
// two blocks an SM (85 registers a thread) where their shared memory fits,
// with up to four stages of the ring, else one block with up to four.
template <int CIN, int COUT, bool LAST>
struct Plan {
  static constexpr int KS = ksteps<CIN>();
  static constexpr int OUT = out_bytes<COUT, LAST>();
  static constexpr bool RES =
      (size_t)KS * wstep<COUT>() + 3 * BOX + 2 * OUT + 256 <= MAX_SMEM;
  static constexpr int WRES = RES ? KS * wstep<COUT>() : 0;
  static constexpr int STAGE = ((RES ? BOX : BOX + wstep<COUT>()) + 127) / 128 * 128;
  static constexpr size_t FIXED = (size_t)WRES + 2 * OUT + 256;
  static constexpr bool TWO = !LAST && FIXED + 2 * (size_t)STAGE <= MAX_SMEM2;
  static constexpr int FIT = (int)(((TWO ? MAX_SMEM2 : MAX_SMEM) - FIXED) / STAGE);
  static constexpr int NS = FIT < 4 ? FIT : 4;
  static constexpr int BLOCKS = TWO ? 2 : 1;
  static constexpr size_t SMEM = FIXED + (size_t)NS * STAGE;
};

template <int N>
__device__ __forceinline__ void wg_mma(float (&d)[N / 2], uint64_t da, uint64_t db) {
  using namespace hopper;
  if constexpr (N == 8) wgmma_n8<KMAJ, KMAJ>(d, da, db, 1);
  else if constexpr (N == 16) wgmma_n16<KMAJ, KMAJ>(d, da, db, 1);
  else if constexpr (N == 24) wgmma_n24<KMAJ, KMAJ>(d, da, db, 1);
  else if constexpr (N == 32) wgmma_n32<KMAJ, KMAJ>(d, da, db, 1);
  else if constexpr (N == 48) wgmma_n48<KMAJ, KMAJ>(d, da, db, 1);
  else wgmma_n64<KMAJ, KMAJ>(d, da, db, 1);
}

__device__ __forceinline__ float lrelu02(float v) { return v >= 0.f ? v : 0.2f * v; }

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

// ---------------------------------------------------------------- convs ----

struct ConvParams {
  const bf16* x;      // (B, F, H*W) channels-major: conv5's residual
  bf16* out;          // (B, F, H*W): conv5's output
  bf16* src;          // (B, H*W, C): the sources; conv1..4 write channels c0 ..
  const bf16* w;      // this conv's packed weights: per k step [tap][COUT/8][2][8][8]
  const float* bias;  // (COUT)
  int h, w_, c, c0, tiles_x, tiles_img, ntiles;
};

template <int CIN, int COUT, bool LAST>
__global__ void __launch_bounds__(CTHREADS, (Plan<CIN, COUT, LAST>::BLOCKS))
    conv_kernel(const __grid_constant__ CUtensorMap map, const ConvParams P) {
  using namespace hopper;
  using PL = Plan<CIN, COUT, LAST>;
  constexpr int KS = PL::KS, NS = PL::NS, STAGE = PL::STAGE, WS = wstep<COUT>();
  constexpr bool RES = PL::RES;
  constexpr int TX = BOX + (RES ? 0 : WS);
  extern __shared__ __align__(1024) unsigned char csm[];
  unsigned char* ring = csm + PL::WRES;  // the resident weights first, then the ring
  unsigned char* outs = ring + NS * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + 2 * PL::OUT);
  uint64_t* empty = full + NS;
  uint64_t* wbar = empty + NS;
  const int tid = threadIdx.x, wgi = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(wbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (wgi == 2) {
    if (tid == 256) {  // producer
      if (RES) {
        mbar_arrive_expect_tx(wbar, PL::WRES);
        for (int k = 0; k < KS; ++k)
          bulk_load(csm + k * WS, P.w + (size_t)k * WS / 2, WS, wbar);
      }
      int it = 0;
      for (int t = blockIdx.x; t < P.ntiles; t += gridDim.x) {
        const int b = t / P.tiles_img, r = t - b * P.tiles_img;
        const int ty0 = (r / P.tiles_x) * TH, tx0 = (r % P.tiles_x) * TW;
        for (int k = 0; k < KS; ++k, ++it) {
          const int st = it % NS;
          if (it >= NS) mbar_wait(&empty[st], (it / NS - 1) & 1);
          unsigned char* stage = ring + st * STAGE;
          // the last k step of a width off 16 starts 8 channels early
          const int cs = 16 * k + 16 <= CIN ? 16 * k : CIN - 16;
          mbar_arrive_expect_tx(&full[st], TX);
          tma_load_5d(stage, &map, 0, tx0 - 1, ty0 - 1, cs / 8, b, &full[st]);
          if (!RES) bulk_load(stage + BOX, P.w + (size_t)k * WS / 2, WS, &full[st]);
        }
      }
    }
    return;
  }
  // consumers: warpgroup wgi owns rows 2 wgi and 2 wgi + 1 of each tile
  const int lane = tid & 31, w = (tid >> 5) & 3, g = lane >> 2, t4 = lane & 3, wt = tid & 127;
  const int H = P.h, Wd = P.w_;
  if (RES) mbar_wait(wbar, 0);
  auto wg_sync = [&] { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory"); };
  int it = 0;
  for (int t = blockIdx.x; t < P.ntiles; t += gridDim.x) {
    const int b = t / P.tiles_img, r = t - b * P.tiles_img;
    const int ty0 = (r / P.tiles_x) * TH, tx0 = (r % P.tiles_x) * TW;
    float acc[2][COUT / 2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int i = 0; i < COUT / 2; ++i) acc[rr][i] = 0.f;
    for (int k = 0; k < KS; ++k, ++it) {
      const int st = it % NS;
      mbar_wait(&full[st], (it / NS) & 1);
      const unsigned char* stage = ring + st * STAGE;
      const unsigned char* wk = RES ? csm + k * WS : stage + BOX;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) fence_regs(acc[rr]);
      wg_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        const uint64_t db = desc(wk + tap * COUT * 32, 128, 256);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          wg_mma<COUT>(acc[rr],
                       desc(stage + ((2 * wgi + rr + 1 + dy) * (TW + 2) + 1 + dx) * 16, GROUP, 128),
                       db);
      }
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) fence_regs(acc[rr]);
      if (wt == 0) mbar_arrive(&empty[st]);
    }
    if constexpr (!LAST) {
      // x_k = bf16(lrelu(acc + b)) staged [pixel][channel], then 16-byte
      // runs into the conv's channels of each pixel inside the image
      bf16* ob = reinterpret_cast<bf16*>(outs + wgi * PL::OUT);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int j = 0; j < COUT / 8; ++j) {
          const int n = 8 * j + 2 * t4;
          const float b0 = __ldg(P.bias + n), b1 = __ldg(P.bias + n + 1);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int px = rr * TW + 16 * w + g + 8 * hh;
            *reinterpret_cast<uint32_t*>(ob + px * COUT + n) =
                pack_bf16(lrelu02(acc[rr][4 * j + 2 * hh] + b0),
                          lrelu02(acc[rr][4 * j + 2 * hh + 1] + b1));
          }
        }
      wg_sync();
      constexpr int PER = COUT / 8;
      for (int q = wt; q < 2 * TW * PER; q += 128) {
        const int px = q / PER, v = q - px * PER, rr = px / TW;
        const int gy = ty0 + 2 * wgi + rr, gx = tx0 + px - rr * TW;
        if (gy >= H || gx >= Wd) continue;
        *reinterpret_cast<uint4*>(P.src + ((size_t)(b * H + gy) * Wd + gx) * P.c + P.c0 + 8 * v) =
            *reinterpret_cast<const uint4*>(ob + px * COUT + 8 * v);
      }
      wg_sync();  // the staging is free
    } else {
      // out = (acc + b5) * 0.2 + x, channels-major: the fp32 tile through
      // shared memory ([n][row][pixel]), then 8 pixels of one channel a
      // thread, 16-byte loads of x and stores of out
      float* ob = reinterpret_cast<float*>(outs + wgi * PL::OUT);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int j = 0; j < COUT / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              ob[(8 * j + 2 * t4 + e) * OUT_LD + rr * TW + 16 * w + g + 8 * hh] =
                  acc[rr][4 * j + 2 * hh + e];
      wg_sync();
      const size_t img = (size_t)b * COUT * H * Wd;
      for (int q = wt; q < COUT * 2 * (TW / 8); q += 128) {
        const int n = q / (2 * TW / 8), rest = q - n * (2 * TW / 8), rr = rest / (TW / 8);
        const int gy = ty0 + 2 * wgi + rr, gx = tx0 + 8 * (rest % (TW / 8));
        if (gy >= H || gx >= Wd) continue;
        const float* v = ob + n * OUT_LD + rr * TW + gx - tx0;
        const float bn = __ldg(P.bias + n);
        const size_t off = img + ((size_t)n * H + gy) * Wd + gx;
        if (Wd % 8 == 0) {  // gx + 8 <= Wd, 16-byte aligned rows
          const uint4 xv = *reinterpret_cast<const uint4*>(P.x + off);
          const bf16* xe = reinterpret_cast<const bf16*>(&xv);
          uint4 o;
          uint32_t* ov = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ov[e] = pack_bf16((v[2 * e] + bn) * 0.2f + __bfloat162float(xe[2 * e]),
                              (v[2 * e + 1] + bn) * 0.2f + __bfloat162float(xe[2 * e + 1]));
          *reinterpret_cast<uint4*>(P.out + off) = o;
        } else {
          for (int e = 0; e < 8 && gx + e < Wd; ++e)
            P.out[off + e] = __float2bfloat16((v[e] + bn) * 0.2f + __bfloat162float(P.x[off + e]));
        }
      }
      wg_sync();  // the staging is free
    }
  }
}

// The 5-D tensor map (8 channels, W, H, C/8 channel groups, B) of the
// pixel-major (B, H*W, C) sources, boxes of 8 channels x (TW + 2) x (TH + 2)
// x 2 groups x 1: a box lands as two blocks of 16-byte rows (8 channels of
// a pixel), the interleaved wgmma layout; zero outside the image.
cudaError_t source_map(CUtensorMap* map, const void* base, int c, int w, int h, int b) {
  static PFN_cuTensorMapEncodeTiled encode = [] {
    void* fn = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault) != cudaSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[5] = {8, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)c / 8, (cuuint64_t)b};
  const cuuint64_t strides[4] = {(cuuint64_t)c * 2, (cuuint64_t)c * w * 2, 16,
                                 (cuuint64_t)c * w * h * 2};
  const cuuint32_t box[5] = {8, TW + 2, TH + 2, 2, 1};
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base),
                            dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int device_sms() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <int CIN, int COUT, bool LAST>
cudaError_t launch_conv(const CUtensorMap& map, ConvParams P, const bf16* w, const float* bias,
                        int c0, int sms, cudaStream_t s) {
  using PL = Plan<CIN, COUT, LAST>;
  static_assert(PL::NS >= 2, "a conv's plan needs two stages of its ring");
  cudaError_t err = cudaFuncSetAttribute(conv_kernel<CIN, COUT, LAST>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)PL::SMEM);
  if (err != cudaSuccess) return err;
  P.w = w;
  P.bias = bias;
  P.c0 = c0;
  const int blocks = PL::BLOCKS * sms < P.ntiles ? PL::BLOCKS * sms : P.ntiles;
  conv_kernel<CIN, COUT, LAST><<<blocks, CTHREADS, PL::SMEM, s>>>(map, P);
  return cudaGetLastError();
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

bool widths_ok(int f, int g) {
  return (f == 48 && g == 24) || (f == 64 && g == 32) || (f == 16 && g == 8);
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
