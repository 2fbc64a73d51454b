// The dense block's conv kernel on wgmma, shared by rdb_cm.cu (K7, the
// channels-major block) and fused_rdb.cu (K12, the NHWC block): its tile
// and ring plan, its body (conv_body), its parameters, the TMA map of the
// pixel-major sources and the launch helpers. rdb_cm.cu says what each conv
// computes and how the kernel is laid out.
//
// The body has one mode for K12, XC > 0: the first XC channels of every
// conv's input (x) come through a tensor map of their own over the NHWC
// activation, and x1..x4 through the main map over a (B, H*W, 4G) scratch,
// so that x is never copied; conv5 writes out = (acc + b5) * 0.2 + x NHWC.
// K7's kernel (conv_kernel, XC = 0) reads all of x, x1..x4 through one map
// over its (B, H*W, F + 4G) stash and writes out channels-major. The modes
// are separate kernels: conv_kernel takes one map, nhwc_conv_kernel two.

#pragma once

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
// conv5 fp32, channels-major [COUT][2 rows x 64 px + 4] (K7) or pixel-major
// [2 rows x 64 px][COUT + 4] (K12, XC > 0)
template <int COUT, bool LAST, int XC>
__host__ __device__ constexpr int out_bytes() {
  return !LAST ? 2 * TW * COUT * 2 : XC == 0 ? COUT * OUT_LD * 4 : 2 * TW * (COUT + 4) * 4;
}

// The conv's plan: weights resident where they fit beside three stages;
// two blocks an SM (85 registers a thread) where their shared memory fits,
// with up to four stages of the ring, else one block with up to four.
template <int CIN, int COUT, bool LAST, int XC = 0>
struct Plan {
  static constexpr int KS = ksteps<CIN>();
  static constexpr int OUT = out_bytes<COUT, LAST, XC>();
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

struct ConvParams {
  const bf16* x;      // conv5's residual: (B, F, H*W) channels-major (K7) or (B, H*W, F) (K12)
  bf16* out;          // conv5's output, in x's layout
  bf16* src;          // (B, H*W, C): the sources; conv1..4 write channels c0 ..
  const bf16* w;      // this conv's packed weights: per k step [tap][COUT/8][2][8][8]
  const float* bias;  // (COUT)
  int h, w_, c, c0, tiles_x, tiles_img, ntiles;
};

// Where k step k of a conv of CIN inputs reads its 16 channels: K7's start
// (the last step of a width off 16 moved back 8 channels, its repeated
// channels' weights zero), then, with XC > 0, the x map's channel groups
// while the step lies inside x, else the main map's, counted from XC (a
// step that starts below XC reads its first group as zeros outside the
// map, and its weights there are zero: only F/G = 16/8's conv2 has one).
template <int CIN, int XC>
__device__ __forceinline__ int step_group(int k, bool& on_x) {
  const int cs = 16 * k + 16 <= CIN ? 16 * k : CIN - 16;
  on_x = XC > 0 && cs + 16 <= XC;
  return (on_x || XC == 0 ? cs : cs - XC) / 8;
}

// The conv kernel's body: persistent blocks walk the 64 x 4 output tiles; a
// producer thread keeps the ring of k-step boxes (and the weights where
// they are not resident) in flight; two consumer warpgroups run the
// products and the epilogue. `xmap` is read only with XC > 0.
template <int CIN, int COUT, bool LAST, int XC>
__device__ __forceinline__ void conv_body(const CUtensorMap* map, const CUtensorMap* xmap,
                                          const ConvParams& P) {
  using namespace hopper;
  using PL = Plan<CIN, COUT, LAST, XC>;
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
          bool on_x;
          const int grp = step_group<CIN, XC>(k, on_x);
          mbar_arrive_expect_tx(&full[st], TX);
          tma_load_5d(stage, on_x ? xmap : map, 0, tx0 - 1, ty0 - 1, grp, b, &full[st]);
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
    } else if constexpr (XC == 0) {
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
    } else {
      // out = (acc + b5) * 0.2 + x, NHWC: the fp32 tile through shared
      // memory ([pixel][n]), then 8 channels of one pixel a thread, 16-byte
      // loads of x and stores of out
      constexpr int LD = COUT + 4, PER = COUT / 8;
      float* ob = reinterpret_cast<float*>(outs + wgi * PL::OUT);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int j = 0; j < COUT / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(ob + (rr * TW + 16 * w + g + 8 * hh) * LD + 8 * j +
                                       2 * t4) =
                make_float2(acc[rr][4 * j + 2 * hh], acc[rr][4 * j + 2 * hh + 1]);
      wg_sync();
      for (int q = wt; q < 2 * TW * PER; q += 128) {
        const int px = q / PER, v = q - px * PER, rr = px / TW;
        const int gy = ty0 + 2 * wgi + rr, gx = tx0 + px - rr * TW;
        if (gy >= H || gx >= Wd) continue;
        const float4* s4 = reinterpret_cast<const float4*>(ob + px * LD + 8 * v);
        const float4 lo = s4[0], hi = s4[1];
        const float a[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        const size_t off = ((size_t)(b * H + gy) * Wd + gx) * COUT + 8 * v;
        const uint4 xv = *reinterpret_cast<const uint4*>(P.x + off);
        const bf16* xe = reinterpret_cast<const bf16*>(&xv);
        uint4 o;
        uint32_t* ov = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ov[e] = pack_bf16(
              (a[2 * e] + __ldg(P.bias + 8 * v + 2 * e)) * 0.2f + __bfloat162float(xe[2 * e]),
              (a[2 * e + 1] + __ldg(P.bias + 8 * v + 2 * e + 1)) * 0.2f +
                  __bfloat162float(xe[2 * e + 1]));
        *reinterpret_cast<uint4*>(P.out + off) = o;
      }
      wg_sync();  // the staging is free
    }
  }
}

// K7's conv: all five sources through one map over the stash
template <int CIN, int COUT, bool LAST>
__global__ void __launch_bounds__(CTHREADS, (Plan<CIN, COUT, LAST>::BLOCKS))
    conv_kernel(const __grid_constant__ CUtensorMap map, const ConvParams P) {
  conv_body<CIN, COUT, LAST, 0>(&map, &map, P);
}

// K12's conv: x (XC channels) through xmap over the NHWC activation,
// x1..x4 through map over the scratch
template <int XC, int CIN, int COUT, bool LAST>
__global__ void __launch_bounds__(CTHREADS, (Plan<CIN, COUT, LAST, XC>::BLOCKS))
    nhwc_conv_kernel(const __grid_constant__ CUtensorMap map,
                     const __grid_constant__ CUtensorMap xmap, const ConvParams P) {
  conv_body<CIN, COUT, LAST, XC>(&map, &xmap, P);
}

// The 5-D tensor map (8 channels, W, H, C/8 channel groups, B) of a
// pixel-major (B, H*W, C) tensor, boxes of 8 channels x (TW + 2) x (TH + 2)
// x 2 groups x 1: a box lands as two blocks of 16-byte rows (8 channels of
// a pixel), the interleaved wgmma layout; zero outside the tensor.
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

// The plan's shared memory for `kernel`, then the persistent grid: one or
// two blocks an SM, no more than there are tiles.
template <typename PL, typename Kernel>
cudaError_t conv_grid(Kernel kernel, const ConvParams& P, int sms, int* blocks) {
  static_assert(PL::NS >= 2, "a conv's plan needs two stages of its ring");
  *blocks = PL::BLOCKS * sms < P.ntiles ? PL::BLOCKS * sms : P.ntiles;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)PL::SMEM);
}

ConvParams conv_params(ConvParams P, const bf16* w, const float* bias, int c0) {
  P.w = w;
  P.bias = bias;
  P.c0 = c0;
  return P;
}

// one conv of K7: the five sources through `map`
template <int CIN, int COUT, bool LAST>
cudaError_t launch_conv(const CUtensorMap& map, const ConvParams& P0, const bf16* w,
                        const float* bias, int c0, int sms, cudaStream_t s) {
  const ConvParams P = conv_params(P0, w, bias, c0);
  int blocks;
  cudaError_t err = conv_grid<Plan<CIN, COUT, LAST>>(conv_kernel<CIN, COUT, LAST>, P, sms, &blocks);
  if (err != cudaSuccess) return err;
  conv_kernel<CIN, COUT, LAST><<<blocks, CTHREADS, Plan<CIN, COUT, LAST>::SMEM, s>>>(map, P);
  return cudaGetLastError();
}

// one conv of K12: x through `xmap`, x1..x4 through `map`
template <int XC, int CIN, int COUT, bool LAST>
cudaError_t launch_nhwc_conv(const CUtensorMap& map, const CUtensorMap& xmap,
                             const ConvParams& P0, const bf16* w, const float* bias, int c0,
                             int sms, cudaStream_t s) {
  using PL = Plan<CIN, COUT, LAST, XC>;
  const ConvParams P = conv_params(P0, w, bias, c0);
  int blocks;
  cudaError_t err = conv_grid<PL>(nhwc_conv_kernel<XC, CIN, COUT, LAST>, P, sms, &blocks);
  if (err != cudaSuccess) return err;
  nhwc_conv_kernel<XC, CIN, COUT, LAST><<<blocks, CTHREADS, PL::SMEM, s>>>(map, xmap, P);
  return cudaGetLastError();
}

bool widths_ok(int f, int g) {
  return (f == 48 && g == 24) || (f == 64 && g == 32) || (f == 16 && g == 8);
}

}  // namespace
