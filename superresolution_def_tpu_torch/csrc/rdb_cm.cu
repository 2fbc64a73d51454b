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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "swin_common.cuh"

using namespace swin;

namespace {

constexpr int THREADS7 = 512;
constexpr int WARPS7 = THREADS7 / 32;
constexpr int HALO = 5;  // one pixel per conv

struct RdbParams {
  const bf16* x;          // (B, F, H*W)
  bf16* out;              // (B, F, H*W)
  bf16* stash;            // (B, H*W, F + 4G) x, x1..x4 of the output tiles, or null
  const uint32_t* wfrag;  // the five convs' B fragments, conv after conv
  const float* bias;      // b1..b4 (G each), b5 (F)
  int h, w, ts, tiles_x;
  int woff[5];            // word offset of conv i's fragments
  int ps[5];              // shared-memory pixel stride (bf16) of x, x1..x4
  int soff[5];            // byte offset of each source's buffer
  int woff_smem;          // byte offset of the staged weight group
};

__device__ __forceinline__ float lrelu02(float v) { return v >= 0.f ? v : 0.2f * v; }

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16x8, row) . b (8x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// 16-byte asynchronous global -> shared copy.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// One pass of a unit loop for conv I (1..5) with F feature and G growth
// channels: MTU m-tiles (16 pixels each) by NTU n8-tiles per unit of work,
// K walking the taps, the sources 0..I-1 and their channel chunks (all
// compile-time but the taps), the B fragments read from the staged weights.
template <int NTU, int MTU, int I, int F, int G, typename Epi>
__device__ __forceinline__ void conv_units(const RdbParams& P, const unsigned char* smem, int R,
                                           int M, int n0, const uint32_t* wsm, Epi& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int units = ((M + 15) / 16 + MTU - 1) / MTU;
  for (int u = warp; u < units; u += WARPS7) {
    int pix[MTU][I];  // each source's pixel index of this lane's row at tap (0, 0)
#pragma unroll
    for (int m = 0; m < MTU; ++m) {
      const int p = min((u * MTU + m) * 16 + (lane & 15), M - 1);
      const int py = p / R, px = p - py * R;
#pragma unroll
      for (int s = 0; s < I; ++s) {
        const int rs = P.ts + 2 * (HALO - s);
        pix[m][s] = (py + I - s) * rs + px + I - s;
      }
    }
    float acc[MTU][NTU][4];
#pragma unroll
    for (int m = 0; m < MTU; ++m)
#pragma unroll
      for (int j = 0; j < NTU; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
    const uint32_t* wp = wsm;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
      for (int s = 0; s < I; ++s) {
        const int cs = s == 0 ? F : G;
        const int rs = P.ts + 2 * (HALO - s), ps = P.ps[s];
        const bf16* src = reinterpret_cast<const bf16*>(smem + P.soff[s]);
        // lane l addresses row l & 15 of each m-tile at this tap
        const bf16* a[MTU];
#pragma unroll
        for (int m = 0; m < MTU; ++m) a[m] = src + (pix[m][s] + dy * rs + dx) * ps;
#pragma unroll
        for (int k0 = 0; k0 + 16 <= cs; k0 += 16) {
          uint32_t fa[MTU][4];
#pragma unroll
          for (int m = 0; m < MTU; ++m) ldsm_x4(fa[m], a[m] + k0 + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < NTU; ++j) {
            const uint2 bw = reinterpret_cast<const uint2*>(wp)[j * 32 + lane];
#pragma unroll
            for (int m = 0; m < MTU; ++m) mma_bf16(acc[m][j], fa[m], bw.x, bw.y);
          }
          wp += NTU * 32 * 2;
        }
        if (cs % 16) {  // the last 8 channels of the source (lanes 0-15 address)
          uint32_t fa[MTU][2];
#pragma unroll
          for (int m = 0; m < MTU; ++m) ldsm_x2(fa[m], a[m] + cs - 8);
#pragma unroll
          for (int j = 0; j < NTU; ++j) {
            const uint32_t bw = wp[j * 32 + lane];
#pragma unroll
            for (int m = 0; m < MTU; ++m) mma_bf16_k8(acc[m][j], fa[m], bw);
          }
          wp += NTU * 32;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MTU; ++m) epi((u * MTU + m) * 16, n0, R, M, acc[m]);
  }
}

// Conv I (1..5) over its (ts + 2*(5-I))^2 region from sources 0..I-1 in
// shared memory, one group of G output channels (NTU n8-tiles) at a time:
// the group's weight fragments are copied to shared memory (all warps read
// them there), then the warps share out the region's m-tiles, two to a unit
// where that keeps as few rounds as one, so that each fragment feeds two
// products. epi(pixel_base, n_base, R, M, acc[NTU][4]) stores 16 pixels x G.
template <int NTU, int I, int F, int G, typename Epi>
__device__ __forceinline__ void conv_phase(const RdbParams& P, unsigned char* smem, Epi epi) {
  constexpr int NOUT = I < 5 ? G : F;
  constexpr int CIN = F + (I - 1) * G;
  constexpr int GROUP_WORDS = 9 * CIN * G / 2;
  const int R = P.ts + 2 * (HALO - I), M = R * R, MT = (M + 15) / 16;
  uint32_t* wsm = reinterpret_cast<uint32_t*>(smem + P.woff_smem);
  const bool pairs = (MT + 2 * WARPS7 - 1) / (2 * WARPS7) * 2 <= (MT + WARPS7 - 1) / WARPS7;
#pragma unroll 1
  for (int ng = 0; ng < NOUT / G; ++ng) {
    __syncthreads();  // the previous group's (or conv's) readers are done
    const uint4* src = reinterpret_cast<const uint4*>(P.wfrag + P.woff[I - 1] +
                                                      (size_t)ng * GROUP_WORDS);
    for (int k = threadIdx.x; k < GROUP_WORDS / 4; k += THREADS7)
      cp_async16(reinterpret_cast<uint4*>(wsm) + k, src + k);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (pairs)
      conv_units<NTU, 2, I, F, G>(P, smem, R, M, ng * G, wsm, epi);
    else
      conv_units<NTU, 1, I, F, G>(P, smem, R, M, ng * G, wsm, epi);
  }
}

// conv I (1..4): x_I = bf16(lrelu(sum + b_I)) into its shared buffer, zero
// outside the image
template <int NTG, int F, int I>
__device__ __forceinline__ void intermediate_conv(const RdbParams& P, unsigned char* smem, int ty0,
                                                  int tx0) {
  constexpr int G = NTG * 8, HI = HALO - I;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  bf16* dst = reinterpret_cast<bf16*>(smem + P.soff[I]);
  const float* bi = P.bias + (I - 1) * G;
  const int ps = P.ps[I], H = P.h, W = P.w;
  constexpr int CS = F + 4 * G;
  bf16* stash = P.stash == nullptr ? nullptr : P.stash + (size_t)blockIdx.y * H * W * CS;
  conv_phase<NTG, I, F, G>(P, smem, [&](int p0, int n0, int R, int M, float (&acc)[NTG][4]) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + g + 8 * half;
      if (p >= M) continue;
      const int py = p / R, px = p - py * R, gy = ty0 - HI + py, gx = tx0 - HI + px;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const bool core = stash != nullptr && inside && py >= HI && py < HI + P.ts && px >= HI &&
                        px < HI + P.ts;
#pragma unroll
      for (int j = 0; j < NTG; ++j) {
        const int n = n0 + j * 8 + tig * 2;
        const float v0 = inside ? lrelu02(acc[j][2 * half] + bi[n]) : 0.f;
        const float v1 = inside ? lrelu02(acc[j][2 * half + 1] + bi[n + 1]) : 0.f;
        const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(dst + p * ps + n) = v;
        if (core)
          *reinterpret_cast<__nv_bfloat162*>(stash + ((size_t)gy * W + gx) * CS + F +
                                             (I - 1) * G + n) = v;
      }
    }
  });
}

template <int NTG, int NTF>
__global__ void __launch_bounds__(THREADS7, 1) rdb_kernel(const RdbParams P) {
  constexpr int F = NTF * 8, G = NTG * 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int H = P.h, W = P.w, TS = P.ts;
  const int ty0 = (blockIdx.x / P.tiles_x) * TS, tx0 = (blockIdx.x % P.tiles_x) * TS;
  const int b = blockIdx.y;
  const bf16* xg = P.x + (size_t)b * F * H * W;
  bf16* og = P.out + (size_t)b * F * H * W;

  // ---- the (TS+10)^2 input halo, zero outside the image, two channels a
  // thread; eight iterations' loads are issued before their stores
  const int R0 = TS + 2 * HALO, total = (F / 2) * R0 * R0;
  bf16* xs = reinterpret_cast<bf16*>(smem + P.soff[0]);
  bf16* stash = P.stash == nullptr ? nullptr : P.stash + (size_t)b * H * W * (F + 4 * G);
  constexpr int U = 8;
  for (int base = tid; base < total; base += THREADS7 * U) {
    float v[U][2];
    int at[U];
#pragma unroll
    long long sat[U];  // the stash index of a core pixel's channel pair, or -1
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int idx = base + k * THREADS7;
      const int cp = idx / (R0 * R0), pix = idx - cp * R0 * R0;
      const int ry = pix / R0, rx = pix - ry * R0, gy = ty0 - HALO + ry, gx = tx0 - HALO + rx;
      at[k] = idx < total ? pix * P.ps[0] + 2 * cp : -1;
      sat[k] = -1;
      v[k][0] = v[k][1] = 0.f;
      if (idx < total && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const size_t off = ((size_t)(2 * cp) * H + gy) * W + gx;
        v[k][0] = __bfloat162float(xg[off]);
        v[k][1] = __bfloat162float(xg[off + (size_t)H * W]);
        if (stash != nullptr && ry >= HALO && ry < HALO + TS && rx >= HALO && rx < HALO + TS)
          sat[k] = ((long long)gy * W + gx) * (F + 4 * G) + 2 * cp;
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (at[k] >= 0)
        *reinterpret_cast<__nv_bfloat162*>(xs + at[k]) = __floats2bfloat162_rn(v[k][0], v[k][1]);
      if (sat[k] >= 0)
        *reinterpret_cast<__nv_bfloat162*>(stash + sat[k]) = __floats2bfloat162_rn(v[k][0], v[k][1]);
    }
  }

  // ---- conv1..conv4 (conv_phase synchronises before each group)
  intermediate_conv<NTG, F, 1>(P, smem, ty0, tx0);
  intermediate_conv<NTG, F, 2>(P, smem, ty0, tx0);
  intermediate_conv<NTG, F, 3>(P, smem, ty0, tx0);
  intermediate_conv<NTG, F, 4>(P, smem, ty0, tx0);

  // ---- conv5: out = (sum + b5) * 0.2 + x, channels-major to device memory
  const float* b5 = P.bias + 4 * G;
  conv_phase<NTG, 5, F, G>(P, smem, [&](int p0, int n0, int R, int M, float (&acc)[NTG][4]) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + g + 8 * half;
      if (p >= M) continue;
      const int py = p / R, px = p - py * R, gy = ty0 + py, gx = tx0 + px;
      if (gy >= H || gx >= W) continue;
      const bf16* xc = xs + ((py + HALO) * R0 + px + HALO) * P.ps[0];
#pragma unroll
      for (int j = 0; j < NTG; ++j) {
        const int n = n0 + j * 8 + tig * 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float o = (acc[j][2 * half + e] + b5[n + e]) * 0.2f + __bfloat162float(xc[n + e]);
          og[((size_t)(n + e) * H + gy) * W + gx] = __float2bfloat16(o);
        }
      }
    }
  });
}

// Shared-memory plan at tile side ts: per source its pixel stride (bf16) and
// byte offset, then the weight group (the widest is conv5's: 9 x (F + 4G) x G
// bf16); returns the total. A stride whose 16-byte count is odd keeps
// ldmatrix's eight rows on distinct bank groups.
size_t plan(int f, int g, int ts, int* ps, int* soff, int* woff_smem) {
  size_t o = 0;
  for (int s = 0; s < 5; ++s) {
    const int ch = s == 0 ? f : g;
    const int r = ts + 2 * (HALO - s);
    ps[s] = (ch / 8) % 2 == 1 ? ch : ch + 8;
    soff[s] = (int)o;
    o += align128(sizeof(bf16) * (size_t)r * r * ps[s]);
  }
  *woff_smem = (int)o;
  return o + align128(sizeof(bf16) * 9 * (size_t)(f + 4 * g) * g);
}

template <int NTG, int NTF>
cudaError_t launch(const RdbParams& P, int bsz, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(rdb_kernel<NTG, NTF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_y = (P.h + P.ts - 1) / P.ts;
  rdb_kernel<NTG, NTF><<<dim3(P.tiles_x * tiles_y, bsz), THREADS7, smem, stream>>>(P);
  return cudaGetLastError();
}

constexpr size_t MAX_SMEM = 232448;

}  // namespace

// The widest output tile whose buffers fit in shared memory (16, 12 or 8),
// or 0 when none does.
extern "C" int rdb_cm_tile(int f, int g) {
  int ps[5], soff[5], woff_smem;
  const int sizes[] = {16, 12, 8};
  for (int ts : sizes)
    if (plan(f, g, ts, ps, soff, &woff_smem) <= MAX_SMEM) return ts;
  return 0;
}

// C entry point, bound with ctypes; returns a cudaError_t. x and out are
// (bsz, f, h*w) bf16; wfrag holds the five convs' weights in B-fragment order
// (the wrapper's pack_rdb_weights) at word offsets woff; bias is b1..b5 fp32;
// stash, when not null, receives x, x1..x4 as (bsz, h*w, f + 4g) bf16.
// Takes F/G = 48/24, 64/32 and 16/8.
extern "C" int rdb_cm_bf16(const void* x, const void* wfrag, const int* woff, const void* bias,
                           void* out, void* stash, int bsz, int f, int g, int h, int w,
                           void* stream) {
  if (bsz <= 0 || h <= 0 || w <= 0 || !((f == 48 && g == 24) || (f == 64 && g == 32) ||
                                        (f == 16 && g == 8)))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(wfrag) % 8 != 0) return (int)cudaErrorMisalignedAddress;
  RdbParams P = {};
  P.x = static_cast<const bf16*>(x);
  P.out = static_cast<bf16*>(out);
  P.stash = static_cast<bf16*>(stash);
  P.wfrag = static_cast<const uint32_t*>(wfrag);
  P.bias = static_cast<const float*>(bias);
  P.h = h;
  P.w = w;
  P.ts = rdb_cm_tile(f, g);
  if (P.ts == 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(wfrag) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  for (int i = 0; i < 5; ++i) {
    if (woff[i] % 4 != 0) return (int)cudaErrorMisalignedAddress;
    P.woff[i] = woff[i];
  }
  const size_t smem = plan(f, g, P.ts, P.ps, P.soff, &P.woff_smem);
  P.tiles_x = (w + P.ts - 1) / P.ts;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f == 48) return (int)launch<3, 6>(P, bsz, smem, s);
  if (f == 64) return (int)launch<4, 8>(P, bsz, smem, s);
  return (int)launch<1, 2>(P, bsz, smem, s);
}
