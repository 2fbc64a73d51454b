// The residual dense block kernel shared by K7 (rdb_cm.cu, channels-major
// (B, F, H*W) activations) and K12 (fused_rdb.cu, NHWC (B, H, W, F)): one
// thread block computes one TS x TS output tile of the whole five-conv block
// from a (TS+10)^2 input halo held in shared memory. Only the halo load and
// the output store know the activation's layout (template flag NHWC); the
// convs, the intermediates and the weight staging are the same code.
// rdb_cm.cu's header describes the design and its bound.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "swin_common.cuh"

namespace rdb {

using namespace swin;

constexpr int THREADS7 = 512;
constexpr int WARPS7 = THREADS7 / 32;
constexpr int HALO = 5;  // one pixel per conv

struct RdbParams {
  const bf16* x;          // (B, F, H*W), or (B, H, W, F) for NHWC
  bf16* out;              // as x
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

// As cp_async16, writing 16 zero bytes instead when !valid (src is not read).
__device__ __forceinline__ void cp_async16z(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
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

// The (TS+10)^2 input halo of a channels-major activation, zero outside the
// image, two channels a thread; eight iterations' loads are issued before
// their stores. With a stash, the core pixels go there too.
template <int F, int G>
__device__ __forceinline__ void load_halo_cm(const RdbParams& P, bf16* xs, const bf16* xg, int b,
                                             int ty0, int tx0) {
  const int tid = threadIdx.x, H = P.h, W = P.w, TS = P.ts;
  const int R0 = TS + 2 * HALO, total = (F / 2) * R0 * R0;
  bf16* stash = P.stash == nullptr ? nullptr : P.stash + (size_t)b * H * W * (F + 4 * G);
  constexpr int U = 8;
  for (int base = tid; base < total; base += THREADS7 * U) {
    float v[U][2];
    int at[U];
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
}

// The same halo of an NHWC activation: a pixel's F channels are contiguous
// in device memory and in shared memory, so it moves as F / 8 16-byte
// cp.async vectors, zero-filled outside the image.
template <int F>
__device__ __forceinline__ void load_halo_nhwc(const RdbParams& P, bf16* xs, const bf16* xg,
                                               int ty0, int tx0) {
  constexpr int VEC = F / 8;
  const int R0 = P.ts + 2 * HALO, total = R0 * R0 * VEC, H = P.h, W = P.w;
  for (int idx = threadIdx.x; idx < total; idx += THREADS7) {
    const int pix = idx / VEC, v = idx - pix * VEC;
    const int ry = pix / R0, rx = pix - ry * R0, gy = ty0 - HALO + ry, gx = tx0 - HALO + rx;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
    cp_async16z(xs + pix * P.ps[0] + v * 8, ok ? xg + ((size_t)gy * W + gx) * F + v * 8 : xg, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  // conv1's first conv_phase barrier orders these copies before any reader
}

template <int NTG, int NTF, bool NHWC>
__global__ void __launch_bounds__(THREADS7, 1) rdb_kernel(const RdbParams P) {
  constexpr int F = NTF * 8, G = NTG * 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int H = P.h, W = P.w, TS = P.ts;
  const int ty0 = (blockIdx.x / P.tiles_x) * TS, tx0 = (blockIdx.x % P.tiles_x) * TS;
  const int b = blockIdx.y;
  const bf16* xg = P.x + (size_t)b * F * H * W;
  bf16* og = P.out + (size_t)b * F * H * W;
  const int R0 = TS + 2 * HALO;
  bf16* xs = reinterpret_cast<bf16*>(smem + P.soff[0]);

  if (NHWC)
    load_halo_nhwc<F>(P, xs, xg, ty0, tx0);
  else
    load_halo_cm<F, G>(P, xs, xg, b, ty0, tx0);

  // ---- conv1..conv4 (conv_phase synchronises before each group)
  intermediate_conv<NTG, F, 1>(P, smem, ty0, tx0);
  intermediate_conv<NTG, F, 2>(P, smem, ty0, tx0);
  intermediate_conv<NTG, F, 3>(P, smem, ty0, tx0);
  intermediate_conv<NTG, F, 4>(P, smem, ty0, tx0);

  // ---- conv5: out = (sum + b5) * 0.2 + x to device memory
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
        const float o0 = (acc[j][2 * half] + b5[n]) * 0.2f + __bfloat162float(xc[n]);
        const float o1 = (acc[j][2 * half + 1] + b5[n + 1]) * 0.2f + __bfloat162float(xc[n + 1]);
        if (NHWC) {  // the channel pair is contiguous: one 4-byte store
          *reinterpret_cast<__nv_bfloat162*>(og + ((size_t)gy * W + gx) * F + n) =
              __floats2bfloat162_rn(o0, o1);
        } else {
          og[((size_t)n * H + gy) * W + gx] = __float2bfloat16(o0);
          og[((size_t)(n + 1) * H + gy) * W + gx] = __float2bfloat16(o1);
        }
      }
    }
  });
}

// Shared-memory plan at tile side ts: per source its pixel stride (bf16) and
// byte offset, then the weight group (the widest is conv5's: 9 x (F + 4G) x G
// bf16); returns the total. A stride whose 16-byte count is odd keeps
// ldmatrix's eight rows on distinct bank groups.
inline size_t plan(int f, int g, int ts, int* ps, int* soff, int* woff_smem) {
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

constexpr size_t MAX_SMEM = 232448;

// The widest output tile whose buffers fit in shared memory (16, 12 or 8),
// or 0 when none does.
inline int tile_side(int f, int g) {
  int ps[5], soff[5], woff_smem;
  const int sizes[] = {16, 12, 8};
  for (int ts : sizes)
    if (plan(f, g, ts, ps, soff, &woff_smem) <= MAX_SMEM) return ts;
  return 0;
}

template <int NTG, int NTF, bool NHWC>
cudaError_t launch(const RdbParams& P, int bsz, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(rdb_kernel<NTG, NTF, NHWC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_y = (P.h + P.ts - 1) / P.ts;
  rdb_kernel<NTG, NTF, NHWC><<<dim3(P.tiles_x * tiles_y, bsz), THREADS7, smem, stream>>>(P);
  return cudaGetLastError();
}

// Checks the widths and alignments, fills P and launches one block per
// output tile and image. Returns a cudaError_t as an int.
template <bool NHWC>
int run_rdb(const void* x, const void* wfrag, const int* woff, const void* bias, void* out,
            void* stash, int bsz, int f, int g, int h, int w, void* stream) {
  if (bsz <= 0 || h <= 0 || w <= 0 || !((f == 48 && g == 24) || (f == 64 && g == 32) ||
                                        (f == 16 && g == 8)))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(wfrag) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  // NHWC pixels move as 16-byte vectors
  if (NHWC && reinterpret_cast<uintptr_t>(x) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (NHWC && reinterpret_cast<uintptr_t>(out) % 4 != 0) return (int)cudaErrorMisalignedAddress;
  RdbParams P = {};
  P.x = static_cast<const bf16*>(x);
  P.out = static_cast<bf16*>(out);
  P.stash = static_cast<bf16*>(stash);
  P.wfrag = static_cast<const uint32_t*>(wfrag);
  P.bias = static_cast<const float*>(bias);
  P.h = h;
  P.w = w;
  P.ts = tile_side(f, g);
  if (P.ts == 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i) {
    if (woff[i] % 4 != 0) return (int)cudaErrorMisalignedAddress;
    P.woff[i] = woff[i];
  }
  const size_t smem = plan(f, g, P.ts, P.ps, P.soff, &P.woff_smem);
  P.tiles_x = (w + P.ts - 1) / P.ts;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f == 48) return (int)launch<3, 6, NHWC>(P, bsz, smem, s);
  if (f == 64) return (int)launch<4, 8, NHWC>(P, bsz, smem, s);
  return (int)launch<1, 2, NHWC>(P, bsz, smem, s);
}

}  // namespace rdb
