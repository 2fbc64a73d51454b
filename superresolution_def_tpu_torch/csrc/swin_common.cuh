// Device helpers shared by the Swin-block kernels (swin_block.cu: K1/K2,
// swin_block_train.cu: K3/K4): bf16 tensor-core products on mma.sync
// m16n8k16 with ldmatrix operands, a cp.async ring of 64 x 64 weight tiles,
// and LayerNorm over the 64 rows of an 8x8 window.
//
// Thread layout of every 64 x 64 output tile: 8 warps, warp w owns rows
// 16*(w & 3) .. +15 and columns 32*(w >> 2) .. +31; lane l holds rows
// g = l >> 2 and g + 8, columns 2*(l & 3) and +1 of each 8-wide block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace swin {

typedef __nv_bfloat16 bf16;

constexpr int N = 64;          // tokens per window (8 x 8)
constexpr int THREADS = 256;   // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int TILE = 64;       // output-column and k extent of one weight tile
constexpr int STAGES = 2;      // weight tiles in flight per block
constexpr int DP = 32;         // head_dim padded to two 16-wide k steps
constexpr int MAX_C = 256;     // LayerNorm keeps a row in 8 registers per lane
constexpr int LDQ = DP + 8;    // bf16 row stride of q, k, v (conflict-free ldmatrix)
constexpr int LDT = TILE + 8;  // bf16 row stride of a weight tile and the MLP chunk

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) & ~size_t(127); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float s = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.0f + tanhf(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 8-byte asynchronous global -> shared copy; zero-fills when !valid.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Four 8x8 bf16 matrices; lane l addresses row (l & 15), column block (l >> 4)
// of a 16x16 block for the A-operand and transposed-B layouts.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16x16, row) . b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A operand of rows m0..m0+15, k0..k0+15 from a matrix stored transposed,
// s[k][m] with row stride lds: the four 8x8 blocks (m lo/hi, k lo/hi).
__device__ __forceinline__ void ldsm_a_trans(uint32_t (&r)[4], const bf16* s, int lds, int k0,
                                             int m0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(r, s + (k0 + ((lane >> 4) & 1) * 8 + (lane & 7)) * lds + m0 +
                       ((lane >> 3) & 1) * 8);
}

// B operand of columns n0..n0+15 (two 8-wide halves: r[0..1], r[2..3]),
// k0..k0+15, from a matrix stored n-major, s[n][k] with row stride lds.
__device__ __forceinline__ void ldsm_b_nmajor(uint32_t (&r)[4], const bf16* s, int lds, int k0,
                                              int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * lds + k0 + ((lane >> 3) & 1) * 8);
}

// B operand as above from a matrix stored k-major, s[k][n].
__device__ __forceinline__ void ldsm_b_kmajor(uint32_t (&r)[4], const bf16* s, int lds, int k0,
                                              int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(r, s + (k0 + (lane & 15)) * lds + n0 + (lane >> 4) * 8);
}

// LayerNorm of 64 rows of width C, one warp per row, two-pass fp32 statistics;
// writes bf16 rows of width CP with zeros in the padding columns, and each
// row's mean and 1/std to stats[r], stats[N + r] when stats is not null.
template <typename Load>
__device__ __forceinline__ void layer_norm_rows(bf16* dst, int ldd, int C, int CP, Load load,
                                                const float* w, const float* b,
                                                float* stats = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < N; r += NWARPS) {
    float v[MAX_C / 32];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_C / 32; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C ? load(r, c) : 0.f;
      s += v[i];
    }
    const float mu = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_C / 32; ++i) {
      const int c = lane + 32 * i;
      const float d = c < C ? v[i] - mu : 0.f;
      q += d * d;
    }
    const float rstd = rsqrtf(warp_sum(q) / C + 1e-5f);
    if (stats != nullptr && lane == 0) {
      stats[r] = mu;
      stats[N + r] = rstd;
    }
#pragma unroll
    for (int i = 0; i < MAX_C / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < CP)
        dst[r * ldd + c] = __float2bfloat16(c < C ? (v[i] - mu) * rstd * w[c] + b[c] : 0.f);
    }
  }
}

// Start copying w[k0 : k0+kn, n0 : n0+nn] (row stride ldw) into the 64 x 64
// tile t, zero-filling the rest. Needs ldw, n0 and nn multiples of 4 and w
// 8-byte aligned (checked by the host entry).
__device__ __forceinline__ void issue_tile(bf16* t, const bf16* w, int ldw, int k0, int kn,
                                           int n0, int nn) {
#pragma unroll
  for (int u = 0; u < TILE * TILE / 4 / THREADS; ++u) {
    const int i = threadIdx.x + u * THREADS, kk = i >> 4, jj = (i & 15) * 4;
    const bool ok = kk < kn && jj < nn;
    cp_async8(t + kk * LDT + jj, ok ? w + (size_t)(k0 + kk) * ldw + n0 + jj : w, ok);
  }
}

struct Tile {
  const bf16* w;  // matrix, row-major
  int ldw, k0, kn, n0, nn;  // rows k0 .. k0+kn, columns n0 .. n0+nn
};

// Streams `steps` tiles (tile_of(s) says which) through the ring, one barrier
// each, and calls body(s, tile) once tile s has landed in shared memory; the
// copy of tile s+1 is in flight meanwhile. The barrier before each body also
// orders every shared-memory write of the previous bodies before the next
// one. Ends with a barrier.
template <typename TileOf, typename Body>
__device__ __forceinline__ void pipeline(int steps, bf16* ring, TileOf tile_of, Body body) {
  auto issue = [&](int s) {
    if (s < steps) {
      const Tile t = tile_of(s);
      issue_tile(ring + (s % STAGES) * TILE * LDT, t.w, t.ldw, t.k0, t.kn, t.n0, t.nn);
    }
    cp_async_commit();  // an empty group past the end keeps the wait count uniform
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile s have landed
    __syncthreads();              // everyone's have; tile s-1 is consumed
    issue(s + STAGES - 1);        // into the slot tile s-1 used
    body(s, ring + (s % STAGES) * TILE * LDT);
  }
  __syncthreads();
}

// The warp's share of a 64 x 64 output tile (`hi` says whether its second
// 16-wide column half is live): acc += a[rows, 0 : 16*ksteps] . B with B
// the tile t stored k-major, t[k][n].
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], const bf16* a, int lda,
                                         int ksteps, const bf16* t, bool hi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 32;
  for (int kk = 0; kk < ksteps; ++kk) {
    uint32_t fa[4], fb[4];
    ldsm_x4(fa, a + (r0 + (lane & 15)) * lda + kk * 16 + (lane >> 4) * 8);
    ldsm_x4_trans(fb, t + (kk * 16 + (lane & 15)) * LDT + c0 + (lane >> 4) * 8);
    mma_bf16(acc[0], fa, fb[0], fb[1]);
    mma_bf16(acc[1], fa, fb[2], fb[3]);
    if (hi) {
      ldsm_x4_trans(fb, t + (kk * 16 + (lane & 15)) * LDT + c0 + 16 + (lane >> 4) * 8);
      mma_bf16(acc[2], fa, fb[0], fb[1]);
      mma_bf16(acc[3], fa, fb[2], fb[3]);
    }
  }
}

// As mma_tile with the tile stored n-major, t[n][k]: acc += a . t^T.
__device__ __forceinline__ void mma_tile_nt(float (&acc)[4][4], const bf16* a, int lda,
                                            int ksteps, const bf16* t, bool hi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 32;
  for (int kk = 0; kk < ksteps; ++kk) {
    uint32_t fa[4], fb[4];
    ldsm_x4(fa, a + (r0 + (lane & 15)) * lda + kk * 16 + (lane >> 4) * 8);
    ldsm_b_nmajor(fb, t, LDT, kk * 16, c0);
    mma_bf16(acc[0], fa, fb[0], fb[1]);
    mma_bf16(acc[1], fa, fb[2], fb[3]);
    if (hi) {
      ldsm_b_nmajor(fb, t, LDT, kk * 16, c0 + 16);
      mma_bf16(acc[2], fa, fb[0], fb[1]);
      mma_bf16(acc[3], fa, fb[2], fb[3]);
    }
  }
}

// Calls f(row, col, v[col], v[col+1]) for every accumulator pair of the warp's
// share of a tile whose first column is n0 (columns of dead halves skipped).
template <typename F>
__device__ __forceinline__ void for_pairs(const float (&acc)[4][4], int n0, bool hi, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = (warp & 3) * 16 + (lane >> 2);
  const int col = n0 + (warp >> 2) * 32 + (lane & 3) * 2;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t < 2 || hi) {
      f(r, col + t * 8, acc[t][0], acc[t][1]);
      f(r + 8, col + t * 8, acc[t][2], acc[t][3]);
    }
  }
}

}  // namespace swin
