// Fused Swin transformer block (inference) for Hopper, bf16 in and out.
//
// Replaces the TPU kernel superresolution_def_tpu/kernels/swin_block.py::
// fused_swin_block (kernel body _make_kernel). One thread block computes one
// pre-rolled, pre-partitioned 8x8 window (N = 64 tokens) end to end:
//
//   LN1 (fp32 stats) -> QKV (+bqkv, rounded to bf16)
//   -> per head: softmax(q*scale . k^T + bias[h]) . v   (softmax in fp32)
//   -> proj (+bproj) -> h = x + proj                     (residual in fp32)
//   -> LN2 of bf16(h) -> fc1 -> tanh GELU -> fc2 -> out = h + mlp
//
// Every matrix product runs on the tensor cores (mma.sync m16n8k16 bf16 with
// fp32 accumulators, operands through ldmatrix). Rounding points follow
// _make_kernel exactly: the LN outputs, qkv, q*scale, the softmax
// probabilities, the attention output and the GELU output are rounded to
// bf16; everything else stays fp32.
//
// What bounds it: the block does 823,680 FLOP per token, about 0.52 TFLOP for
// one 128x128 patch (36 blocks x 16,384 tokens), against 989 TFLOP/s bf16 on
// an H100, while its device-memory traffic is only the window in and out
// (the ~0.8 MB of weights stay resident in the 50 MB L2). So it is
// compute-bound once it is fast. This design is not there yet: every window
// streams all the weights from L2 through shared memory in 64 x 64 tiles
// (cp.async, one barrier per tile), and the latency of each tile's copies,
// products and epilogue, not the tensor cores, sets its speed (PERF.md has
// the phase breakdown). To hide it with more warps, a block keeps under
// ~110 KB of shared memory so that two fit on an SM: the fp32 residual h
// lives in the accumulator registers (proj and fc2 accumulate into it, LN2
// reads it there), q/k/v are produced two heads at a time and consumed at
// once by register-resident attention (scores, softmax and probabilities
// never touch shared memory), and the MLP streams its hidden dimension in
// 64-wide chunks.
//
// What this simple design gives up, for later work:
//   - mma.sync, not wgmma: at most about half the tensor-core rate; no TMA;
//   - one window per block, so every window re-reads the weights from L2;
//   - C = 180 is padded to 192 and head_dim 30 to 32 with zeros (6% and 7%
//     wasted tensor-core work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

struct Params {
  const bf16* x;
  const float* ln1_w;
  const float* ln1_b;
  const bf16* wqkv;
  const float* bqkv;
  const float* bias;
  const bf16* wproj;
  const float* bproj;
  const float* ln2_w;
  const float* ln2_b;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  bf16* out;
  int c, cp, heads, hd, hidden, hidden_p;
  float scale;
};

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// fp32 vectors staged in shared memory once per window, at these offsets (in
// units of C, b1 last): the epilogues and LayerNorms read them there
enum { V_LN1W, V_LN1B, V_BQKV, V_BPROJ = 5, V_LN2W, V_LN2B, V_B2, V_B1 };

// Shared-memory regions, 128-byte aligned. Row strides are 16-byte multiples
// whose rows fall on distinct 16-byte bank groups, as ldmatrix needs.
struct Layout {
  int lda;  // bf16 row stride of the two 64 x cp activation buffers
  size_t a, attn, big, ring, vec, red, qmap, total;
};

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) & ~size_t(127); }

__host__ __device__ inline Layout make_layout(int c, int cp, int hidden_p) {
  Layout L;
  L.lda = cp + 8;
  const size_t qkv = sizeof(bf16) * 3 * 2 * N * LDQ;  // q, k, v of two heads
  const size_t mid = sizeof(bf16) * N * LDT;          // one 64-wide MLP chunk
  size_t o = 0;
  L.a = o;    o += align128(sizeof(bf16) * N * L.lda);   // LN1 out | LN2 out
  L.attn = o; o += align128(sizeof(bf16) * N * L.lda);   // x window | attention out
  L.big = o;  o += align128(qkv > mid ? qkv : mid);      // q, k, v | MLP chunk
  L.ring = o; o += align128(sizeof(bf16) * STAGES * TILE * LDT);  // weight tiles
  L.vec = o;  o += align128(sizeof(float) * (V_B1 * c + hidden_p));  // LN params, biases
  L.red = o;  o += align128(sizeof(float) * 2 * N);      // LN2 partial row sums
  L.qmap = o; o += align128(sizeof(int) * 2 * DP);       // pair column -> q/k/v offset
  L.total = o;
  return L;
}

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

// LayerNorm of 64 rows of width C, one warp per row, two-pass fp32 statistics;
// writes bf16 rows of width CP with zeros in the padding columns.
template <typename Load>
__device__ __forceinline__ void layer_norm_rows(bf16* dst, int ldd, int C, int CP, Load load,
                                                const float* w, const float* b) {
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

// Attention of one head for the 16 query rows q0..q0+15 of this warp, all in
// registers: S = q k^T + bias (16 x 64, fp32), softmax over keys in fp32,
// P rounded to bf16, O = P v (16 x 32). Writes O[:, :hd] to out (bf16).
__device__ __forceinline__ void attention_rows(const bf16* qh, const bf16* kh, const bf16* vh,
                                               const float* bh, int q0, int hd, bf16* out,
                                               int ldo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  float s[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t) {  // the bias is the accumulator's starting value
    const float2 b0 = *reinterpret_cast<const float2*>(bh + (q0 + g) * N + t * 8 + tig * 2);
    const float2 b1 = *reinterpret_cast<const float2*>(bh + (q0 + g + 8) * N + t * 8 + tig * 2);
    s[t][0] = b0.x; s[t][1] = b0.y; s[t][2] = b1.x; s[t][3] = b1.y;
  }
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t fa[4];
    ldsm_x4(fa, qh + (q0 + (lane & 15)) * LDQ + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {  // keys np*16 .. np*16+15, k stored [token][d]
      uint32_t fb[4];
      ldsm_x4(fb, kh + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDQ + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], fa, fb[0], fb[1]);
      mma_bf16(s[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
  // this thread holds rows g (s[t][0..1]) and g+8 (s[t][2..3]); a row's 64
  // values live in the 4 lanes of its quad
  float m0 = s[0][0], m1 = s[0][2];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    m0 = fmaxf(m0, fmaxf(s[t][0], s[t][1]));
    m1 = fmaxf(m1, fmaxf(s[t][2], s[t][3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    s[t][0] = expf(s[t][0] - m0); s[t][1] = expf(s[t][1] - m0);
    s[t][2] = expf(s[t][2] - m1); s[t][3] = expf(s[t][3] - m1);
    l0 += s[t][0] + s[t][1];
    l1 += s[t][2] + s[t][3];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  float o[4][4] = {};
#pragma unroll
  for (int kb = 0; kb < N / 16; ++kb) {  // keys kb*16 .. kb*16+15 as the A operand
    const uint32_t pa[4] = {
        pack_bf16(s[2 * kb][0] / l0, s[2 * kb][1] / l0),
        pack_bf16(s[2 * kb][2] / l1, s[2 * kb][3] / l1),
        pack_bf16(s[2 * kb + 1][0] / l0, s[2 * kb + 1][1] / l0),
        pack_bf16(s[2 * kb + 1][2] / l1, s[2 * kb + 1][3] / l1),
    };
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t fb[4];
      ldsm_x4_trans(fb, vh + (kb * 16 + (lane & 15)) * LDQ + dp * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * dp], pa, fb[0], fb[1]);
      mma_bf16(o[2 * dp + 1], pa, fb[2], fb[3]);
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = t * 8 + tig * 2 + e;
      if (d < hd) {
        out[(q0 + g) * ldo + d] = __float2bfloat16(o[t][e]);
        out[(q0 + g + 8) * ldo + d] = __float2bfloat16(o[t][2 + e]);
      }
    }
  }
}

struct Tile {
  const bf16* w;  // weight matrix, (in, out) row-major
  int ldw, k0, kn, n0, nn;  // rows k0 .. k0+kn, columns n0 .. n0+nn
};

// Streams `steps` weight tiles (tile_of(s) says which) through the ring, one
// barrier each, and calls body(s, tile) once tile s has landed in shared
// memory; the copy of tile s+1 is in flight meanwhile. The barrier before
// each body also orders every shared-memory write of the previous bodies
// before the next one. Ends with a barrier.
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

// The warp's share of a 64 x 64 output tile: rows 16*(w & 3), columns
// 32*(w >> 2) (two 16-wide halves; `hi` says whether the second is live).
// acc += a[rows, 0 : 16*ksteps] . t[0 : 16*ksteps, columns].
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

// NCH = ceil(C / 64): the column chunks of the residual h held in registers.
template <int NCH>
__global__ void __launch_bounds__(THREADS, 2) swin_block_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(p.c, p.cp, p.hidden_p);
  bf16* abuf = reinterpret_cast<bf16*>(smem + L.a);
  bf16* attn = reinterpret_cast<bf16*>(smem + L.attn);
  bf16* qkv = reinterpret_cast<bf16*>(smem + L.big);
  bf16* mid = reinterpret_cast<bf16*>(smem + L.big);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  float* vec = reinterpret_cast<float*>(smem + L.vec);
  float* red = reinterpret_cast<float*>(smem + L.red);
  int* qmap = reinterpret_cast<int*>(smem + L.qmap);

  const int C = p.c, CP = p.cp, heads = p.heads, hd = p.hd, hidden = p.hidden;
  const int lda = L.lda;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 32, g = lane >> 2, tig = lane & 3;
  const int nkc = (CP + TILE - 1) / TILE;  // 64-row slices of a C-deep product
  const bf16* xw = p.x + (size_t)blockIdx.x * N * C;
  bf16* ow = p.out + (size_t)blockIdx.x * N * C;

  // q/k/v padding must read as zero; the window goes to the idle attention
  // buffer, the small vectors and the pair column map to theirs
  {
    uint4* z = reinterpret_cast<uint4*>(qkv);
    for (int i = tid; i < 3 * 2 * N * LDQ / 8; i += THREADS) z[i] = make_uint4(0u, 0u, 0u, 0u);
    const uint4* src = reinterpret_cast<const uint4*>(xw);
    uint4* dst = reinterpret_cast<uint4*>(attn);
    for (int i = tid; i < N * C / 8; i += THREADS) dst[i] = __ldg(src + i);
    const float* vsrc[] = {p.ln1_w, p.ln1_b, p.bqkv, p.bproj, p.ln2_w, p.ln2_b, p.b2};
    const int voff[] = {V_LN1W, V_LN1B, V_BQKV, V_BPROJ, V_LN2W, V_LN2B, V_B2};
    const int vlen[] = {C, C, 3 * C, C, C, C, C};
#pragma unroll
    for (int v = 0; v < 7; ++v)
      for (int i = tid; i < vlen[v]; i += THREADS) vec[voff[v] * C + i] = __ldg(vsrc[v] + i);
    for (int i = tid; i < hidden; i += THREADS) vec[V_B1 * C + i] = __ldg(p.b1 + i);
    for (int j = tid; j < 2 * hd; j += THREADS) qmap[j] = (j / hd) * N * LDQ + j % hd;
  }
  __syncthreads();

  // ---- LN1 -> abuf
  const bf16* xs = attn;
  layer_norm_rows(
      abuf, lda, C, CP, [&](int r, int c) { return __bfloat162float(xs[r * C + c]); },
      vec + V_LN1W * C, vec + V_LN1B * C);
  __syncthreads();
  // the attention output's padding columns are proj's zero k-rows: they must
  // read as zero, not as leftovers of the window staged here
  for (int i = tid; i < N * (CP - C); i += THREADS)
    attn[(i / (CP - C)) * lda + C + i % (CP - C)] = __float2bfloat16(0.f);

  // ---- QKV two heads at a time, each pair's attention right after it:
  // warps 0-3 take the first head, warps 4-7 the second; each warp owns 16
  // query rows -> attn columns head*hd .. head*hd+hd-1
  const float qscale = round_bf16(p.scale);
  for (int h0 = 0; h0 < heads; h0 += 2) {
    const int seg = min(2, heads - h0) * hd;  // columns of q (or k, or v) of the pair
    const bool lo = c0 < seg, hi = c0 + 16 < seg;
    float acc[4][4];
    pipeline(
        3 * nkc, ring,
        [&](int s) {
          const int which = s / nkc, kc = s - which * nkc;
          return Tile{p.wqkv, 3 * C, kc * TILE, min(TILE, C - kc * TILE), which * C + h0 * hd,
                      seg};
        },
        [&](int s, const bf16* t) {
          const int which = s / nkc, kc = s - which * nkc;
          if (kc == 0) {
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
          }
          if (!lo) return;
          mma_tile(acc, abuf + kc * TILE, lda, min(TILE, CP - kc * TILE) / 16, t, hi);
          if (kc != nkc - 1) return;
          const int base = which * C + h0 * hd;
          bf16* dst = qkv + which * 2 * N * LDQ;
          for_pairs(acc, 0, hi, [&](int r, int c, float v0, float v1) {
            const float v[2] = {v0, v1};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (c + e >= seg) continue;
              float y = round_bf16(v[e] + vec[V_BQKV * C + base + c + e]);
              if (which == 0) y *= qscale;
              dst[qmap[c + e] + r * LDQ] = __float2bfloat16(y);
            }
          });
        });
    const int head = h0 + (warp >> 2);
    if (head < heads)
      attention_rows(qkv + (size_t)(0 * 2 + (warp >> 2)) * N * LDQ,
                     qkv + (size_t)(1 * 2 + (warp >> 2)) * N * LDQ,
                     qkv + (size_t)(2 * 2 + (warp >> 2)) * N * LDQ, p.bias + (size_t)head * N * N,
                     r0, hd, attn + head * hd, lda);
  }

  // ---- proj into the register-resident residual: h = x + (attn @ wproj + bproj)
  float h[NCH][4][4];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < 4; ++i) h[ch][i][0] = h[ch][i][1] = h[ch][i][2] = h[ch][i][3] = 0.f;
  pipeline(
      NCH * nkc, ring,
      [&](int s) {
        const int ch = s / nkc, kc = s - ch * nkc;
        return Tile{p.wproj, C, kc * TILE, min(TILE, C - kc * TILE), ch * TILE,
                    min(TILE, C - ch * TILE)};
      },
      [&](int s, const bf16* t) {
        const int chunk = s / nkc, kc = s - chunk * nkc, nn = C - chunk * TILE;
        if (c0 >= nn) return;
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
          if (ch == chunk)
            mma_tile(h[ch], attn + kc * TILE, lda, min(TILE, CP - kc * TILE) / 16, t,
                     c0 + 16 < nn);
      });
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + 8 * half, col = ch * TILE + c0 + t * 8 + tig * 2;
        if (col < C) {  // col even, C a multiple of 4: both columns are real
          const unsigned xx = __ldg(reinterpret_cast<const unsigned*>(xw + r * C + col));
          const float2 x2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xx));
          h[ch][t][2 * half] = x2.x + (h[ch][t][2 * half] + vec[V_BPROJ * C + col]);
          h[ch][t][2 * half + 1] = x2.y + (h[ch][t][2 * half + 1] + vec[V_BPROJ * C + col + 1]);
        }
      }

  // ---- LN2 of h rounded to bf16 -> abuf; a row's values live in one quad
  // of each of two warps (w and w+4), partial sums meet in `red`
  {
    float mu[2] = {0.f, 0.f}, rstd[2];
    for (int pass = 0; pass < 2; ++pass) {
      float acc2[2] = {0.f, 0.f};
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = ch * TILE + c0 + t * 8 + tig * 2 + (e & 1);
            if (col < C) {
              const float v = round_bf16(h[ch][t][e]);
              acc2[e >> 1] += pass == 0 ? v : (v - mu[e >> 1]) * (v - mu[e >> 1]);
            }
          }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        acc2[half] += __shfl_xor_sync(0xffffffffu, acc2[half], 1);
        acc2[half] += __shfl_xor_sync(0xffffffffu, acc2[half], 2);
        if (tig == 0) red[(r0 + g + 8 * half) * 2 + (warp >> 2)] = acc2[half];
      }
      __syncthreads();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + 8 * half;
        const float tot = (red[r * 2] + red[r * 2 + 1]) / C;
        if (pass == 0) mu[half] = tot;
        else rstd[half] = rsqrtf(tot + 1e-5f);
      }
      __syncthreads();  // red is rewritten by the next pass
    }
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + g + 8 * (e >> 1);
          const int col = ch * TILE + c0 + t * 8 + tig * 2 + (e & 1);
          if (col < CP) {
            const float v = (round_bf16(h[ch][t][e]) - mu[e >> 1]) * rstd[e >> 1];
            abuf[r * lda + col] = __float2bfloat16(
                col < C ? v * vec[V_LN2W * C + col] + vec[V_LN2B * C + col] : 0.f);
          }
        }
  }

  // ---- MLP in 64-wide hidden chunks j: fc1 slice (nkc tiles of w1), GELU ->
  // mid, then mid @ w2[j rows] accumulated into h (NCH tiles of w2)
  {
    const int per = nkc + NCH;
    float acc[4][4];
    pipeline(
        ((hidden + TILE - 1) / TILE) * per, ring,
        [&](int s) {
          const int j = s / per, u = s - j * per;
          if (u < nkc)
            return Tile{p.w1, hidden, u * TILE, min(TILE, C - u * TILE), j * TILE,
                        min(TILE, hidden - j * TILE)};
          return Tile{p.w2, C, j * TILE, min(TILE, hidden - j * TILE), (u - nkc) * TILE,
                      min(TILE, C - (u - nkc) * TILE)};
        },
        [&](int s, const bf16* t) {
          const int j = s / per, u = s - j * per;
          if (u < nkc) {
            const int nn = min(TILE, hidden - j * TILE);
            if (u == 0) {
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
            }
            if (c0 >= nn) return;
            mma_tile(acc, abuf + u * TILE, lda, min(TILE, CP - u * TILE) / 16, t, c0 + 16 < nn);
            if (u != nkc - 1) return;
            for_pairs(acc, 0, c0 + 16 < nn, [&](int r, int c, float v0, float v1) {
              const float v[2] = {v0, v1};
#pragma unroll
              for (int e = 0; e < 2; ++e)
                mid[r * LDT + c + e] = __float2bfloat16(
                    c + e < nn ? gelu_tanh(v[e] + vec[V_B1 * C + j * TILE + c + e]) : 0.f);
            });
          } else {
            const int chunk = u - nkc, nn = C - chunk * TILE;
            if (c0 >= nn) return;
            const int ksteps = round16(min(TILE, hidden - j * TILE)) / 16;
#pragma unroll
            for (int ch = 0; ch < NCH; ++ch)
              if (ch == chunk) mma_tile(h[ch], mid, LDT, ksteps, t, c0 + 16 < nn);
          }
        });
  }

  // ---- out = h + mlp (+b2), rounded to bf16, straight from the registers
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + 8 * half, col = ch * TILE + c0 + t * 8 + tig * 2;
        if (col < C)
          *reinterpret_cast<__nv_bfloat162*>(ow + r * C + col) = __floats2bfloat162_rn(
              h[ch][t][2 * half] + vec[V_B2 * C + col],
              h[ch][t][2 * half + 1] + vec[V_B2 * C + col + 1]);
      }
}

template <int NCH>
cudaError_t launch(const Params& p, int bw, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(swin_block_kernel<NCH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  swin_block_kernel<NCH><<<bw, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. Returns a cudaError_t: the launch is
// asynchronous on `stream`, so 0 means the kernel was accepted, not finished.
// Weights are (in, out) row-major bf16; LN parameters, biases and the
// (heads, 64, 64) relative-position bias are fp32.
extern "C" int swin_block_bf16(const void* x, const void* ln1_w, const void* ln1_b,
                               const void* wqkv, const void* bqkv, const void* bias,
                               const void* wproj, const void* bproj, const void* ln2_w,
                               const void* ln2_b, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, int bw, int c, int heads, int hidden,
                               float scale, void* stream) {
  // a head pair's columns are copied in 4-element (8-byte) vectors
  const int hd = heads > 0 ? c / heads : 0;
  if (bw <= 0 || c <= 0 || c > MAX_C || c % 4 != 0 || heads <= 0 || c % heads != 0 ||
      hd > DP || hd % 2 != 0 || (heads % 2 != 0 && hd % 4 != 0) || hidden <= 0 ||
      hidden % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const void* aligned8[] = {wqkv, wproj, w1, w2, bias};
  for (const void* ptr : aligned8)
    if (reinterpret_cast<uintptr_t>(ptr) % 8 != 0) return (int)cudaErrorMisalignedAddress;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.ln1_w = static_cast<const float*>(ln1_w);
  p.ln1_b = static_cast<const float*>(ln1_b);
  p.wqkv = static_cast<const bf16*>(wqkv);
  p.bqkv = static_cast<const float*>(bqkv);
  p.bias = static_cast<const float*>(bias);
  p.wproj = static_cast<const bf16*>(wproj);
  p.bproj = static_cast<const float*>(bproj);
  p.ln2_w = static_cast<const float*>(ln2_w);
  p.ln2_b = static_cast<const float*>(ln2_b);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<bf16*>(out);
  p.c = c;
  p.cp = round16(c);
  p.heads = heads;
  p.hd = hd;
  p.hidden = hidden;
  p.hidden_p = round16(hidden);
  p.scale = scale;
  const size_t smem = make_layout(c, p.cp, p.hidden_p).total;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((c + TILE - 1) / TILE) {
    case 1: return (int)launch<1>(p, bw, smem, s);
    case 2: return (int)launch<2>(p, bw, smem, s);
    case 3: return (int)launch<3>(p, bw, smem, s);
    default: return (int)launch<4>(p, bw, smem, s);
  }
}

// Dynamic shared memory one block needs, for the wrapper's shape check.
extern "C" size_t swin_block_smem_bytes(int c, int heads, int hidden) {
  (void)heads;
  return make_layout(c, round16(c), round16(hidden)).total;
}
