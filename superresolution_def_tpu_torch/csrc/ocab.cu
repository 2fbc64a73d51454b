// K6: HAT's overlapping cross-attention block tail (OCAB, inference) for
// Hopper, bf16 in and out.
//
// Replaces the TPU kernel superresolution_def_tpu/kernels/ocab.py::
// fused_ocab_block (kernel body _make_ocab_kernel). One thread block computes
// one 8x8 query window end to end:
//
//   per head: softmax(bf16(q * scale) . k^T + bias[h]) . v   (64 queries
//             against the nk = 144 keys of the window's 12x12 overlap, fp32
//             softmax, probabilities rounded to bf16)
//   -> proj (+bproj) -> h = x + proj -> LN2 of bf16(h) -> fc1 -> tanh GELU
//   -> fc2 -> out = h + mlp
//
// LN1, the qkv product and the overlap gather stay outside (PyTorch), as
// the JAX package leaves them to XLA: the kernel reads the pre-gathered
// (Bw, 144, C) key and value windows. Keys of the overlap that fall outside
// the image are zero vectors from the gather's zero padding; they stay in the
// softmax with weight exp(bias), as in the reference. Key tiles past nk (none
// at nk = 144 = 9 x 16) are padded with -inf scores, never with zeros.
//
// The second half (proj, residual, LN2, MLP) is K1's (block_tail in
// swin_block_kernel.cuh), run with the weights zero-padded from C = 90 to 96
// by the wrapper while the windows keep their 90 columns and LN2 its
// statistics over them. q, k and v of two heads at a time are copied into
// shared memory, each head padded to 32 columns with zeros; warps 0-3 take
// the first head of the pair, warps 4-7 the second, 16 query rows each, with
// scores, softmax and probabilities in registers.
//
// What bounds it: 12.65 MFLOP per window (2 x 64 x 144 x 90 for QK^T and PV
// each, proj and the MLP) against the 2 x 144 x 90 bf16 keys and values, the
// query, shortcut and output windows it must read and write (86.4 KB per
// window): about 146 FLOP per byte, under the H100's ~295 FLOP/byte, so
// byte-bound at its peak; in this simple design latency-bound like K1.

#include "swin_block_kernel.cuh"

using namespace swin;

namespace {

constexpr int NKT = 9;           // key tiles of 16: nk <= 144
constexpr int NKP = 16 * NKT;    // key rows staged per head

struct OcabParams {
  Params p;         // x, proj / LN2 / MLP operands, out; c (padded), cio, heads, hidden
  const bf16* q;    // (bw, 64, cio)
  const bf16* k;    // (bw, nk, cio)
  const bf16* v;    // (bw, nk, cio)
  int nk;
};

struct OcabLayout {
  int lda;
  size_t a, attn, big, ring, vec, red, total;
};

__host__ __device__ inline OcabLayout ocab_layout(int c, int cp, int hidden_p) {
  OcabLayout L;
  L.lda = cp + 8;
  const size_t qkv = sizeof(bf16) * 2 * (N + 2 * NKP) * LDQ;  // q, k, v of two heads
  const size_t mid = sizeof(bf16) * N * LDT;
  size_t o = 0;
  L.a = o;    o += align128(sizeof(bf16) * N * L.lda);   // LN2 out
  L.attn = o; o += align128(sizeof(bf16) * N * L.lda);   // attention out
  L.big = o;  o += align128(qkv > mid ? qkv : mid);      // q, k, v | MLP chunk
  L.ring = o; o += align128(sizeof(bf16) * STAGES * TILE * LDT);
  L.vec = o;  o += align128(sizeof(float) * (V_B1 * c + hidden_p));
  L.red = o;  o += align128(sizeof(float) * 2 * N);
  L.total = o;
  return L;
}

template <int NCH>
__global__ void __launch_bounds__(THREADS, 2) ocab_kernel(const OcabParams op) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Params& p = op.p;
  const OcabLayout L = ocab_layout(p.c, p.cp, p.hidden_p);
  bf16* abuf = reinterpret_cast<bf16*>(smem + L.a);
  bf16* attn = reinterpret_cast<bf16*>(smem + L.attn);
  bf16* qb = reinterpret_cast<bf16*>(smem + L.big);  // [2][N][LDQ]
  bf16* kb = qb + 2 * N * LDQ;                       // [2][NKP][LDQ]
  bf16* vb = kb + 2 * NKP * LDQ;                     // [2][NKP][LDQ]
  bf16* mid = reinterpret_cast<bf16*>(smem + L.big);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  float* vec = reinterpret_cast<float*>(smem + L.vec);
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int C = p.c, CP = p.cp, CIO = p.cio, heads = p.heads, hd = p.hd, nk = op.nk;
  const int tid = threadIdx.x, warp = tid >> 5;
  const size_t win = (size_t)blockIdx.x * N * CIO;
  const size_t kwin = (size_t)blockIdx.x * nk * CIO;

  {  // zeros under the head padding and past nk; the vectors the tail reads
    uint4* z = reinterpret_cast<uint4*>(qb);
    for (int i = tid; i < 2 * (N + 2 * NKP) * LDQ / 8; i += THREADS)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    const float* vsrc[] = {p.bproj, p.ln2_w, p.ln2_b, p.b2};
    const int voff[] = {V_BPROJ, V_LN2W, V_LN2B, V_B2};
#pragma unroll
    for (int v = 0; v < 4; ++v)
      for (int i = tid; i < C; i += THREADS) vec[voff[v] * C + i] = __ldg(vsrc[v] + i);
    for (int i = tid; i < p.hidden; i += THREADS) vec[V_B1 * C + i] = __ldg(p.b1 + i);
    for (int i = tid; i < N * (CP - CIO); i += THREADS)  // proj's zero k-rows read zeros
      attn[(i / (CP - CIO)) * L.lda + CIO + i % (CP - CIO)] = __float2bfloat16(0.f);
  }

  const float qscale = round_bf16(p.scale);
  for (int h0 = 0; h0 < heads; h0 += 2) {
    __syncthreads();  // the previous pair's q/k/v are consumed
    const int seg = min(2, heads - h0) * hd;
    for (int i = tid; i < N * seg; i += THREADS) {
      const int r = i / seg, j = i - r * seg, hh = j / hd, d = j - hh * hd;
      const float y = __bfloat162float(op.q[win + r * CIO + h0 * hd + j]) * qscale;
      qb[(hh * N + r) * LDQ + d] = __float2bfloat16(y);  // q * scale rounded, as the io dtype does
    }
    for (int i = tid; i < nk * seg; i += THREADS) {
      const int r = i / seg, j = i - r * seg, hh = j / hd, d = j - hh * hd;
      const size_t src = kwin + (size_t)r * CIO + h0 * hd + j;
      kb[(hh * NKP + r) * LDQ + d] = op.k[src];
      vb[(hh * NKP + r) * LDQ + d] = op.v[src];
    }
    __syncthreads();
    const int hh = warp >> 2, head = h0 + hh;
    if (head < heads)
      attention_rows<NKT>(qb + hh * N * LDQ, kb + hh * NKP * LDQ, vb + hh * NKP * LDQ,
                          p.bias + (size_t)head * N * nk, nullptr, nk, (warp & 3) * 16, hd,
                          attn + head * hd, L.lda);
  }
  // block_tail's first pipeline step synchronises before it reads attn
  block_tail<NCH, false, false>(p, L.lda, abuf, attn, mid, ring, vec, red, p.x + win,
                                p.out + win, win);
}

template <int NCH>
cudaError_t launch(const OcabParams& op, int bw, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ocab_kernel<NCH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ocab_kernel<NCH><<<bw, THREADS, smem, stream>>>(op);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes; returns a cudaError_t. x, q and out are
// (bw, 64, cio) bf16, k and v (bw, nk, cio) bf16, bias (heads, 64, nk) fp32;
// wproj (c, c), w1 (c, hidden), w2 (hidden, c) bf16 and the vectors fp32,
// zero-padded from cio to c.
extern "C" int ocab_block_bf16(const void* x, const void* q, const void* k, const void* v,
                               const void* bias, const void* wproj, const void* bproj,
                               const void* ln2_w, const void* ln2_b, const void* w1,
                               const void* b1, const void* w2, const void* b2, void* out, int bw,
                               int nk, int c, int cio, int heads, int hidden, float scale,
                               void* stream) {
  const int hd = heads > 0 ? cio / heads : 0;
  if (bw <= 0 || nk <= 0 || nk > NKP || nk % 2 != 0 || c <= 0 || c > MAX_C || c % 4 != 0 ||
      cio <= 0 || cio > c || cio % 2 != 0 || heads <= 0 || cio % heads != 0 || hd > DP ||
      hidden <= 0 || hidden % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const void* aligned8[] = {wproj, w1, w2, bias};
  for (const void* ptr : aligned8)
    if (reinterpret_cast<uintptr_t>(ptr) % 8 != 0) return (int)cudaErrorMisalignedAddress;
  if (reinterpret_cast<uintptr_t>(x) % 4 != 0) return (int)cudaErrorMisalignedAddress;
  OcabParams op = {};
  Params& p = op.p;
  p.x = static_cast<const bf16*>(x);
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
  p.cio = cio;
  p.heads = heads;
  p.hd = hd;
  p.hidden = hidden;
  p.hidden_p = round16(hidden);
  p.scale = scale;
  op.q = static_cast<const bf16*>(q);
  op.k = static_cast<const bf16*>(k);
  op.v = static_cast<const bf16*>(v);
  op.nk = nk;
  const size_t smem = ocab_layout(c, p.cp, p.hidden_p).total;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((c + TILE - 1) / TILE) {
    case 1: return (int)launch<1>(op, bw, smem, s);
    case 2: return (int)launch<2>(op, bw, smem, s);
    case 3: return (int)launch<3>(op, bw, smem, s);
    default: return (int)launch<4>(op, bw, smem, s);
  }
}

// Dynamic shared memory one block needs at padded width c.
extern "C" size_t ocab_block_smem_bytes(int c, int hidden) {
  return ocab_layout(c, round16(c), round16(hidden)).total;
}
