// K11: standalone multi-head window attention for Hopper, the JAX package's
// opt-in attn_impl="pallas" core of every attention module (SwinIR's and
// HAB's windows, OCAB's overlapping windows):
//
//   out[b, h] = softmax(q[b, h] * scale . k[b, h]^T + bias[h] (+ mask[b % nW])) . v[b, h]
//
// for q (Bw, heads, 64, d) and k, v (Bw, heads, nk, d), nk <= 144, d <= 32.
//
// Replaces the TPU kernels of superresolution_def_tpu/kernels/window_attention.py:
// _attention_pallas_allheads (K11a, body _fused_kernel_allheads: no mask,
// all heads of a block of windows per grid step), _attention_pallas with a
// mask (K11b, body _fused_kernel) and without one (K11c, body
// _fused_kernel_nomask: K11a's function on a (windows, heads) grid). The
// TPU grid order is all that tells K11a from K11c, so both map to the
// HAS_MASK = false instantiation here; K11b to HAS_MASK = true.
//
// Rounding points follow the Pallas kernels, not the XLA path: q * scale in
// q's dtype (scale rounded to it first, as JAX's weak-typed scalar is);
// scores q.k^T accumulated in fp32; bias and mask added in fp32; softmax in
// fp32; probabilities cast to v's dtype; P.V accumulated in fp32 and cast.
//
// Design. One thread block (8 warps) takes one window and walks its heads.
// bf16: two heads at a time, as K6's first design did: q (scaled, rounded), k
// and v of the pair are copied into shared memory, each head's d columns
// padded to 32 with zeros (the padding is zeroed once and never written,
// so the QK^T k-steps past d add exact zeros) and its keys padded to a
// multiple of 16 rows; warps 0-3 run the first head's 64 query rows, 16 a
// warp, warps 4-7 the second's, through attention_rows
// (swin_block_kernel.cuh): mma.sync m16n8k16 products with ldmatrix
// operands, scores, softmax and probabilities in registers (72 fp32 scores
// a thread at nk = 144), the output's d real columns written straight to
// device memory (the padded columns never are). fp32: one head at a time
// on the CUDA cores, q, k and v in shared memory, one warp per query row:
// lane j holds the scores of keys j, j+32, ..., and lane d sums P.V's
// column d. The mask is read as mask[b % nW] from the one (nW, 64, nk)
// tensor (4 MB at nW = 256, resident in L2), never tiled over the batch.
// q, k and v are read through their strides, so the modules' permuted
// views of the qkv product go in as they are, with no copy.
//
// What bounds it: 4 * 64 * nk * d FLOP per window and head against the
// bf16 q, k, v and output it must move: at d = 30, nk = 64 that is 15
// FLOP per byte, far under the H100's ~295, so byte-bound (Bw = 768,
// 6 heads: 71 MB, 0.021 ms at 3.35 TB/s). This first design reads q, k and
// v element by element (2-byte loads, coalesced only within a head pair's
// contiguous columns), with no copy overlapping the products.

#include "swin_block_kernel.cuh"

using namespace swin;

namespace {

constexpr int MAX_KEYS = 144;  // 9 key tiles of 16
constexpr int LDF = DP + 1;    // fp32 row stride: lanes on distinct banks

struct AttnParams {
  const void* q;
  const void* k;
  const void* v;
  long long sq[4], sk[4], sv[4];  // element strides of (Bw, heads, rows, d)
  const float* bias;              // (heads, 64, nk)
  const float* mask;              // (nw, 64, nk), or null
  void* out;                      // (Bw, heads, 64, d), contiguous
  int heads, hd, nk, nw;
  float scale;
};

template <typename T>
__device__ __forceinline__ float at(const void* base, const long long (&s)[4], long long b, int h,
                                    int r, int d) {
  return static_cast<float>(
      static_cast<const T*>(base)[b * s[0] + h * s[1] + r * s[2] + d * s[3]]);
}

template <>
__device__ __forceinline__ float at<bf16>(const void* base, const long long (&s)[4], long long b,
                                          int h, int r, int d) {
  return __bfloat162float(
      static_cast<const bf16*>(base)[b * s[0] + h * s[1] + r * s[2] + d * s[3]]);
}

size_t smem_bf16(int nkt) { return sizeof(bf16) * 2 * (N + 2 * 16 * nkt) * LDQ; }

size_t smem_f32() { return sizeof(float) * ((N + 2 * MAX_KEYS) * LDF + NWARPS * MAX_KEYS); }

template <int NKT, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS) attn_bf16_kernel(const AttnParams p) {
  constexpr int NKP = 16 * NKT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qb = reinterpret_cast<bf16*>(smem);  // [2][N][LDQ]
  bf16* kb = qb + 2 * N * LDQ;               // [2][NKP][LDQ]
  bf16* vb = kb + 2 * NKP * LDQ;             // [2][NKP][LDQ]
  const int tid = threadIdx.x, warp = tid >> 5;
  const int heads = p.heads, hd = p.hd, nk = p.nk;
  const long long b = blockIdx.x;

  {  // zeros under the head padding and past nk, written once
    uint4* z = reinterpret_cast<uint4*>(qb);
    for (int i = tid; i < 2 * (N + 2 * NKP) * LDQ / 8; i += THREADS)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  const float qscale = round_bf16(p.scale);
  const float* mh = HAS_MASK ? p.mask + (size_t)(b % p.nw) * N * nk : nullptr;
  bf16* out = static_cast<bf16*>(p.out) + (size_t)b * heads * N * hd;
  for (int h0 = 0; h0 < heads; h0 += 2) {
    __syncthreads();  // the zeros, or the previous pair's readers, are done
    const int seg = min(2, heads - h0) * hd;
    for (int i = tid; i < N * seg; i += THREADS) {
      const int r = i / seg, j = i - r * seg, hh = j / hd, d = j - hh * hd;
      const float y = at<bf16>(p.q, p.sq, b, h0 + hh, r, d) * qscale;
      qb[(hh * N + r) * LDQ + d] = __float2bfloat16(y);  // q * scale rounded, as bf16 does
    }
    for (int i = tid; i < nk * seg; i += THREADS) {
      const int r = i / seg, j = i - r * seg, hh = j / hd, d = j - hh * hd;
      kb[(hh * NKP + r) * LDQ + d] = __float2bfloat16(at<bf16>(p.k, p.sk, b, h0 + hh, r, d));
      vb[(hh * NKP + r) * LDQ + d] = __float2bfloat16(at<bf16>(p.v, p.sv, b, h0 + hh, r, d));
    }
    __syncthreads();
    const int hh = warp >> 2, head = h0 + hh;
    if (head < heads)
      attention_rows<NKT>(qb + hh * N * LDQ, kb + hh * NKP * LDQ, vb + hh * NKP * LDQ,
                          p.bias + (size_t)head * N * nk, mh, nk, (warp & 3) * 16, hd,
                          out + (size_t)head * N * hd, hd);
  }
}

template <bool HAS_MASK>
__global__ void __launch_bounds__(THREADS) attn_f32_kernel(const AttnParams p) {
  constexpr int KPL = (MAX_KEYS + 31) / 32;  // keys a lane scores
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [N][LDF]
  float* ks = qs + N * LDF;                    // [MAX_KEYS][LDF]
  float* vs = ks + MAX_KEYS * LDF;             // [MAX_KEYS][LDF]
  float* ps = vs + MAX_KEYS * LDF;             // [NWARPS][MAX_KEYS] one row's probabilities
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int heads = p.heads, hd = p.hd, nk = p.nk;
  const long long b = blockIdx.x;
  const float* mw = HAS_MASK ? p.mask + (size_t)(b % p.nw) * N * nk : nullptr;
  float* out = static_cast<float*>(p.out) + (size_t)b * heads * N * hd;
  float* pw = ps + warp * MAX_KEYS;
  for (int head = 0; head < heads; ++head) {
    __syncthreads();  // the previous head's readers are done
    for (int i = tid; i < N * hd; i += THREADS) {
      const int r = i / hd, d = i - r * hd;
      qs[r * LDF + d] = at<float>(p.q, p.sq, b, head, r, d) * p.scale;
    }
    for (int i = tid; i < nk * hd; i += THREADS) {
      const int r = i / hd, d = i - r * hd;
      ks[r * LDF + d] = at<float>(p.k, p.sk, b, head, r, d);
      vs[r * LDF + d] = at<float>(p.v, p.sv, b, head, r, d);
    }
    __syncthreads();
    const float* bh = p.bias + (size_t)head * N * nk;
    for (int r = warp; r < N; r += NWARPS) {
      const float neg_inf = -__int_as_float(0x7f800000);
      float s[KPL];
      float m = neg_inf;
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int j = lane + 32 * t;
        s[t] = neg_inf;
        if (j < nk) {
          float acc = 0.f;
          for (int d = 0; d < hd; ++d) acc = fmaf(qs[r * LDF + d], ks[j * LDF + d], acc);
          acc += bh[r * nk + j];
          if (HAS_MASK) acc += mw[r * nk + j];
          s[t] = acc;
        }
        m = fmaxf(m, s[t]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float l = 0.f;
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        s[t] = lane + 32 * t < nk ? expf(s[t] - m) : 0.f;
        l += s[t];
      }
      l = warp_sum(l);
#pragma unroll
      for (int t = 0; t < KPL; ++t)
        if (lane + 32 * t < nk) pw[lane + 32 * t] = s[t] / l;
      __syncwarp();
      if (lane < hd) {
        float o = 0.f;
        for (int j = 0; j < nk; ++j) o = fmaf(pw[j], vs[j * LDF + lane], o);
        out[((size_t)head * N + r) * hd + lane] = o;
      }
      __syncwarp();  // the row's probabilities are read before the next row's land
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const AttnParams& p, int bw, size_t smem, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<bw, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool HAS_MASK>
cudaError_t dispatch(const AttnParams& p, int bw, bool is_bf16, cudaStream_t stream) {
  if (!is_bf16) return launch(attn_f32_kernel<HAS_MASK>, p, bw, smem_f32(), stream);
  if (p.nk <= 64) return launch(attn_bf16_kernel<4, HAS_MASK>, p, bw, smem_bf16(4), stream);
  return launch(attn_bf16_kernel<MAX_KEYS / 16, HAS_MASK>, p, bw, smem_bf16(MAX_KEYS / 16),
                stream);
}

}  // namespace

// C entry point, bound with ctypes; returns a cudaError_t. q (bw, heads, nq,
// hd) and k, v (bw, heads, nk, hd), bf16 when is_bf16 else fp32, addressed
// through strides[12] (q's four element strides, then k's, then v's); bias
// (heads, nq, nk) fp32; mask (nw, nq, nk) fp32 or null; out (bw, heads, nq,
// hd) contiguous, in q's dtype. Takes nq = 64, hd <= 32, even nk <= 144.
extern "C" int window_attention_run(const void* q, const void* k, const void* v,
                                    const long long* strides, const void* bias, const void* mask,
                                    void* out, int bw, int heads, int nq, int nk, int hd, int nw,
                                    float scale, int is_bf16, void* stream) {
  if (bw <= 0 || heads <= 0 || nq != N || hd <= 0 || hd > DP || nk <= 0 || nk > MAX_KEYS ||
      nk % 2 != 0 || (mask != nullptr && (nw <= 0 || bw % nw != 0)))
    return (int)cudaErrorInvalidValue;
  // the bf16 path reads bias and mask rows as float2
  if (reinterpret_cast<uintptr_t>(bias) % 8 != 0 || reinterpret_cast<uintptr_t>(mask) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  AttnParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  for (int i = 0; i < 4; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[4 + i];
    p.sv[i] = strides[8 + i];
  }
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.out = out;
  p.heads = heads;
  p.hd = hd;
  p.nk = nk;
  p.nw = nw;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(mask != nullptr ? dispatch<true>(p, bw, is_bf16 != 0, s)
                               : dispatch<false>(p, bw, is_bf16 != 0, s));
}
