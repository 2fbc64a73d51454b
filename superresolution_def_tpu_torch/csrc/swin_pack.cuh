// The weight packings of the Swin-block kernels on wgmma, shared by K3/K9b
// and K4/K9c (swin_block_train.cu), which pack once per call for their
// window kernels, and by K2 (swin_fwd_wg.cuh), which streams the same tiles
// forward: mlp_pack_kernel (w1 and w2 per 64-wide hidden chunk) and
// attn_pack_kernel (wproj, wq, wk, wv per head), both in the interleaved
// layout hopper.cuh describes, and kmaj, the byte offset of an element of a
// 64-row K-major operand in that layout. Also the OCAB kernels' head gather
// (K6/K10a in swin_fwd_wg.cuh, K10b in ocab_train.cu, K11 in
// window_attention.cu): fetch_head and scaled_q.

#pragma once

#include "swin_common.cuh"

namespace {

using namespace swin;

// byte offset of (row r, column k) in a 64-row operand of ck columns stored
// K-major interleaved: 8 x 8 core matrices, K-adjacent ones 128 bytes apart
__device__ __forceinline__ int kmaj(int r, int k, int ck) {
  return (r >> 3) * ck * 16 + (k >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2;
}

// The packed weights: per 64-wide hidden chunk j, two tiles of ck x 64 bf16,
// w1[:, j] then w2[j, :]^T, element (c, jj) at byte (c/8) 1024 + (jj/8) 128 +
// (c%8) 16 + (jj%8) 2 (zero past C and hidden). One tile serves u = hn . w1
// as its MN-major B and dhn = du . w1^T as its K-major B.
__global__ void mlp_pack_kernel(const bf16* w1, const bf16* w2, int C, int hidden, int ck,
                                bf16* out) {
  const long long per = 2LL * ck * 64, total = per * ((hidden + 63) / 64);
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(idx / per), rem = (int)(idx - j * per), which = rem / (ck * 64);
    const int e = rem - which * ck * 64, r = e & 511;
    const int c = (e >> 9) * 8 + ((r & 63) >> 3), hcol = j * 64 + (r >> 6) * 8 + (r & 7);
    bf16 v = __float2bfloat16(0.f);
    if (c < C && hcol < hidden) v = which == 0 ? w1[(size_t)c * hidden + hcol] : w2[(size_t)hcol * C + c];
    out[idx] = v;
  }
}

// The packed weights, per head h four tiles of ck x hp bf16: wproj[h, :]^T,
// then the head's columns of wq, wk and wv; element (c, j) at byte (c/8)
// hp*16 + (j/8) 128 + (c%8) 16 + (j%8) 2, zero past C and the head's hd
// columns. One tile serves the recompute (xn . wq[:, h], MN-major B) and
// dxn += dq_h . wq[:, h]^T (K-major B); wproj's serves do_h = dhs .
// wproj[h, :]^T (MN-major B).
__global__ void attn_pack_kernel(const bf16* wqkv, const bf16* wproj, int C, int heads, int ck,
                                 int hp, bf16* out) {
  const int hd = C / heads;
  const long long per = (long long)ck * hp, total = per * 4 * heads;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int t = (int)(idx / per), e = (int)(idx - t * per);
    const int h = t >> 2, which = t & 3;
    const int cg = e / (hp * 8), rem = e - cg * hp * 8;
    const int c = cg * 8 + ((rem & 63) >> 3), j = (rem >> 6) * 8 + (rem & 7);
    bf16 v = __float2bfloat16(0.f);
    if (c < C && j < hd) {
      const int col = h * hd + j;
      v = which == 0 ? wproj[(size_t)col * C + c] : wqkv[(size_t)c * 3 * C + (which - 1) * C + col];
    }
    out[idx] = v;
  }
}

// 4-byte asynchronous global -> shared copy of the first `bytes` (0, 2 or
// 4) of src, zero-filling the rest; src 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// `total` rows x hp slots of one head into the interleaved layout by NT
// threads (pt: this thread's index): slot pair (2s, 2s + 1) from columns
// base + 2s, + 1 of each row, columns from `lim` on and rows from `rows` on
// read as zero; with TAIL, lim may be odd, and a pair whose second column
// is at lim copies 2 bytes (K11: a head's last column; the OCAB kernels'
// lim is the row's even width). A head whose first column is odd takes base
// one column before it and lands at slots 1 .. hd; every copy is 4-byte
// aligned, so ld and base are even. A thread keeps one slot pair and walks
// the rows NT / (hp / 2) apart.
template <int HP, int NT, bool TAIL = false>
__device__ __forceinline__ void fetch_head(unsigned char* dst, const bf16* src, int rows,
                                           int total, int ld, int base, int lim, int pt) {
  static_assert(NT % (HP / 2) == 0, "a thread keeps one slot pair");
  const int s = 2 * (pt % (HP / 2)), col = base + s;
  const bool in_row = col < lim;
  const int bytes = TAIL && col + 1 >= lim ? 2 : 4;
  for (int r = pt / (HP / 2); r < total; r += NT / (HP / 2)) {
    const bool ok = in_row && r < rows;
    cp_async4(dst + kmaj(r, s, HP), ok ? src + (size_t)r * ld + col : src, ok ? bytes : 0);
  }
}

// bf16(q * s) of a packed pair of q's slots `slot`, +1, zero outside the
// head's [o, o + hd): the scores' A operand
__device__ __forceinline__ uint32_t scaled_q(uint32_t v, float s, int slot, int o, int hd) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  const bool lo = slot >= o && slot < o + hd, hi = slot + 1 >= o && slot + 1 < o + hd;
  return pack_bf16(lo ? f.x * s : 0.f, hi ? f.y * s : 0.f);
}

}  // namespace
