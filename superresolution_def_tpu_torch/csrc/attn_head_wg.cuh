// One head's window attention on wgmma for one consumer warpgroup: the
// scores' starting value (the bias, plus a mask, -inf past nk), then
//
//   ov = bf16(softmax_fp32(bf16(q * scale) . k^T + start)) . v   (fp32 ov)
//
// for the 64 query rows of a window against NK staged key rows. Shared by
// the OCAB mode of swin_fwd_wg.cuh's body (K6, K10a: NK = 144) and by K11's
// bf16 kernel (window_attention.cu: NK = 64 or 144); both stage one head's
// q (64 x HP), k and v (NK x HP each) K-major interleaved at HP slots by
// fetch_head (swin_pack.cuh), the head's hd columns at slots o .. o + hd - 1
// (o = 1 for a head whose first column is 2-byte but not 4-byte aligned).
//
// Warp w of the warpgroup holds rows r0 = 16 w + g and + 8 (g = lane >> 2)
// in the accumulator layout hopper.cuh describes: a row's keys lie in the
// four lanes of one quad, so the softmax reduces by two shuffles.

#pragma once

#include "hopper.cuh"
#include "swin_pack.cuh"

namespace {

// o (m64 x hp) += P . v, P from registers, v MN-major
template <int HP>
__device__ __forceinline__ void fwd_mma_pv(float (&d)[HP / 2], const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (HP == 16) hopper::wgmma_n16_rs<hopper::MNMAJ>(d, a, db, 1);
  else hopper::wgmma_n32_rs<hopper::MNMAJ>(d, a, db, 1);
}

// The scores' starting value for the thread's rows r0 + g and + 8: the bias
// (64 rows of ldb fp32, in device memory, or in shared memory where
// BIAS_SMEM), plus the mask (64, nk) fp32 in device memory where it is not
// null, -inf past nk. Both are read as float2 (nk and ldb even, rows 8-byte
// aligned).
template <int NK, bool BIAS_SMEM = false>
__device__ __forceinline__ void head_scores_start(float (&d)[NK / 2], const float* bias, int ldb,
                                                  const float* mask, int nk, int r0, int g,
                                                  int t4) {
  const float ninf = -__int_as_float(0x7f800000);
  auto ld2 = [](const float* a) {
    if constexpr (BIAS_SMEM) return *reinterpret_cast<const float2*>(a);
    else return __ldg(reinterpret_cast<const float2*>(a));
  };
#pragma unroll
  for (int t = 0; t < NK / 8; ++t) {
    const int c = 8 * t + 2 * t4;
    if (c < nk) {
      float2 b0 = ld2(bias + (r0 + g) * ldb + c);
      float2 b1 = ld2(bias + (r0 + g + 8) * ldb + c);
      if (mask != nullptr) {
        const float2 m0 = __ldg(reinterpret_cast<const float2*>(mask + (r0 + g) * nk + c));
        const float2 m1 = __ldg(reinterpret_cast<const float2*>(mask + (r0 + g + 8) * nk + c));
        b0.x += m0.x;
        b0.y += m0.y;
        b1.x += m1.x;
        b1.y += m1.y;
      }
      d[4 * t] = b0.x; d[4 * t + 1] = b0.y; d[4 * t + 2] = b1.x; d[4 * t + 3] = b1.y;
    } else {
      d[4 * t] = d[4 * t + 1] = d[4 * t + 2] = d[4 * t + 3] = ninf;
    }
  }
}

// The attention of one staged head (q_h, k_h, v_h) for the warpgroup's 64
// rows: s holds the scores' starting value on entry (head_scores_start) and
// is consumed; ov gets P . v in fp32 at the HP slots. q's copy is scaled,
// rounded to bf16 and masked to zero outside the head's slots [o, o + hd)
// (scaled_q), so whatever k's padding slots hold meets an exact zero. The
// scores (m64 x nNK, q's fragments from registers) take the bias as the
// accumulator's start; the softmax is fp32 with the hardware exponential and
// one reciprocal a row (a masked score exps to a denormal, and dividing it
// takes the division's slow path); every k16 step's P is packed before the
// P . v products (A registers written between two of them would cost a
// fence each).
template <int NK, int HP>
__device__ __forceinline__ void head_attention(float (&ov)[HP / 2], float (&s)[NK / 2],
                                               const unsigned char* q_h,
                                               const unsigned char* k_h,
                                               const unsigned char* v_h, float qscale, int o,
                                               int hd, int r0, int lane) {
  using namespace hopper;
  static_assert(NK == 64 || NK == 144, "the scores' wgmma: n64 or n144");
  constexpr int CGS = HP * 16;
  const int t4 = lane & 3;
  uint32_t fq[HP / 16][4];
#pragma unroll
  for (int kk = 0; kk < HP / 16; ++kk) {
    ldsm_x4(fq[kk], reinterpret_cast<const bf16*>(
                        q_h + kmaj(r0 + (lane & 15), kk * 16 + (lane >> 4) * 8, HP)));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      fq[kk][e] = scaled_q(fq[kk][e], qscale, kk * 16 + 2 * t4 + (e >> 1) * 8, o, hd);
  }
  fence_regs(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HP / 16; ++kk) {
    if constexpr (NK == 144) wgmma_n144_rs<KMAJ>(s, fq[kk], desc(k_h + kk * 256, 128, CGS), 1);
    else wgmma_n64_rs<KMAJ>(s, fq[kk], desc(k_h + kk * 256, 128, CGS), 1);
  }
  wg_commit();
  wg_wait<0>();
  fence_regs(s);
  // softmax over the keys of rows r0 + g and r0 + g + 8, fp32 (the hardware
  // exponential), one reciprocal a row
  float m0 = s[0], m1 = s[2];
#pragma unroll
  for (int t = 0; t < NK / 8; ++t) {
    m0 = fmaxf(m0, fmaxf(s[4 * t], s[4 * t + 1]));
    m1 = fmaxf(m1, fmaxf(s[4 * t + 2], s[4 * t + 3]));
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, sh));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, sh));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int t = 0; t < NK / 8; ++t) {
    s[4 * t] = __expf(s[4 * t] - m0);
    s[4 * t + 1] = __expf(s[4 * t + 1] - m0);
    s[4 * t + 2] = __expf(s[4 * t + 2] - m1);
    s[4 * t + 3] = __expf(s[4 * t + 3] - m1);
    l0 += s[4 * t] + s[4 * t + 1];
    l1 += s[4 * t + 2] + s[4 * t + 3];
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  uint32_t pa[NK / 16][4];
#pragma unroll
  for (int kb = 0; kb < NK / 16; ++kb) {
    pa[kb][0] = pack_bf16(s[8 * kb] * i0, s[8 * kb + 1] * i0);
    pa[kb][1] = pack_bf16(s[8 * kb + 2] * i1, s[8 * kb + 3] * i1);
    pa[kb][2] = pack_bf16(s[8 * kb + 4] * i0, s[8 * kb + 5] * i0);
    pa[kb][3] = pack_bf16(s[8 * kb + 6] * i1, s[8 * kb + 7] * i1);
  }
#pragma unroll
  for (int i = 0; i < HP / 2; ++i) ov[i] = 0.f;
  fence_regs(ov);
  wg_fence();
#pragma unroll
  for (int kb = 0; kb < NK / 16; ++kb)
    fwd_mma_pv<HP>(ov, pa[kb], desc(v_h + kb * 2 * CGS, CGS, 128));
  wg_commit();
  wg_wait<0>();
  fence_regs(ov);
}

}  // namespace
