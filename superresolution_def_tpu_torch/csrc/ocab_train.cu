// K10b: the backward of HAT's OCAB cross-attention for Hopper, bf16 in and
// out, fp32 sums.
//
// Replaces the TPU kernel superresolution_def_tpu/kernels/ocab_train.py::
// _ocab_bwd_attn (kernel body _make_ocab_bwd_attn_kernel, its per-head
// branch). The OCAB tail is h = x + proj(cross_attn(q, k, v, bias)); the
// MLP's backward is K9b's (swin_block_train.cu, unit scale) and dx = dh is
// the caller's. From the saved q (64 queries) and the pre-gathered k and v
// (nk <= 144 keys of the 12x12 overlap) of each window and dh, it computes
//
//   do = bf16(dh . wproj^T)
//   per head: a = softmax(bf16(q * scale) . k^T + bias[h]) (recomputed, fp32;
//             the out-of-image keys are zero vectors that stay in it, as in
//             the forward), da = do . v^T, ds = a * (da - rowsum(da * a)),
//             dq = bf16(ds) . k * scale, dk = bf16(ds)^T . q * scale,
//             dv = bf16(a)^T . do
//
// and writes dq (Bw, 64, C), dk and dv (Bw, nk, C) per window (the gather's
// backward outside sums the overlaps and drops the out-of-image rows), the
// bf16 attention output and dh at the padded width for the weight-gradient
// product dWproj = att^T . dh, which runs in swin_block_train.cu's wgrad
// kernel, and per block the sums of its windows' ds (the bias gradient) and
// of their dh's columns (dbproj), which one ordered column sum over the
// blocks (swin_block_train.cu's colsum kernel) finishes. Every sum runs in
// a fixed order, with no atomics: two runs give the same bits.
//
// Design. Persistent blocks, one an SM, each over a fixed run of wpb
// consecutive windows (the wrapper's wpb = ceil(Bw / SMs)). A block walks
// the heads two at a time outside its windows: consumer warpgroup j takes
// head 2 pass + j of every window, so the running sum of that head's ds
// over the block's windows (64 x 144 fp32) stays in its registers, in the
// layout the products leave ds in, and leaves once per pass as the
// block's partial. A producer warpgroup brings each window's two heads of
// q, k and v (zero past nk) and all of dh into a two-stage ring under
// mbarriers by 4-byte cp.async straight into the wgmma operand layouts,
// the heads split there: head h's hd columns land at slots o .. o + hd - 1
// of its 16 (or 32) with o = (h hd) & 1, so every copy is 4-byte aligned;
// the other slots hold zeros or neighbouring columns, which meet exact
// zeros (q's masked copy, do's zero weight rows) or feed outputs nobody
// stores. The next window lands while this one computes. Per head and
// window, all on wgmma (m64 rows = the 64 queries): do (K = C padded to
// 16), the scores with the bias as the accumulator's start (A = bf16(q *
// scale) from registers, N = 144), the softmax with one reciprocal a row,
// the attention output (A = bf16(a) from registers), da in three 48-key
// thirds twice (once for rowsum(da * a), once for ds; a and the ds sum
// keep 144 registers, so da is recomputed rather than held), dq from ds in
// registers, and dk and dv as three m64 tiles of keys (144 padded to 192)
// with A = bf16(ds)^T and bf16(a)^T read transposed from shared memory: the
// four warps share every key tile evenly, where mma.sync's nine 16-key
// tiles split 3/2/2/2 over them. A pass's dq, dk, dv and attention output
// are staged dense in the window's ring stage once both consumers are done
// with it, and the producer writes them out, as 4-byte runs of each row's
// columns of the pair, while the consumers compute the next window.
//
// What bounds it: at C = 90, six heads of 15, nk = 144 a window does six
// 64 x 144 x 90 products (scores, the attention output, da, dq, dk, dv) and
// two 64 x 90 x 90 (do, dWproj), 12.0 MFLOP, against the bf16 q, dh, dq
// (3 x 11.5 KB) and k, v, dk, dv (4 x 25.9 KB) it must read or write: 138 KB,
// 87 FLOP per byte, byte-bound at the card's peaks (0.021 ms at Bw = 512).
// The design reads dh once per head pair (three times at six heads), does
// the products at m64 with N or K as small as 16, and is latency-bound: on
// the H100 at Bw = 512 the window kernel took 0.19 ms, 0.14 of it without
// the output stores, which write each row a pair's columns at a time (60
// of 180 bytes at C = 90: partial sectors).

#include "hopper.cuh"
#include "swin_pack.cuh"

namespace {

using namespace swin;

constexpr int NKR = 144;          // key rows staged per head (nk <= 144)
constexpr int NKT = NKR / 8;      // their 8-key accumulator blocks
constexpr int NKM = 192;          // keys of the staged bf16(a) and bf16(ds): three m64 tiles
constexpr int OB_THREADS = 3 * 128;  // two consumer warpgroups and a producer
constexpr int OB_MIN_REGS = 168;     // 384 x 168: the producer gives 128 x 128 to the consumers
constexpr size_t OB_MAX_SMEM = 232448;

struct Params {
  const bf16* q;      // (bw, 64, ld)
  const bf16* k;      // (bw, nk, ld)
  const bf16* v;      // (bw, nk, ld)
  const bf16* dh;     // (bw, 64, ld)
  const float* bias;  // (heads, 64, nk)
  const bf16* wproj;  // (cp, cp), zero-padded
  bf16* dq;           // (bw, 64, ld)
  bf16* dk;           // (bw, nk, ld)
  bf16* dv;           // (bw, nk, ld)
  bf16* att;          // (bw*64, cp) attention output, zero past heads * hd
  bf16* dhp;          // (bw*64, cp) dh, zero past ld
  float* part;        // (grid, heads*64*nk + cp): each block's ds sums, then its dh column sums
  int bw, wpb, nk, cp, ld, heads, hd;
  float scale;
};

// Shared memory (bytes): `ns` stages of [q of the pair's two heads (64 x
// hp) | k of both, then v of both (144 x hp) | dh (64 x cp)], then per
// consumer warpgroup bf16(a) and bf16(ds) (64 x 192), do (64 x hp) and its
// head's wproj rows (hp x cp), then the ring's mbarriers. Every operand is
// interleaved K-major (swin_pack.cuh's kmaj) at the width given.
struct ObLayout {
  int ns;
  size_t q, k, dh, stage, a, ds, dop, wp, bars, total;
};

__host__ __device__ inline ObLayout ob_layout(int cp, int hp) {
  ObLayout L;
  L.q = 0;
  L.k = L.q + 2 * (size_t)N * hp * 2;
  L.dh = L.k + 4 * (size_t)NKR * hp * 2;
  L.stage = align128(L.dh + (size_t)N * cp * 2);
  const size_t sq = (size_t)N * NKM * 2, fixed = 4 * sq + 2 * (size_t)N * hp * 2 +
                                                2 * (size_t)hp * cp * 2 + 128;
  L.ns = fixed + 2 * L.stage <= OB_MAX_SMEM ? 2 : 1;
  L.a = L.ns * L.stage;
  L.ds = L.a + 2 * sq;
  L.dop = L.ds + 2 * sq;
  L.wp = L.dop + 2 * (size_t)N * hp * 2;
  L.bars = L.wp + 2 * (size_t)hp * cp * 2;
  L.total = L.bars + 128;
  return L;
}

// the m16k16 A fragment of 16 columns (accumulator blocks 2 kb, 2 kb + 1)
// of an fp32 accumulator, rounded to bf16
__device__ __forceinline__ void a_frag(uint32_t (&f)[4], const float* acc, int kb) {
  f[0] = pack_bf16(acc[8 * kb], acc[8 * kb + 1]);
  f[1] = pack_bf16(acc[8 * kb + 2], acc[8 * kb + 3]);
  f[2] = pack_bf16(acc[8 * kb + 4], acc[8 * kb + 5]);
  f[3] = pack_bf16(acc[8 * kb + 6], acc[8 * kb + 7]);
}

template <int HP>
__device__ __forceinline__ void wg_mma_ss(float (&d)[HP / 2], uint64_t da, uint64_t db,
                                          int ta_mn) {
  using namespace hopper;
  if (ta_mn) {
    if constexpr (HP == 16) wgmma_n16<MNMAJ, MNMAJ>(d, da, db, 1);
    else wgmma_n32<MNMAJ, MNMAJ>(d, da, db, 1);
  } else {
    if constexpr (HP == 16) wgmma_n16<KMAJ, KMAJ>(d, da, db, 1);
    else wgmma_n32<KMAJ, KMAJ>(d, da, db, 1);
  }
}

template <int HP>
__device__ __forceinline__ void wg_mma_rs_mn(float (&d)[HP / 2], const uint32_t (&a)[4],
                                             uint64_t db) {
  using namespace hopper;
  if constexpr (HP == 16) wgmma_n16_rs<MNMAJ>(d, a, db, 1);
  else wgmma_n32_rs<MNMAJ>(d, a, db, 1);
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// Writes slots [o, o + hd) of the warp's rows of an m64 x HP accumulator,
// times `mul`, to dst[(row) * ld + slot - o] for rows row0 + r < rows.
template <int HP>
__device__ __forceinline__ void store_slots(bf16* dst, int ld, const float (&acc)[HP / 2],
                                            int row0, int rows, int o, int hd, float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3, w = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int j = 0; j < HP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int slot = 8 * j + 2 * t4 + (e & 1), r = row0 + 16 * w + g + 8 * (e >> 1);
      if (slot >= o && slot < o + hd && r < rows)
        dst[(size_t)r * ld + slot - o] = __float2bfloat16(acc[4 * j + e] * mul);
    }
}

// rows x cols bf16 of a dense staging (row stride cs, even) to dst (row
// stride ld; dst and ld even) by the producer warpgroup: 4-byte words, a
// half-warp on each row (cols <= 64: 32 words)
__device__ __forceinline__ void copy_out(bf16* dst, int ld, const unsigned char* st, int cs,
                                         int rows, int cols, int t) {
  const int words = (cols + 1) / 2;
  for (int w = t & 15; w < words; w += 16)
    for (int r = t >> 4; r < rows; r += 8) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(st + (r * cs + 2 * w) * 2);
      bf16* d = dst + (size_t)r * ld + 2 * w;
      if (2 * w + 1 < cols) *reinterpret_cast<uint32_t*>(d) = v;
      else *d = *reinterpret_cast<const bf16*>(&v);
    }
}

// Where a (window, head pair) item's output rows are staged in its ring
// stage, once both consumers are done with the stage's inputs: dk and dv
// over k and v, att over q, dq over dh; dense, row stride cs (even).
struct OutStage {
  unsigned char *dk, *dv, *att, *dq;
};

__device__ __forceinline__ OutStage out_stage(unsigned char* stg, const ObLayout& L, int nk,
                                              int cs) {
  return {stg + L.k, stg + L.k + (size_t)nk * cs * 2, stg + L.q, stg + L.dh};
}

template <int HP>
__global__ void __launch_bounds__(OB_THREADS, 1) ocab_bwd_wg_kernel(const Params p) {
  using namespace hopper;
  extern __shared__ __align__(1024) unsigned char sm[];
  const int CP = p.cp, LD = p.ld, nk = p.nk, hd = p.hd, heads = p.heads;
  const ObLayout L = ob_layout(CP, HP);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* empty = full + 2;
  const int tid = threadIdx.x, wgi = tid >> 7;
  const int w0 = blockIdx.x * p.wpb, nwin = min(p.wpb, p.bw - w0);
  const int npass = (heads + 1) / 2, ns = L.ns;
  constexpr int QB = N * HP * 2, KB = NKR * HP * 2;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 128);  // every producer thread
      mbar_init(&empty[s], 8);   // every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 2) {  // producer warpgroup: the ring of windows
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = tid - 256;
    // item j's output rows, staged in its stage, to device memory
    auto flush = [&](int j) {
      const int pass = j / nwin, cols = min(2, heads - 2 * pass) * hd, cs = (cols + 1) / 2 * 2;
      const size_t win = w0 + j % nwin, cpass = 2 * pass * hd;
      const OutStage o = out_stage(sm + (j % ns) * L.stage, L, nk, cs);
      copy_out(p.dk + win * nk * LD + cpass, LD, o.dk, cs, nk, cols, pt);
      copy_out(p.dv + win * nk * LD + cpass, LD, o.dv, cs, nk, cols, pt);
      copy_out(p.dq + win * N * LD + cpass, LD, o.dq, cs, N, cols, pt);
      copy_out(p.att + win * N * CP + cpass, CP, o.att, cs, N, cols, pt);
      asm volatile("bar.sync 4, 128;\n" ::: "memory");  // the staging is read
    };
    int it = 0;
    for (int pass = 0; pass < npass; ++pass)
      for (int i = 0; i < nwin; ++i, ++it) {
        const int st = it % ns;
        if (it >= ns) {
          mbar_wait(&empty[st], (it / ns - 1) & 1);
          flush(it - ns);
        }
        unsigned char* stg = sm + st * L.stage;
        const size_t win = w0 + i;
        for (int j = 0; j < 2 && 2 * pass + j < heads; ++j) {
          const int base = ((2 * pass + j) * hd) & ~1;
          fetch_head<HP, 128>(stg + L.q + j * QB, p.q + win * N * LD, N, N, LD, base, LD, pt);
          fetch_head<HP, 128>(stg + L.k + j * KB, p.k + win * nk * LD, nk, NKR, LD, base, LD,
                              pt);
          fetch_head<HP, 128>(stg + L.k + (2 + j) * KB, p.v + win * nk * LD, nk, NKR, LD, base,
                              LD, pt);
        }
        const bf16* dh = p.dh + win * N * LD;
        for (int idx = pt; idx < N * (CP / 2); idx += 128) {
          const int r = idx / (CP / 2), c = 2 * (idx - r * (CP / 2));
          const bool ok = c < LD;
          cp_async4(stg + L.dh + kmaj(r, c, CP), ok ? dh + (size_t)r * LD + c : dh,
                    ok ? 4 : 0);
        }
        mbar_arrive_cp_async(&full[st]);  // once this thread's copies land
      }
    for (int j = max(0, it - ns); j < it; ++j) {
      mbar_wait(&empty[j % ns], (j / ns) & 1);
      flush(j);
    }
    return;
  }

  // consumer warpgroup wgi: head 2 pass + wgi of every window of the block
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wt = tid & 127, wi = wt >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * wi;  // the warp's 16 query rows
  unsigned char* a_s = sm + L.a + wgi * (size_t)N * NKM * 2;
  unsigned char* ds_s = sm + L.ds + wgi * (size_t)N * NKM * 2;
  unsigned char* do_s = sm + L.dop + wgi * (size_t)QB;
  unsigned char* wp_s = sm + L.wp + wgi * (size_t)HP * CP * 2;
  const size_t LB = (size_t)heads * N * nk;  // the bias gradient's part of a row of `part`
  float* part = p.part + blockIdx.x * (LB + CP);
  const float qscale = round_bf16(p.scale), ninf = -__int_as_float(0x7f800000);
  auto wg_sync = [&] { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory"); };
  auto pair_sync = [] { asm volatile("bar.sync 3, 256;\n" ::: "memory"); };  // both consumers
  auto proxy_fence = [] { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); };
  float dbp[2] = {0.f, 0.f};  // wg 0: dh's column sums, columns wt and wt + 128

  int it = 0;
  for (int pass = 0; pass < npass; ++pass) {
    const int head = 2 * pass + wgi, c0 = head * hd, o = c0 & 1;
    const bool live = head < heads;
    // the pass's columns of dq, dk, dv and att: its heads' hd each, staged
    // dense in shared memory at row stride cs (even)
    const int cols = min(2, heads - 2 * pass) * hd, cs = (cols + 1) / 2 * 2;
    const float* bh = p.bias + (size_t)(live ? head : 0) * N * nk;
    // the scores' starting value: the bias, -inf past nk
    float a[4 * NKT];
    auto load_bias = [&] {
#pragma unroll
      for (int t = 0; t < NKT; ++t) {
        const int c = 8 * t + 2 * t4;
        if (c < nk) {
          const float2 b0 = __ldg(reinterpret_cast<const float2*>(bh + (r0 + g) * nk + c));
          const float2 b1 = __ldg(reinterpret_cast<const float2*>(bh + (r0 + g + 8) * nk + c));
          a[4 * t] = b0.x; a[4 * t + 1] = b0.y; a[4 * t + 2] = b1.x; a[4 * t + 3] = b1.y;
        } else {
          a[4 * t] = a[4 * t + 1] = a[4 * t + 2] = a[4 * t + 3] = ninf;
        }
      }
    };
    float dbs[4 * NKT];  // this head's sum of ds over the block's windows
    zero(dbs);
    if (live) {
      load_bias();
      // the head's wproj rows at slots o .. o + hd - 1, zero elsewhere: the
      // B operand of do, whose other slots come out exactly zero
      for (int i = wt; i < HP * (CP / 2); i += 128) {
        const int d = i / (CP / 2), c = 2 * (i - d * (CP / 2));
        const bool real = d >= o && d < o + hd;
        *reinterpret_cast<uint32_t*>(wp_s + kmaj(d, c, CP)) =
            real ? *reinterpret_cast<const uint32_t*>(p.wproj + (size_t)(c0 + d - o) * CP + c)
                 : 0u;
      }
      proxy_fence();
      wg_sync();
    }

    for (int i = 0; i < nwin; ++i, ++it) {
      const int st = it % ns;
      mbar_wait(&full[st], (it / ns) & 1);
      proxy_fence();  // the stage's copies are read by wgmma
      const unsigned char* stg = sm + st * L.stage;
      const unsigned char* q_h = stg + L.q + wgi * QB;
      const unsigned char* k_h = stg + L.k + wgi * KB;
      const unsigned char* v_h = stg + L.k + (2 + wgi) * KB;
      const unsigned char* dh_s = stg + L.dh;
      const size_t win = w0 + i, row0 = win * N;

      if (pass == 0) {
        // dh at the padded width for dWproj (16-byte runs), its column sums,
        // and att's padding columns
        for (int idx = tid; idx < N * (CP / 8); idx += 256) {
          const int r = idx / (CP / 8), c8 = 8 * (idx - r * (CP / 8));
          *reinterpret_cast<uint4*>(p.dhp + (row0 + r) * CP + c8) =
              *reinterpret_cast<const uint4*>(dh_s + kmaj(r, c8, CP));
        }
        if (wgi == 0)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int c = wt + 128 * u;
            if (c < CP) {
              float s = 0.f;
              for (int r = 0; r < N; ++r)
                s += __bfloat162float(*reinterpret_cast<const bf16*>(dh_s + kmaj(r, c, CP)));
              dbp[u] += s;
            }
          }
        const int pad = CP - heads * hd;
        for (int idx = tid; idx < N * pad; idx += 256)
          p.att[(row0 + idx / pad) * CP + heads * hd + idx % pad] = __float2bfloat16(0.f);
      }

      float oa[HP / 2], dq[HP / 2];  // the attention output and dq, staged after dk and dv
      if (live) {
        // ---- do = bf16(dh . wproj[head rows]^T), and the scores' A operand
        float ao[HP / 2];
        zero(ao);
        fence_regs(ao);
        wg_fence();
        for (int ks = 0; ks < CP / 16; ++ks)
          wg_mma_ss<HP>(ao, desc(dh_s + ks * 256, 128, CP * 16),
                        desc(wp_s + ks * 256, 128, CP * 16), 0);
        wg_commit();
        uint32_t fq[HP / 16][4];
#pragma unroll
        for (int kk = 0; kk < HP / 16; ++kk) {
          ldsm_x4(fq[kk], reinterpret_cast<const bf16*>(
                              q_h + kmaj(r0 + (lane & 15), kk * 16 + (lane >> 4) * 8, HP)));
#pragma unroll
          for (int e = 0; e < 4; ++e)
            fq[kk][e] = scaled_q(fq[kk][e], qscale, kk * 16 + 2 * t4 + (e >> 1) * 8, o, hd);
        }
        wg_wait<0>();
        fence_regs(ao);
        uint32_t fdo[HP / 16][4];
#pragma unroll
        for (int kk = 0; kk < HP / 16; ++kk) a_frag(fdo[kk], ao, kk);
#pragma unroll
        for (int j = 0; j < HP / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<uint32_t*>(do_s + kmaj(r0 + g + 8 * hh, 8 * j + 2 * t4, HP)) =
                pack_bf16(ao[4 * j + 2 * hh], ao[4 * j + 2 * hh + 1]);

        // ---- scores on the bias: a += bf16(q * scale) . k^T (N = 144)
        fence_regs(a);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < HP / 16; ++kk)
          wgmma_n144_rs<KMAJ>(a, fq[kk], desc(k_h + kk * 256, 128, HP * 16), 1);
        wg_commit();
        wg_wait<0>();
        fence_regs(a);

        // ---- softmax of rows r0 + g and r0 + g + 8 (one reciprocal a row),
        // bf16(a) into a_s for dv
        float m0 = a[0], m1 = a[2];
#pragma unroll
        for (int t = 0; t < NKT; ++t) {
          m0 = fmaxf(m0, fmaxf(a[4 * t], a[4 * t + 1]));
          m1 = fmaxf(m1, fmaxf(a[4 * t + 2], a[4 * t + 3]));
        }
#pragma unroll
        for (int sh = 1; sh <= 2; sh <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, sh));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, sh));
        }
        float l0 = 0.f, l1 = 0.f;
#pragma unroll
        for (int t = 0; t < NKT; ++t) {
          a[4 * t] = expf(a[4 * t] - m0);
          a[4 * t + 1] = expf(a[4 * t + 1] - m0);
          a[4 * t + 2] = expf(a[4 * t + 2] - m1);
          a[4 * t + 3] = expf(a[4 * t + 3] - m1);
          l0 += a[4 * t] + a[4 * t + 1];
          l1 += a[4 * t + 2] + a[4 * t + 3];
        }
#pragma unroll
        for (int sh = 1; sh <= 2; sh <<= 1) {
          l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
          l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
        }
        const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
        for (int t = 0; t < NKT; ++t) {
          a[4 * t] *= inv0; a[4 * t + 1] *= inv0;
          a[4 * t + 2] *= inv1; a[4 * t + 3] *= inv1;
          *reinterpret_cast<uint32_t*>(a_s + kmaj(r0 + g, 8 * t + 2 * t4, NKM)) =
              pack_bf16(a[4 * t], a[4 * t + 1]);
          *reinterpret_cast<uint32_t*>(a_s + kmaj(r0 + g + 8, 8 * t + 2 * t4, NKM)) =
              pack_bf16(a[4 * t + 2], a[4 * t + 3]);
        }

        // ---- the attention output bf16(a) . v, for dWproj
        zero(oa);
        fence_regs(oa);
        wg_fence();
#pragma unroll
        for (int kb = 0; kb < NKR / 16; ++kb) {
          uint32_t pa[4];
          a_frag(pa, a, kb);
          wg_mma_rs_mn<HP>(oa, pa, desc(v_h + kb * 2 * HP * 16, HP * 16, 128));
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(oa);

        // ---- da = do . v^T by 48-key thirds: rowsum(da * a), then ds =
        // a * (da - rowsum) into the ds sum, bf16(ds) into ds_s, and dq +=
        // bf16(ds) . k
        auto da_third = [&](float (&da)[24], int th) {
          zero(da);
          fence_regs(da);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < HP / 16; ++kk)
            wgmma_n48_rs<KMAJ>(da, fdo[kk], desc(v_h + th * 6 * HP * 16 + kk * 256, 128,
                                                 HP * 16), 1);
          wg_commit();
          wg_wait<0>();
          fence_regs(da);
        };
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int th = 0; th < 3; ++th) {
          float da[24];
          da_third(da, th);
#pragma unroll
          for (int jj = 0; jj < 6; ++jj) {
            const int t = 6 * th + jj;
            s0 += da[4 * jj] * a[4 * t] + da[4 * jj + 1] * a[4 * t + 1];
            s1 += da[4 * jj + 2] * a[4 * t + 2] + da[4 * jj + 3] * a[4 * t + 3];
          }
        }
#pragma unroll
        for (int sh = 1; sh <= 2; sh <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, sh);
          s1 += __shfl_xor_sync(0xffffffffu, s1, sh);
        }
        zero(dq);
#pragma unroll
        for (int th = 0; th < 3; ++th) {
          float da[24];
          da_third(da, th);
#pragma unroll
          for (int jj = 0; jj < 6; ++jj) {
            const int t = 6 * th + jj;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float ds = a[4 * t + e] * (da[4 * jj + e] - (e < 2 ? s0 : s1));
              dbs[4 * t + e] += ds;
              da[4 * jj + e] = ds;
            }
            *reinterpret_cast<uint32_t*>(ds_s + kmaj(r0 + g, 8 * t + 2 * t4, NKM)) =
                pack_bf16(da[4 * jj], da[4 * jj + 1]);
            *reinterpret_cast<uint32_t*>(ds_s + kmaj(r0 + g + 8, 8 * t + 2 * t4, NKM)) =
                pack_bf16(da[4 * jj + 2], da[4 * jj + 3]);
          }
          fence_regs(dq);
          wg_fence();
#pragma unroll
          for (int kb = 0; kb < 3; ++kb) {
            uint32_t pa[4];
            a_frag(pa, da, kb);
            wg_mma_rs_mn<HP>(dq, pa, desc(k_h + (3 * th + kb) * 2 * HP * 16, HP * 16, 128));
          }
          wg_commit();
          wg_wait<0>();
          fence_regs(dq);
        }
        proxy_fence();  // a_s, ds_s and do_s are read by wgmma next
      }

      // ---- dk = bf16(ds)^T . q * scale and dv = bf16(a)^T . do: three m64
      // tiles of keys, A read transposed from ds_s and a_s. The stage's
      // room takes the pass's output rows once both consumers are done with
      // it (k and v: dk and dv; then q and dh: att and dq); the producer
      // writes them out before it refills the stage (on the H100, 2-byte
      // stores straight from the accumulators took 0.14 of the kernel's
      // 0.26 ms at Bw = 512, and 4-byte runs by the consumers 0.07 of 0.21).
      const OutStage os = out_stage(sm + st * L.stage, L, nk, cs);
      pair_sync();
      if (live) {
#pragma unroll 1
        for (int mt = 0; mt < 3 && 64 * mt < nk; ++mt) {
          float dk[HP / 2], dv[HP / 2];
          zero(dk);
          zero(dv);
          fence_regs(dk);
          fence_regs(dv);
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < N / 16; ++ks) {
            const int off = ks * 2 * NKM * 16 + mt * 1024;
            wg_mma_ss<HP>(dk, desc(ds_s + off, NKM * 16, 128),
                          desc(q_h + ks * 2 * HP * 16, HP * 16, 128), 1);
            wg_mma_ss<HP>(dv, desc(a_s + off, NKM * 16, 128),
                          desc(do_s + ks * 2 * HP * 16, HP * 16, 128), 1);
          }
          wg_commit();
          wg_wait<0>();
          fence_regs(dk);
          fence_regs(dv);
          store_slots<HP>(reinterpret_cast<bf16*>(os.dk) + wgi * hd, cs, dk, 64 * mt, nk, o, hd,
                          p.scale);
          store_slots<HP>(reinterpret_cast<bf16*>(os.dv) + wgi * hd, cs, dv, 64 * mt, nk, o, hd,
                          1.f);
        }
      }
      pair_sync();  // q is read
      if (live) {
        store_slots<HP>(reinterpret_cast<bf16*>(os.att) + wgi * hd, cs, oa, 0, N, o, hd, 1.f);
        store_slots<HP>(reinterpret_cast<bf16*>(os.dq) + wgi * hd, cs, dq, 0, N, o, hd, p.scale);
      }
      if (live && i + 1 < nwin) load_bias();  // the next window's scores start from it
      __syncwarp();
      // this warp is done with the stage: its staged rows go out with the producer
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    if (live)  // the head's ds summed over the block's windows
#pragma unroll
      for (int t = 0; t < NKT; ++t) {
        const int c = 8 * t + 2 * t4;
        if (c >= nk) continue;
        float* dst = part + (size_t)head * N * nk + (r0 + g) * nk + c;
        *reinterpret_cast<float2*>(dst) = make_float2(dbs[4 * t], dbs[4 * t + 1]);
        *reinterpret_cast<float2*>(dst + 8 * nk) = make_float2(dbs[4 * t + 2], dbs[4 * t + 3]);
      }
  }
  if (wgi == 0)
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (wt + 128 * u < CP) part[LB + wt + 128 * u] = dbp[u];
}

template <int HP>
cudaError_t launch(const Params& p, cudaStream_t s) {
  const ObLayout L = ob_layout(p.cp, HP);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, ocab_bwd_wg_kernel<HP>);
  if (err != cudaSuccess) return err;
  // setmaxnreg moves registers between the warpgroups: the consumers' 232
  // need the 168 a thread gets at launch
  if (attr.numRegs < OB_MIN_REGS) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(ocab_bwd_wg_kernel<HP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L.total);
  if (err != cudaSuccess) return err;
  const int grid = (p.bw + p.wpb - 1) / p.wpb;
  ocab_bwd_wg_kernel<HP><<<grid, OB_THREADS, L.total, s>>>(p);
  return cudaGetLastError();
}

bool aligned(const void* ptr, size_t n) { return reinterpret_cast<uintptr_t>(ptr) % n == 0; }

}  // namespace

// C entry point, bound with ctypes; returns a cudaError_t. q, dh (bw, 64,
// ld) and k, v (bw, nk, ld) bf16 with ld even (the heads' hd columns first,
// zeros after); bias (heads, 64, nk) fp32; wproj (cp, cp) bf16 zero-padded;
// wpb windows a block (grid ceil(bw / wpb)). Writes dq (bw, 64, ld), dk and
// dv (bw, nk, ld) in the heads' columns, att and dhp (bw*64, cp) bf16 and
// part (grid, heads*64*nk + cp) fp32.
extern "C" int ocab_bwd_attn_bf16(const void* q, const void* k, const void* v, const void* dh,
                                  const void* bias, const void* wproj, void* dq, void* dk,
                                  void* dv, void* att, void* dhp, void* part, int bw, int wpb,
                                  int nk, int cp, int ld, int heads, int hd, float scale,
                                  void* stream) {
  if (bw <= 0 || wpb <= 0 || nk <= 0 || nk > NKR || nk % 2 != 0 || cp <= 0 || cp > MAX_C ||
      cp % 16 != 0 || ld <= 0 || ld % 2 != 0 || ld > cp || heads <= 0 || hd <= 0 ||
      hd > DP || heads * hd > ld)
    return (int)cudaErrorInvalidValue;
  const void* four[] = {q, k, v, dh, wproj, dq, dk, dv, att};
  for (const void* ptr : four)
    if (!aligned(ptr, 4)) return (int)cudaErrorMisalignedAddress;
  if (!aligned(bias, 8) || !aligned(part, 8) || !aligned(dhp, 16))
    return (int)cudaErrorMisalignedAddress;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dh = static_cast<const bf16*>(dh);
  p.bias = static_cast<const float*>(bias);
  p.wproj = static_cast<const bf16*>(wproj);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.att = static_cast<bf16*>(att);
  p.dhp = static_cast<bf16*>(dhp);
  p.part = static_cast<float*>(part);
  p.bw = bw;
  p.wpb = wpb;
  p.nk = nk;
  p.cp = cp;
  p.ld = ld;
  p.heads = heads;
  p.hd = hd;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(hd + (hd & 1) <= 16 ? launch<16>(p, s) : launch<32>(p, s));
}

// Dynamic shared memory one block needs at padded width cp and head_dim hd.
extern "C" size_t ocab_bwd_attn_smem_bytes(int cp, int hd) {
  return ob_layout(cp, hd + (hd & 1) <= 16 ? 16 : 32).total;
}
