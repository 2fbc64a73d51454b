// The Swin block's forward on wgmma, in eight instantiations of one body:
// K1, the inference block (swin_block.cu's swin_block_bf16), K2, the same
// block for training, which also stores h (swin_block_fwd_h_bf16), K5,
// HAT's hybrid attention block (hab_block.cu's hab_block_bf16), K9a, K5 for
// training with K2's store of h and the two branches' drop-path scales
// (hab_block_fwd_h_bf16), K4b's recompute, which stops at the fp32 h
// (swin_block_bwd.cu), K6 and K10a, HAT's OCAB tail for inference and
// for training with K2's store of h (ocab.cu; the OCAB mode below), and
// K13, K1 with a stage taken out or the GELU swapped (swin_stage_ablation.cu;
// the STAGE and ACT modes below). Each computes, at K1's rounding points:
//
//   LN1 (fp32 stats) -> QKV (+bqkv, rounded to bf16; q then * scale, rounded)
//   -> per head: softmax(q . k^T + bias[h] (+ mask[w], K5)) . v  (softmax fp32, P bf16)
//   -> proj (+bproj) -> h = x + proj (+ conv_scale * conv_x, K5) (residual fp32)
//   -> LN2 of bf16(h) -> fc1 -> tanh GELU -> fc2 -> out = h + mlp + b2
//
// K2's stored h is the bf16(h) that LN2 reads, so K3's recompute of LN2 from
// it matches the forward.
//
// Design (the shape of K3's and K4's window kernels, swin_block_train.cu):
// persistent blocks of two consumer warpgroups and one producer warp-
// group, each consumer warpgroup one 8x8 window (M = 64 tokens) at a time.
// One ring of four weight tiles serves the block's windows: the producer
// thread streams, per window pass, per head the head's wq, wk, wv and wproj
// tiles (attn_pack_kernel's, ck x hp bf16), then per 64-wide hidden chunk
// w1 and w2 (mlp_pack_kernel's, ck x 64), each by one TMA bulk copy into
// the next slot, under mbarriers; a slot is refilled once every consumer
// warp has released it. Every product runs on wgmma: qkv (A = LN1's output
// in shared memory, one m64 x hp product per tile), the scores (A = q, B =
// k, both in shared memory, the bias as the accumulator's starting value),
// P . v (P from registers, packed from the softmax's fp32 values), proj
// (the attention output from registers, accumulated over the heads into
// the fp32 residual), fc1 (A = LN2's output in shared memory) and fc2 (the
// GELU output from registers). The residual h stays in the accumulator
// registers from proj to out; its rows lie in one quad of one warp, so LN2
// reduces by shuffles alone. x arrives by 16-byte cp.async; out (and K2's
// h) leave through the window's x buffer as 16-byte runs.
//
// The weights: K2 and K9a pack the live weights on every call (pack_fwd_wg:
// two launches, ~0.006 ms at the flagship widths). K1 and K5 take the tiles
// packed: their inference forwards pack frozen weights once per block, and
// a call that brings none packs them first, as K2 does. K4b's recompute
// streams only the attention's tiles, which K4b packs once for it and its
// attention phase.
//
// K9a and K4b's recompute take the operands K1, K2 and K5 lack (dp1, dp2;
// h32) as kernel arguments of their own (FwdWgExtra): FwdWgParams, which
// all five read, carries none of them.
//
// K5 (HAB). The wrapper pads the weights (pad_hab_operands): each head to
// 16 columns and the channels to c = 96 at HAT's C = 90, while the windows
// x, conv_x and out keep their cio = 90 columns in device memory. A window
// of 64 x cio bf16 is 128 cio bytes, a multiple of 16, so x and conv_x
// still arrive by 16-byte cp.async of the whole dense window and out leaves
// the same way, though each 180-byte row is only 4-byte aligned: no gather
// to 96-wide windows and no narrower copies. conv_x waits in shared memory
// beside x (11.5 KB a window at cio = 90). LN1 and LN2 take their
// statistics over the cio real columns; the padded columns of the LN
// outputs, q, k and v are zero, and those of h are never read. Window w
// adds mask[w mod nmask] to bias[h] in the scores' starting accumulator (as
// K9c does); an unshifted call passes no mask and reads none. The conv
// branch joins the residual in fp32 registers before LN2, in the first
// design's order: h = (x + (proj + bproj)) + conv_scale * conv_x.
//
// Padding: C is rounded up to whole 64-column chunks (ck) and each head to
// hp = 16 or 32 columns; the packed tiles, q, k, v and the LN outputs hold
// zeros there, so the padded columns add nothing. At K5's c = 96, ck = 128:
// qkv's and fc1's K and proj's and fc2's N do a third more products than
// the 96 columns need.
//
// K6 and K10a (OCAB). The tail of the overlapping cross-attention block: q
// (Bw, 64, cio), k and v (Bw, nk, cio) come from device memory (LN1, the
// qkv product and the overlap gather stay outside), so the mode has no
// LN1, no qkv tiles, no mask and no conv branch; per head the scores run
// over nk <= 144 keys (m64 x n144, A = bf16(q * scale) from registers,
// keys past nk starting at -inf), P . v takes nine k16 steps (one head's
// attention: attn_head_wg.cuh, which K11 shares), and the rest is K5's:
// proj, the residual, LN2 over the cio real columns, the MLP, out (and
// K10a's h) as dense cio-wide windows. Its extra operands
// (q, k, v, nk, the gather's stage count) are a kernel argument of their
// own (OcabIn). The producer warpgroup's thread 0 streams per pass only
// the heads' wproj tiles and the MLP's (pack_ocab's packing: zero wqkv
// tiles that are never streamed); its warps 1-3 gather each (window, head)'s
// q, k and v by 4-byte cp.async straight into the K-major interleaved
// layout at hp slots (fetch_head: a head of odd first column h hd lands at
// slots 1 .. hd, its neighbour's column beside it), into a ring of `ns`
// stages per window under mbarriers, so head h + 1 lands while head h
// computes. Whatever a padding slot holds meets an exact zero: q's copy is
// masked to zero outside the head (scaled_q), and the packed wproj tile
// holds zero rows outside the head's slots. The attention output of every
// head waits in shared memory (the LN buffer, heads x hp columns wide) and
// proj runs after the last head, one tile a head: the 144-key scores (72
// fp32 registers a thread) and their packed probabilities (36) never share
// the registers with the residual (32 per 64 columns). The softmax takes
// the hardware exponential (__expf), and the gathering threads keep 56
// registers, the consumers 224 (the other modes: 40 and 232); on the H100
// at Bw = 2048 each saved a few percent, and the gather's 4-byte copies,
// one slot pair a thread walking the rows, take ~15% of the time
// (tools/ocab_fwd_ablation.py).
//
// The tail: a block walks the window groups (nw windows each) in strides of
// the grid. K1 at batch 3 (Bw = 768) has 384 pairs over 132 SMs: three
// rounds, the last with 120 of 132 blocks busy, so the tail leaves 3% of
// the rounds' slots empty; K5 at batch 8 (Bw = 2048) has 1024 pairs, eight
// rounds, the last with 100 busy (3%). One window a block (swin_block_bf16's
// `windows` = 1: six rounds of 768 single windows) measured slower than two
// at Bw = 768 (chip_smoke.py phase 3, PERF.md), so two stay the default.
//
// K13's modes (K1's instantiation otherwise: no h store, no HAB, cio = c).
// Each only takes work away, from the producer's stream as well as from the
// consumers, so a mode's time differs from the full block's by what it
// removes or swaps. STAGE: NOATTN streams per head only the wq and wproj
// tiles and gives proj bf16(q + bq), unscaled, as the head's attention
// output (no k, v, scores, softmax or P . v); ATTNONLY stops after proj,
// as H32 does, streams no MLP tiles and writes out = bf16(h) through x_s;
// MLPONLY streams only the MLP's tiles, computes no LN1, qkv, attention or
// proj, and starts from h = x in the accumulators. ACT: the MLP's
// activation (activation<ACT> below); the default, ACT_TANH, is K1's.

#pragma once

#include "attn_head_wg.cuh"
#include "hopper.cuh"
#include "swin_common.cuh"
#include "swin_pack.cuh"

namespace swin {

// K13's switches (their defaults: the full block with K1's tanh GELU).
// ACT picks the MLP's activation: the tanh GELU, the A&S erf GELU, none,
// x * sigmoid(1.702 x), or erf as a Horner polynomial in x / sqrt(2)
// clipped to [-4, 4].
enum Stage { STAGE_FULL, STAGE_NOATTN, STAGE_ATTNONLY, STAGE_MLPONLY };
enum Act { ACT_TANH, ACT_ERF, ACT_NONE, ACT_SIGMOID, ACT_POLY };

// Abramowitz-Stegun 7.1.26 rational erf (max abs error 1.5e-7), the JAX
// kernels' exact GELU: sign(x) (1 - t P(t) exp(-x^2)), t = 1 / (1 + p|x|).
// t = 1 / y is taken as the hardware estimate, one Newton step and a
// correcting fma (Markstein's sequence): the division's correctly rounded
// result for y in [1, 2^126), without the division's branch and call to
// its slow path, which the unrolled GELU loop paid for every element. y is
// clipped to that range; past it exp(-x^2) is 0 and t does not matter.
__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float y = fminf(1.0f + 0.3275911f * ax, 0x1p126f);
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  r = fmaf(r, fmaf(-y, r, 1.0f), r);
  const float t = fmaf(r, fmaf(-y, r, 1.0f), r);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float sgn = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return sgn * (1.0f - poly * expf(-ax * ax));
}

// ACT_POLY's erf polynomial, defined in swin_stage_ablation.cu (its
// coefficients live there, in constant memory): only that source
// instantiates ACT_POLY.
__device__ float erf_poly(float u);

template <int ACT>
__device__ __forceinline__ float activation(float x) {
  if constexpr (ACT == ACT_TANH) {
    return gelu_tanh(x);
  } else if constexpr (ACT == ACT_ERF) {
    return x * 0.5f * (1.0f + erf_as(x * 0.70710678118654752f));
  } else if constexpr (ACT == ACT_NONE) {
    return x;
  } else if constexpr (ACT == ACT_SIGMOID) {
    return x / (1.0f + expf(-1.702f * x));
  } else {
    return x * 0.5f * (1.0f + erf_poly(fminf(fmaxf(x * 0.70710678118654752f, -4.0f), 4.0f)));
  }
}

}  // namespace swin

namespace {

using namespace swin;

struct FwdWgParams {
  const bf16* x;       // (Bw, 64, cio)
  const bf16* convx;   // K5: (Bw, 64, cio), the CAB branch in window layout
  const float* mask;   // K5: (nmask, 64, 64) additive mask, or null
  const float* ln1_w;  // (c)
  const float* ln1_b;
  const float* bqkv;   // (3c)
  const float* bias;   // (heads, 64, 64)
  const float* bproj;  // (c)
  const float* ln2_w;
  const float* ln2_b;
  const float* b1;     // (hidden)
  const float* b2;     // (c)
  const bf16* wattn;   // attn_pack_kernel's tiles: per head wproj^T, wq, wk, wv
  const bf16* wmlp;    // mlp_pack_kernel's tiles: per hidden chunk w1, w2^T
  bf16* out;           // (Bw, 64, cio)
  bf16* h_out;         // (Bw, 64, c), K2 only
  int c, cio, heads, hd, hidden, bw, nmask;
  float scale, conv_scale;
};

// K6's and K10a's operands the other modes lack: the windows' q (Bw, 64,
// cio) and the overlap's k, v (Bw, nk, cio), and the gather's stages per
// window
struct OcabIn {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  int nk, ns;
};

constexpr int OC_KEYS = 144;   // key rows staged per head (nk <= 144): nine k16 steps
constexpr int OC_GATHER = 96;  // the producer warpgroup's gathering threads (warps 1-3)

constexpr int FWD_STAGES = 4;
constexpr int FWD_THREADS = 3 * 128;  // two consumer warpgroups and a producer
constexpr int FWD_MIN_REGS = 168;     // 384 x 168: the producer gives 128 x 128 to the consumers

// vectors staged in shared memory per block, at these offsets in units of C
// (b1 last)
enum { F_LN1W, F_LN1B, F_BQKV, F_BPROJ = 5, F_LN2W, F_LN2B, F_B2, F_B1 };

// Shared memory at nw windows a block (bytes): the ring (4 slots of the
// larger tile, ck x 64 bf16), per window its LN output (64 x ck, K-major
// interleaved: LN1's, then LN2's), its x (dense 64 x cio; then the staging
// of K2's h_out and of out), K5's conv_x (dense 64 x cio) and one head's q,
// k, v (64 x hp each, K-major interleaved), the vectors, the ring's
// mbarriers.
struct FwdWgLayout {
  int ck, hp;
  size_t slot, ring, win, a, x, cx, q, k, v, vec, bars, total;
  int ns;        // OCAB: gather stages a window, each `stage` bytes from q
  size_t stage;
};

__host__ __device__ inline FwdWgLayout fwd_wg_layout(int c, int cio, int heads, int hidden,
                                                     int nw, bool hab) {
  FwdWgLayout L;
  L.ck = (c + TILE - 1) / TILE * TILE;
  L.hp = c / heads <= 16 ? 16 : 32;
  L.slot = (size_t)L.ck * 128;
  const size_t op = (size_t)N * L.hp * 2;
  size_t o = 0;
  L.a = o; o += (size_t)N * L.ck * 2;
  L.x = o; o += align128((size_t)N * cio * 2);
  L.cx = o; o += hab ? align128((size_t)N * cio * 2) : 0;
  L.q = o; o += op;
  L.k = o; o += op;
  L.v = o; o += op;
  L.win = align128(o);
  o = 0;
  L.ring = o; o += FWD_STAGES * L.slot;
  o += (size_t)nw * L.win;
  L.vec = o; o += align128(sizeof(float) * (F_B1 * (size_t)c + hidden));
  L.bars = o; o += 2 * FWD_STAGES * sizeof(uint64_t);
  L.total = o;
  return L;
}

// The OCAB mode's shared memory (bytes) at nw windows a block and ns
// gather stages a window: the ring, per window its LN buffer (64 x
// max(ck, heads hp): every head's attention output, K-major at heads hp
// columns, then LN2's output), its x (dense 64 x cio; then the staging of
// K10a's h and of out) and ns stages of one head's q (64 x hp), k and v
// (144 x hp each), then the vectors and the two rings' mbarriers.
__host__ __device__ inline FwdWgLayout ocab_wg_layout(int c, int cio, int heads, int hidden,
                                                      int nw, int ns) {
  FwdWgLayout L;
  L.ck = (c + TILE - 1) / TILE * TILE;
  L.hp = cio / heads <= 16 ? 16 : 32;
  L.slot = (size_t)L.ck * 128;
  L.ns = ns;
  const int ko = heads * L.hp > L.ck ? heads * L.hp : L.ck;
  size_t o = 0;
  L.a = o; o += (size_t)N * ko * 2;
  L.x = o; o += align128((size_t)N * cio * 2);
  L.cx = L.k = L.v = 0;
  L.stage = (size_t)(N + 2 * OC_KEYS) * L.hp * 2;
  L.q = o; o += ns * L.stage;
  L.win = align128(o);
  o = 0;
  L.ring = o; o += FWD_STAGES * L.slot;
  o += (size_t)nw * L.win;
  L.vec = o; o += align128(sizeof(float) * (F_B1 * (size_t)c + hidden));
  L.bars = o; o += (2 * FWD_STAGES + 2 * nw * ns) * sizeof(uint64_t);
  L.total = o;
  return L;
}

// d (m64 x hp) += A . B, B MN-major: one k16 step of qkv
template <int HP>
__device__ __forceinline__ void fwd_mma_mn(float (&d)[HP / 2], uint64_t da, uint64_t db) {
  if constexpr (HP == 16) hopper::wgmma_n16<hopper::KMAJ, hopper::MNMAJ>(d, da, db, 1);
  else hopper::wgmma_n32<hopper::KMAJ, hopper::MNMAJ>(d, da, db, 1);
}

// The A fragment of k16 step ks from an m64 accumulator's registers: the
// m16n8 layout of each 8-column block is the m16k16 A layout of two.
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[R], int ks) {
  a[0] = pack_bf16(d[8 * ks + 0], d[8 * ks + 1]);
  a[1] = pack_bf16(d[8 * ks + 2], d[8 * ks + 3]);
  a[2] = pack_bf16(d[8 * ks + 4], d[8 * ks + 5]);
  a[3] = pack_bf16(d[8 * ks + 6], d[8 * ks + 7]);
}

// 16-byte asynchronous global -> shared copy
__device__ __forceinline__ void fwd_cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// The body of every instantiation: STORE_H stores h (K2), HAB reads the
// mask and conv_x and keeps the windows cio wide (K5); both (K9a) also scale
// the two branches by dp1, dp2 ((Bw,) fp32 each, null: 1). H32 (K4b's
// recompute) stops at h = x + (proj + bproj), which it writes in fp32 to h32
// ((Bw, 64, c)): no LN2, no MLP, no out, and no MLP tiles in the ring. OCAB
// (K6; with STORE_H K10a) takes q, k, v from `oc` in place of LN1 and qkv,
// and keeps the windows cio wide. STAGE and ACT: K13's modes, on K1's
// instantiation only.
template <int NCH, int HP, bool STORE_H, bool HAB, bool H32 = false, bool OCAB = false,
          int STAGE = STAGE_FULL, int ACT = ACT_TANH>
__device__ __forceinline__ void fwd_wg_body(const FwdWgParams& p, int nw, unsigned char* fsm,
                                            const float* dp1 = nullptr,
                                            const float* dp2 = nullptr, float* h32 = nullptr,
                                            const OcabIn& oc = OcabIn{}) {
  using namespace hopper;
  static_assert(STAGE == STAGE_FULL || !(STORE_H || HAB || H32 || OCAB),
                "the stage modes are K1's");
  // the MLP runs (and its tiles stream) but in the recompute and ATTNONLY
  constexpr bool MLP = !H32 && STAGE != STAGE_ATTNONLY;
  constexpr int CK = NCH * TILE, CGS = HP * 16, NB = HP / 8;
  const int C = p.c, CIO = HAB || OCAB ? p.cio : p.c, heads = p.heads, hd = p.hd,
            hidden = p.hidden;
  const FwdWgLayout L = OCAB ? ocab_wg_layout(C, CIO, heads, hidden, nw, oc.ns)
                             : fwd_wg_layout(C, CIO, heads, hidden, nw, HAB);
  const int nj = (hidden + TILE - 1) / TILE;
  float* vec = reinterpret_cast<float*>(fsm + L.vec);
  uint64_t* full = reinterpret_cast<uint64_t*>(fsm + L.bars);
  uint64_t* empty = full + FWD_STAGES;
  uint64_t* gfull = empty + FWD_STAGES;  // OCAB: the gather ring, window w's stage s at w ns + s
  uint64_t* gempty = gfull + (OCAB ? nw * L.ns : 0);
  const int tid = threadIdx.x, wgi = tid >> 7;
  if constexpr (OCAB) {
    const float* vsrc[] = {p.bproj, p.ln2_w, p.ln2_b, p.b2};
    const int voff[] = {F_BPROJ, F_LN2W, F_LN2B, F_B2};
#pragma unroll
    for (int v = 0; v < 4; ++v)
      for (int i = tid; i < C; i += blockDim.x) vec[voff[v] * C + i] = __ldg(vsrc[v] + i);
    for (int i = tid; i < hidden; i += blockDim.x) vec[F_B1 * C + i] = __ldg(p.b1 + i);
  } else {
    const float* vsrc[] = {p.ln1_w, p.ln1_b, p.bqkv, p.bproj, p.ln2_w, p.ln2_b, p.b2};
    const int voff[] = {F_LN1W, F_LN1B, F_BQKV, F_BPROJ, F_LN2W, F_LN2B, F_B2};
    const int vlen[] = {C, C, 3 * C, C, C, C, C};
    // the recompute and ATTNONLY: LN1, bqkv and bproj only; MLPONLY: LN2
    // and b2 only
    constexpr int V0 = STAGE == STAGE_MLPONLY ? 4 : 0, NVEC = MLP ? 7 : 4;
#pragma unroll
    for (int v = V0; v < NVEC; ++v)
      for (int i = tid; i < vlen[v]; i += blockDim.x) vec[voff[v] * C + i] = __ldg(vsrc[v] + i);
    if constexpr (MLP)
      for (int i = tid; i < hidden; i += blockDim.x) vec[F_B1 * C + i] = __ldg(p.b1 + i);
  }
  if (tid == 0) {
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * nw);  // one arrival per consumer warp
    }
    if constexpr (OCAB)
      for (int s = 0; s < nw * L.ns; ++s) {
        mbar_init(&gfull[s], OC_GATHER);  // every gathering thread, once its copies land
        mbar_init(&gempty[s], 4);         // every warp of the window's warpgroup
      }
    mbar_fence_init();
  }
  __syncthreads();
  const int npairs = (p.bw + nw - 1) / nw;
  // per pass: OCAB's heads' wproj tiles, NOATTN's wq and wproj, MLPONLY's
  // none, else their wq, wk, wv and wproj; then the MLP's (none for the
  // recompute and ATTNONLY)
  const int per_pass = OCAB                      ? heads + 2 * nj
                       : STAGE == STAGE_MLPONLY ? 2 * nj
                       : STAGE == STAGE_NOATTN  ? 2 * heads + 2 * nj
                                                : 4 * heads + (MLP ? 2 * nj : 0);

  if (wgi == nw) {  // producer (OCAB's gathering threads keep 56 registers)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(OCAB ? 56 : 40) : "memory");
    if (tid == nw * 128) {
      const unsigned char* wa = reinterpret_cast<const unsigned char*>(p.wattn);
      const unsigned char* wm = reinterpret_cast<const unsigned char*>(p.wmlp);
      const uint32_t ta = (uint32_t)CK * HP * 2, tm = (uint32_t)CK * 128;
      uint32_t i = 0;
      for (int pr = blockIdx.x; pr < npairs; pr += gridDim.x)
        for (int t = 0; t < per_pass; ++t, ++i) {
          // per head: wq, wk, wv (packed 4h + 1 .. 3), then wproj (4h); OCAB
          // only wproj, NOATTN wq then wproj
          const unsigned char* src;
          uint32_t bytes;
          if constexpr (STAGE == STAGE_MLPONLY) {
            src = wm + (size_t)t * tm;
            bytes = tm;
          } else if constexpr (STAGE == STAGE_NOATTN) {
            src = t < 2 * heads ? wa + (size_t)(4 * (t >> 1) + (t & 1 ? 0 : 1)) * ta
                                : wm + (size_t)(t - 2 * heads) * tm;
            bytes = t < 2 * heads ? ta : tm;
          } else {
            const int u = t & 3;
            src = OCAB ? (t < heads ? wa + (size_t)(4 * t) * ta : wm + (size_t)(t - heads) * tm)
                  : t < 4 * heads ? wa + (size_t)(4 * (t >> 2) + (u < 3 ? u + 1 : 0)) * ta
                                  : wm + (size_t)(t - 4 * heads) * tm;
            bytes = OCAB ? (t < heads ? ta : tm) : t < 4 * heads ? ta : tm;
          }
          const uint32_t st = i % FWD_STAGES, use = i / FWD_STAGES;
          if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
          mbar_arrive_expect_tx(&full[st], bytes);
          bulk_load(fsm + L.ring + st * L.slot, src, bytes, &full[st]);
        }
    }
    if constexpr (OCAB) {
      // warps 1-3: per (pair, head), each live window's q, k and v of the
      // head into its next stage
      const int gt = tid - nw * 128 - 32;
      if (gt >= 0) {
        uint32_t it = 0;
        for (int pr = blockIdx.x; pr < npairs; pr += gridDim.x)
          for (int hh = 0; hh < heads; ++hh, ++it) {
            const int st = it % L.ns, base = (hh * hd) & ~1;
            const uint32_t use = it / L.ns;
            for (int w = 0; w < nw && pr * nw + w < p.bw; ++w) {
              const size_t win = (size_t)pr * nw + w;
              if (use > 0) mbar_wait(&gempty[w * L.ns + st], (use - 1) & 1);
              unsigned char* stg = fsm + L.ring + FWD_STAGES * L.slot + w * L.win + L.q +
                                   st * L.stage;
              fetch_head<HP, OC_GATHER>(stg, oc.q + win * N * CIO, N, N, CIO, base, CIO,
                                        gt);
              fetch_head<HP, OC_GATHER>(stg + N * HP * 2, oc.k + win * oc.nk * CIO, oc.nk,
                                        OC_KEYS, CIO, base, CIO, gt);
              fetch_head<HP, OC_GATHER>(stg + (N + OC_KEYS) * HP * 2, oc.v + win * oc.nk * CIO,
                                        oc.nk, OC_KEYS, CIO, base, CIO, gt);
              mbar_arrive_cp_async(&gfull[w * L.ns + st]);  // once this thread's copies land
            }
          }
      }
    }
    return;
  }

  // consumer warpgroup wgi
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(OCAB ? 224 : 232) : "memory");
  const int wt = tid & 127, wi = wt >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * wi;  // the warp's 16 rows of the window
  unsigned char* wb = fsm + L.ring + FWD_STAGES * L.slot + (size_t)wgi * L.win;
  unsigned char *a_s = wb + L.a, *x_s = wb + L.x, *q_s = wb + L.q, *k_s = wb + L.k,
                *v_s = wb + L.v;
  bf16* xd = reinterpret_cast<bf16*>(x_s);
  const bf16* cxd = reinterpret_cast<const bf16*>(wb + L.cx);
  const float qscale = round_bf16(p.scale);
  auto wg_sync = [&] { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory"); };
  auto proxy_fence = [] { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); };
  uint32_t tc = 0;  // ring tiles consumed so far
  auto tile = [&](int j) { return fsm + L.ring + ((tc + j) % FWD_STAGES) * L.slot; };
  auto wait_tiles = [&](int n) {
    for (int j = 0; j < n; ++j)
      mbar_wait(&full[(tc + j) % FWD_STAGES], ((tc + j) / FWD_STAGES) & 1);
  };
  auto release_tiles = [&](int n) {
    if (lane == 0)
      for (int j = 0; j < n; ++j) mbar_arrive(&empty[(tc + j) % FWD_STAGES]);
    tc += n;
  };
  // the dense (64, w) window in x_s to global memory in 16-byte runs
  auto store_window = [&](bf16* dst, int w) {
    const uint4* s4 = reinterpret_cast<const uint4*>(x_s);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = wt; i < N * w / 8; i += 128) d4[i] = s4[i];
  };

  uint32_t git = 0;  // OCAB: gather stages consumed
  for (int pr = blockIdx.x; pr < npairs; pr += gridDim.x) {
    const int win = pr * nw + wgi;
    const bool live = win < p.bw;
    const size_t row0 = (size_t)win * N;
    const float* mask =
        HAB && live && p.mask != nullptr ? p.mask + (size_t)(win % p.nmask) * N * N : nullptr;
    float d1 = 1.f, d2 = 1.f;  // K9a's branch scales
    if constexpr (HAB && STORE_H) {
      if (live && dp1 != nullptr) d1 = __ldg(dp1 + win);
      if (live && dp2 != nullptr) d2 = __ldg(dp2 + win);
    }

    if constexpr (STAGE == STAGE_MLPONLY) {
      // ---- x by 16-byte asynchronous copies, and no LN1
      if (live) {
        const bf16* xg = p.x + row0 * CIO;
        for (int i = wt; i < N * CIO / 8; i += 128) fwd_cp_async16(x_s + 16 * i, xg + 8 * i);
        cp_async_commit();
        cp_async_wait<0>();
        wg_sync();
      }
    } else if constexpr (OCAB) {
      // ---- x by 16-byte asynchronous copies (waited for at the residual);
      // per head: the gathered q, k, v, the scores over the nk keys, the
      // softmax, P . v, rounded, into a_s at the head's hp columns
      if (live) {
        const bf16* xg = p.x + row0 * CIO;
        for (int i = wt; i < N * CIO / 8; i += 128) fwd_cp_async16(x_s + 16 * i, xg + 8 * i);
        cp_async_commit();
        const int KO = heads * HP, nk = oc.nk;
        for (int hh = 0; hh < heads; ++hh, ++git) {
          // the scores' starting value: the bias, -inf past nk
          float s[OC_KEYS / 2];
          head_scores_start<OC_KEYS>(s, p.bias + (size_t)hh * N * nk, nk, nullptr, nk, r0, g,
                                     t4);
          const int st = git % L.ns;
          mbar_wait(&gfull[wgi * L.ns + st], (git / L.ns) & 1);
          proxy_fence();  // the stage's copies are read by wgmma
          const unsigned char* q_h = wb + L.q + st * L.stage;
          float ov[HP / 2];
          // the head's first slot: (hh hd) & 1
          head_attention<OC_KEYS, HP>(ov, s, q_h, q_h + N * HP * 2,
                                      q_h + (N + OC_KEYS) * HP * 2, qscale, (hh * hd) & 1, hd,
                                      r0, lane);
          __syncwarp();
          if (lane == 0) mbar_arrive(&gempty[wgi * L.ns + st]);  // this warp is done with it
#pragma unroll
          for (int jb = 0; jb < NB; ++jb)
#pragma unroll
            for (int s2 = 0; s2 < 2; ++s2)
              *reinterpret_cast<uint32_t*>(
                  a_s + kmaj(r0 + g + 8 * s2, hh * HP + 8 * jb + 2 * t4, KO)) =
                  pack_bf16(ov[4 * jb + 2 * s2], ov[4 * jb + 2 * s2 + 1]);
        }
        cp_async_wait<0>();
        proxy_fence();  // the attention outputs, written here, are read by wgmma
        wg_sync();      // x and every row of them in place
      }
    } else if (live) {
      // ---- x (and K5's conv_x) by 16-byte asynchronous copies; LN1 (two-pass
      // fp32 statistics over the cio real columns, warp wi: rows 16 wi ..,
      // four at a time) into a_s, zero past cio
      const bf16* xg = p.x + row0 * CIO;
      for (int i = wt; i < N * CIO / 8; i += 128) fwd_cp_async16(x_s + 16 * i, xg + 8 * i);
      if constexpr (HAB) {
        const bf16* cg = p.convx + row0 * CIO;
        for (int i = wt; i < N * CIO / 8; i += 128) fwd_cp_async16(wb + L.cx + 16 * i, cg + 8 * i);
      }
      cp_async_commit();
      cp_async_wait<0>();
      wg_sync();
      constexpr int RW = 4, NV = MAX_C / 32;
#pragma unroll 1
      for (int rr = r0; rr < r0 + 16; rr += RW) {
        float v[RW][NV], mu[RW], rstd[RW];
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int c = lane + 32 * i;
            v[q][i] = c < CIO ? __bfloat162float(xd[(rr + q) * CIO + c]) : 0.f;
            sum += v[q][i];
          }
          mu[q] = warp_sum(sum) / CIO;
        }
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          float sq = 0.f;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int c = lane + 32 * i;
            const float d = c < CIO ? v[q][i] - mu[q] : 0.f;
            sq += d * d;
          }
          rstd[q] = rsqrtf(warp_sum(sq) / CIO + 1e-5f);
        }
#pragma unroll
        for (int q = 0; q < RW; ++q)
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int c = lane + 32 * i;
            if (c < CK)
              *reinterpret_cast<bf16*>(a_s + kmaj(rr + q, c, CK)) = __float2bfloat16(
                  c < CIO
                      ? (v[q][i] - mu[q]) * rstd[q] * vec[F_LN1W * C + c] + vec[F_LN1B * C + c]
                      : 0.f);
          }
      }
      proxy_fence();  // LN1's output, written here, is read by wgmma
      wg_sync();
    }

    // ---- per head: q, k, v; the attention; proj into the residual h
    // (OCAB: proj of the attention outputs waiting in a_s, a tile a head;
    // NOATTN: q alone, whose bf16(q + bq) proj reads; MLPONLY: none)
    float h[NCH][32];
#pragma unroll
    for (int k = 0; k < NCH; ++k)
#pragma unroll
      for (int i = 0; i < 32; ++i) h[k][i] = 0.f;
    if constexpr (OCAB) {
      for (int hh = 0; hh < heads; ++hh) {
        wait_tiles(1);
        if (live) {
          const unsigned char* tp = tile(0);
#pragma unroll
          for (int k = 0; k < NCH; ++k) fence_regs(h[k]);
          wg_fence();
#pragma unroll
          for (int k = 0; k < NCH; ++k)
#pragma unroll
            for (int ks = 0; ks < HP / 16; ++ks)
              wgmma_n64<KMAJ, KMAJ>(h[k], desc(a_s + (hh * (HP / 16) + ks) * 256, 128,
                                               heads * CGS),
                                    desc(tp + k * 8 * CGS + ks * 256, 128, CGS), 1);
          wg_commit();
          wg_wait<0>();
#pragma unroll
          for (int k = 0; k < NCH; ++k) fence_regs(h[k]);
        }
        release_tiles(1);
      }
      if (live) wg_sync();  // the attention outputs are read before LN2's output lands there
    } else if constexpr (STAGE != STAGE_MLPONLY)
    for (int hh = 0; hh < heads; ++hh) {
      constexpr bool KV = STAGE != STAGE_NOATTN;
      wait_tiles(KV ? 3 : 1);
      float aq[HP / 2], ak[HP / 2], av[HP / 2];
      if (live) {
#pragma unroll
        for (int i = 0; i < HP / 2; ++i) aq[i] = ak[i] = av[i] = 0.f;
        fence_regs(aq);
        if constexpr (KV) {
          fence_regs(ak);
          fence_regs(av);
        }
        const unsigned char *tq = tile(0), *tk = tile(1), *tv = tile(2);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < CK / 16; ++ks) {
          const uint64_t da = desc(a_s + ks * 256, 128, CK * 16);
          fwd_mma_mn<HP>(aq, da, desc(tq + ks * 2 * CGS, CGS, 128));
          if constexpr (KV) {
            fwd_mma_mn<HP>(ak, da, desc(tk + ks * 2 * CGS, CGS, 128));
            fwd_mma_mn<HP>(av, da, desc(tv + ks * 2 * CGS, CGS, 128));
          }
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(aq);
        if constexpr (KV) {
          fence_regs(ak);
          fence_regs(av);
        }
      }
      release_tiles(KV ? 3 : 1);
      uint32_t af[HP / 16][4];  // the head's attention output as proj's A
      if constexpr (!KV) {
        if (live) {
          // NOATTN: bf16(q + bq), unscaled, zero past hd
          const float* bq = vec + F_BQKV * C + hh * hd;
#pragma unroll
          for (int i = 0; i < HP / 2; ++i) {
            const int d = 8 * (i >> 2) + 2 * t4 + (i & 1);
            aq[i] = d < hd ? round_bf16(aq[i] + bq[d]) : 0.f;
          }
#pragma unroll
          for (int ks = 0; ks < HP / 16; ++ks) acc_to_a(af[ks], aq, ks);
        }
      } else if (live) {
        // q = bf16(bf16(acc + b) * scale), k, v = bf16(acc + b); zero past hd
        const float* bq = vec + F_BQKV * C + hh * hd;
#pragma unroll
        for (int jb = 0; jb < NB; ++jb)
#pragma unroll
          for (int s2 = 0; s2 < 2; ++s2) {
            const int r = r0 + g + 8 * s2, d = 8 * jb + 2 * t4, e = 4 * jb + 2 * s2;
            const bool real = d < hd;  // d and hd even: both columns or neither
            const int off = kmaj(r, d, HP);
            *reinterpret_cast<uint32_t*>(q_s + off) =
                real ? pack_bf16(round_bf16(aq[e] + bq[d]) * qscale,
                                 round_bf16(aq[e + 1] + bq[d + 1]) * qscale)
                     : 0u;
            *reinterpret_cast<uint32_t*>(k_s + off) =
                real ? pack_bf16(ak[e] + bq[C + d], ak[e + 1] + bq[C + d + 1]) : 0u;
            *reinterpret_cast<uint32_t*>(v_s + off) =
                real ? pack_bf16(av[e] + bq[2 * C + d], av[e + 1] + bq[2 * C + d + 1]) : 0u;
          }
        proxy_fence();
        wg_sync();  // q, k, v of every row in place

        // scores: the bias (and K5's mask) as the accumulator's start, +
        // q . k^T
        const float* bh = p.bias + (size_t)hh * N * N;
        float s[32];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          float2 b0 = __ldg(reinterpret_cast<const float2*>(bh + (r0 + g) * N + t * 8 + t4 * 2));
          float2 b1 =
              __ldg(reinterpret_cast<const float2*>(bh + (r0 + g + 8) * N + t * 8 + t4 * 2));
          if (HAB && mask != nullptr) {
            const float2 m0 =
                __ldg(reinterpret_cast<const float2*>(mask + (r0 + g) * N + t * 8 + t4 * 2));
            const float2 m1 =
                __ldg(reinterpret_cast<const float2*>(mask + (r0 + g + 8) * N + t * 8 + t4 * 2));
            b0.x += m0.x;
            b0.y += m0.y;
            b1.x += m1.x;
            b1.y += m1.y;
          }
          s[4 * t] = b0.x;
          s[4 * t + 1] = b0.y;
          s[4 * t + 2] = b1.x;
          s[4 * t + 3] = b1.y;
        }
        fence_regs(s);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < HP / 16; ++ks)
          wgmma_n64<KMAJ, KMAJ>(s, desc(q_s + ks * 256, 128, CGS), desc(k_s + ks * 256, 128, CGS),
                                1);
        wg_commit();
        wg_wait<0>();
        fence_regs(s);
        // softmax over the 64 keys of each row (rows g and g + 8 of the warp;
        // a row's values lie in the 4 lanes of its quad), fp32
        float m0 = s[0], m1 = s[2];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          m0 = fmaxf(m0, fmaxf(s[4 * t], s[4 * t + 1]));
          m1 = fmaxf(m1, fmaxf(s[4 * t + 2], s[4 * t + 3]));
        }
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
        }
        float l0 = 0.f, l1 = 0.f;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          s[4 * t] = expf(s[4 * t] - m0);
          s[4 * t + 1] = expf(s[4 * t + 1] - m0);
          s[4 * t + 2] = expf(s[4 * t + 2] - m1);
          s[4 * t + 3] = expf(s[4 * t + 3] - m1);
          l0 += s[4 * t] + s[4 * t + 1];
          l1 += s[4 * t + 2] + s[4 * t + 3];
        }
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          l0 += __shfl_xor_sync(0xffffffffu, l0, o);
          l1 += __shfl_xor_sync(0xffffffffu, l1, o);
        }
        // one division a row, then products: a masked key's exp is
        // denormal, and dividing it takes the division's slow path
        const float i0 = 1.f / l0, i1 = 1.f / l1;
        uint32_t pa[4][4];
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
          pa[kb][0] = pack_bf16(s[8 * kb] * i0, s[8 * kb + 1] * i0);
          pa[kb][1] = pack_bf16(s[8 * kb + 2] * i1, s[8 * kb + 3] * i1);
          pa[kb][2] = pack_bf16(s[8 * kb + 4] * i0, s[8 * kb + 5] * i0);
          pa[kb][3] = pack_bf16(s[8 * kb + 6] * i1, s[8 * kb + 7] * i1);
        }
        float o[HP / 2];
#pragma unroll
        for (int i = 0; i < HP / 2; ++i) o[i] = 0.f;
        fence_regs(o);
        wg_fence();
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) fwd_mma_pv<HP>(o, pa[kb], desc(v_s + kb * 2 * CGS, CGS, 128));
        wg_commit();
        wg_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int ks = 0; ks < HP / 16; ++ks) acc_to_a(af[ks], o, ks);
      }
      wait_tiles(1);
      if (live) {
        const unsigned char* tp = tile(0);
#pragma unroll
        for (int k = 0; k < NCH; ++k) fence_regs(h[k]);
        wg_fence();
#pragma unroll
        for (int k = 0; k < NCH; ++k)
#pragma unroll
          for (int ks = 0; ks < HP / 16; ++ks)
            wgmma_n64_rs<KMAJ>(h[k], af[ks], desc(tp + k * 8 * CGS + ks * 256, 128, CGS), 1);
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int k = 0; k < NCH; ++k) fence_regs(h[k]);
      }
      release_tiles(1);
      if (live) wg_sync();  // q, k, v are read before the next head writes them
    }

    if constexpr (H32 || STAGE == STAGE_ATTNONLY) {
      // ---- K4b's recompute: h = x + (proj + bproj) in fp32 to h32, straight
      // from the accumulators (a quad writes 32 contiguous bytes of a row);
      // ATTNONLY: out = bf16(h), over x in x_s, then in 16-byte runs
      if (live) {
#pragma unroll
        for (int k = 0; k < NCH; ++k)
#pragma unroll
          for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
            for (int s2 = 0; s2 < 2; ++s2) {
              const int r = r0 + g + 8 * s2, col = k * TILE + 8 * j8 + 2 * t4;
              if (col < C) {  // col and c even: both columns are real
                __nv_bfloat162* px = reinterpret_cast<__nv_bfloat162*>(xd + r * C + col);
                const float2 x2 = __bfloat1622float2(*px);
                const float v0 = x2.x + (h[k][4 * j8 + 2 * s2] + vec[F_BPROJ * C + col]);
                const float v1 = x2.y + (h[k][4 * j8 + 2 * s2 + 1] + vec[F_BPROJ * C + col + 1]);
                if constexpr (H32)
                  *reinterpret_cast<float2*>(h32 + (row0 + r) * C + col) = make_float2(v0, v1);
                else
                  *px = __floats2bfloat162_rn(v0, v1);
              }
            }
        if constexpr (!H32) {
          wg_sync();
          store_window(p.out + row0 * C, C);
        }
        wg_sync();  // x_s is read before the next window's x lands there
      }
      continue;
    }

    // ---- the residual h = x + (proj + bproj) (+ conv_scale * conv_x) in
    // fp32; K2: bf16(h) over x in x_s and out as h_out; LN2 of bf16(h) into
    // a_s
    if (live) {
#pragma unroll
      for (int k = 0; k < NCH; ++k)
#pragma unroll
        for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
          for (int s2 = 0; s2 < 2; ++s2) {
            const int r = r0 + g + 8 * s2, col = k * TILE + 8 * j8 + 2 * t4;
            if (col < CIO) {  // col and cio even: both columns are real
              __nv_bfloat162* px = reinterpret_cast<__nv_bfloat162*>(xd + r * CIO + col);
              const float2 x2 = __bfloat1622float2(*px);
              float& v0 = h[k][4 * j8 + 2 * s2];
              float& v1 = h[k][4 * j8 + 2 * s2 + 1];
              if constexpr (STAGE == STAGE_MLPONLY) {  // h = x
                v0 = x2.x;
                v1 = x2.y;
              } else if constexpr (HAB && STORE_H) {  // K9a: the attention branch scaled
                v0 = x2.x + d1 * (v0 + vec[F_BPROJ * C + col]);
                v1 = x2.y + d1 * (v1 + vec[F_BPROJ * C + col + 1]);
              } else {
                v0 = x2.x + (v0 + vec[F_BPROJ * C + col]);
                v1 = x2.y + (v1 + vec[F_BPROJ * C + col + 1]);
              }
              if constexpr (HAB) {
                const float2 c2 = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(cxd + r * CIO + col));
                v0 += p.conv_scale * c2.x;
                v1 += p.conv_scale * c2.y;
              }
              if constexpr (STORE_H) *px = __floats2bfloat162_rn(v0, v1);
            }
          }
      if constexpr (STORE_H) {
        wg_sync();
        store_window(p.h_out + row0 * CIO, CIO);
      }
      // a row's columns lie in the 4 lanes of one quad: two-pass statistics
      // of bf16(h) over the cio real columns by quad shuffles
      float mu[2], rstd[2];
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        float acc2[2] = {0.f, 0.f};
#pragma unroll
        for (int k = 0; k < NCH; ++k)
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int col = k * TILE + 8 * (i >> 2) + 2 * t4 + (i & 1);
            if (col < CIO) {
              const float v = round_bf16(h[k][i]);
              const int s2 = (i >> 1) & 1;
              acc2[s2] += pass == 0 ? v : (v - mu[s2]) * (v - mu[s2]);
            }
          }
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2) {
          acc2[s2] += __shfl_xor_sync(0xffffffffu, acc2[s2], 1);
          acc2[s2] += __shfl_xor_sync(0xffffffffu, acc2[s2], 2);
          if (pass == 0) mu[s2] = acc2[s2] / CIO;
          else rstd[s2] = rsqrtf(acc2[s2] / CIO + 1e-5f);
        }
      }
#pragma unroll
      for (int k = 0; k < NCH; ++k)
#pragma unroll
        for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
          for (int s2 = 0; s2 < 2; ++s2) {
            const int r = r0 + g + 8 * s2, col = k * TILE + 8 * j8 + 2 * t4;
            float y[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = (round_bf16(h[k][4 * j8 + 2 * s2 + e]) - mu[s2]) * rstd[s2];
              y[e] = col + e < CIO ? v * vec[F_LN2W * C + col + e] + vec[F_LN2B * C + col + e]
                                   : 0.f;
            }
            *reinterpret_cast<uint32_t*>(a_s + kmaj(r, col, CK)) = pack_bf16(y[0], y[1]);
          }
      proxy_fence();
      wg_sync();  // LN2's output in place; h_out's reads of x_s done
      if constexpr (HAB && STORE_H) {
        // K9a: the MLP accumulates into h's registers, so a branch scale d2
        // other than 1 divides h by d2 before it and multiplies the sum
        // after (exact but for one fp32 rounding each way); d2 = 0 skips the
        // MLP and writes h
        if (d2 != 1.f && d2 != 0.f) {
#pragma unroll
          for (int k = 0; k < NCH; ++k)
#pragma unroll
            for (int i = 0; i < 32; ++i) h[k][i] /= d2;
        }
      }
    }

    // ---- the MLP, 64 hidden columns at a time: u = LN2 . w1 (+ b1), GELU
    // (ACT's activation), rounded, h += g . w2 with g from registers
    const float* b1s = vec + F_B1 * C;
    for (int j = 0; j < nj; ++j) {
      wait_tiles(2);
      if (live && d2 != 0.f) {
        const unsigned char *w1t = tile(0), *w2t = tile(1);
        float u[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) u[i] = 0.f;
        fence_regs(u);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < CK / 16; ++ks)
          wgmma_n64<KMAJ, MNMAJ>(u, desc(a_s + ks * 256, 128, CK * 16),
                                 desc(w1t + ks * 2048, 1024, 128), 1);
        wg_commit();
        wg_wait<0>();
        fence_regs(u);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hcol = j * TILE + 8 * (i >> 2) + 2 * t4 + (i & 1);
          u[i] = hcol < hidden ? activation<ACT>(u[i] + b1s[hcol]) : 0.f;
        }
        uint32_t ga[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) acc_to_a(ga[ks], u, ks);
#pragma unroll
        for (int k = 0; k < NCH; ++k) fence_regs(h[k]);
        wg_fence();
#pragma unroll
        for (int k = 0; k < NCH; ++k)
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_n64_rs<KMAJ>(h[k], ga[ks], desc(w2t + k * 8 * 1024 + ks * 256, 128, 1024), 1);
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int k = 0; k < NCH; ++k) fence_regs(h[k]);
      }
      release_tiles(2);
    }

    // ---- out = h + mlp + b2 (K9a: h + d2 * (mlp + b2)), rounded, through
    // x_s in 16-byte runs
    if (live) {
#pragma unroll
      for (int k = 0; k < NCH; ++k)
#pragma unroll
        for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
          for (int s2 = 0; s2 < 2; ++s2) {
            const int r = r0 + g + 8 * s2, col = k * TILE + 8 * j8 + 2 * t4;
            if constexpr (HAB && STORE_H) {
              if (col < CIO) {
                const float b2s = d2 != 0.f ? 1.f : 0.f;
                const float o0 = h[k][4 * j8 + 2 * s2] + b2s * vec[F_B2 * C + col];
                const float o1 = h[k][4 * j8 + 2 * s2 + 1] + b2s * vec[F_B2 * C + col + 1];
                *reinterpret_cast<__nv_bfloat162*>(xd + r * CIO + col) =
                    d2 != 0.f ? __floats2bfloat162_rn(d2 * o0, d2 * o1)
                              : __floats2bfloat162_rn(o0, o1);
              }
            } else if (col < CIO) {
              *reinterpret_cast<__nv_bfloat162*>(xd + r * CIO + col) = __floats2bfloat162_rn(
                  h[k][4 * j8 + 2 * s2] + vec[F_B2 * C + col],
                  h[k][4 * j8 + 2 * s2 + 1] + vec[F_B2 * C + col + 1]);
            }
          }
      wg_sync();
      store_window(p.out + row0 * CIO, CIO);
      wg_sync();  // x_s is read before the next window's x lands there
    }
  }
}

// K1 (STORE_H = false) and K2 (STORE_H = true)
template <int NCH, int HP, bool STORE_H>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    swin_fwd_wg_kernel(const __grid_constant__ FwdWgParams p, int nw) {
  extern __shared__ __align__(1024) unsigned char fsm[];
  fwd_wg_body<NCH, HP, STORE_H, false>(p, nw, fsm);
}

// K5
template <int NCH, int HP>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    hab_fwd_wg_kernel(const __grid_constant__ FwdWgParams p, int nw) {
  extern __shared__ __align__(1024) unsigned char fsm[];
  fwd_wg_body<NCH, HP, false, true>(p, nw, fsm);
}

// K9a: K5 with the h store and the branch scales dp1, dp2
template <int NCH, int HP>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    hab_fwd_h_wg_kernel(const __grid_constant__ FwdWgParams p, int nw, const float* dp1,
                        const float* dp2) {
  extern __shared__ __align__(1024) unsigned char fsm[];
  fwd_wg_body<NCH, HP, true, true>(p, nw, fsm, dp1, dp2);
}

// K4b's recompute: the forward up to the fp32 h, to h32
template <int NCH, int HP>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    swin_fwd_h32_wg_kernel(const __grid_constant__ FwdWgParams p, int nw, float* h32) {
  extern __shared__ __align__(1024) unsigned char fsm[];
  fwd_wg_body<NCH, HP, false, false, true>(p, nw, fsm, nullptr, nullptr, h32);
}

// K6 (STORE_H = false) and K10a (STORE_H = true): the OCAB tail
template <int NCH, int HP, bool STORE_H>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    ocab_fwd_wg_kernel(const __grid_constant__ FwdWgParams p, int nw,
                       const __grid_constant__ OcabIn oc) {
  extern __shared__ __align__(1024) unsigned char fsm[];
  fwd_wg_body<NCH, HP, STORE_H, false, false, true>(p, nw, fsm, nullptr, nullptr, nullptr, oc);
}

// The operands of K9a and K4b's recompute that K1, K2 and K5 do not take,
// passed as kernel arguments of their own.
struct FwdWgExtra {
  const float* dp1;  // K9a: (Bw,) or null
  const float* dp2;
  float* h32;        // K4b's recompute: (Bw, 64, c) fp32
};

inline bool fwd_aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// windows a block: two where they fit in 227 KB
inline int fwd_windows(int c, int cio, int heads, int hidden, bool hab) {
  return fwd_wg_layout(c, cio, heads, hidden, 2, hab).total <= 232448 ? 2 : 1;
}

// The packed weights (bf16 elements): the attention's tiles (*attn of them)
// then the MLP's.
inline size_t fwd_pack_elems(int c, int heads, int hidden, size_t* attn) {
  const FwdWgLayout L = fwd_wg_layout(c, c, heads, hidden, 1, false);
  *attn = (size_t)L.ck * L.hp * 4 * heads;
  return *attn + (size_t)L.ck * 64 * 2 * ((hidden + TILE - 1) / TILE);
}

inline bool fwd_widths_ok(int c, int heads, int hidden) {
  const int hd = heads > 0 ? c / heads : 0;
  return c > 0 && c <= MAX_C && c % 4 == 0 && heads > 0 && c % heads == 0 && hd <= DP &&
         hd % 2 == 0 && hidden > 0 && hidden % 4 == 0;
}

// Packs wqkv, wproj, w1 and w2 ((in, out) bf16 at width c) into wpack
// (fwd_pack_elems bf16, 16-byte aligned): two launches on `s`.
inline int pack_fwd_wg(const bf16* wqkv, const bf16* wproj, const bf16* w1, const bf16* w2,
                       int c, int heads, int hidden, bf16* wpack, cudaStream_t s) {
  if (!fwd_widths_ok(c, heads, hidden)) return (int)cudaErrorInvalidValue;
  if (!fwd_aligned(wpack, 16) || !fwd_aligned(wqkv, 2) || !fwd_aligned(wproj, 2) ||
      !fwd_aligned(w1, 2) || !fwd_aligned(w2, 2))
    return (int)cudaErrorMisalignedAddress;
  const FwdWgLayout L = fwd_wg_layout(c, c, heads, hidden, 1, false);
  size_t na = 0;
  const size_t nm = fwd_pack_elems(c, heads, hidden, &na) - na;
  attn_pack_kernel<<<(int)(na / 256 < 1024 ? na / 256 + 1 : 1024), 256, 0, s>>>(
      wqkv, wproj, c, heads, L.ck, L.hp, wpack);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlp_pack_kernel<<<(int)(nm / 256 < 1024 ? nm / 256 + 1 : 1024), 256, 0, s>>>(
      w1, w2, c, hidden, L.ck, wpack + na);
  return (int)cudaGetLastError();
}

template <typename Kernel, typename... Extra>
cudaError_t launch_fwd_wg(Kernel kernel, const FwdWgParams& p, int nw, bool hab, cudaStream_t s,
                          Extra... extra) {
  const FwdWgLayout L = fwd_wg_layout(p.c, p.cio, p.heads, p.hidden, nw, hab);
  if (L.total > 232448) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  // setmaxnreg moves registers between the warpgroups of a block: the
  // consumers' 232 need the 168 the compiler gives each thread at launch
  if (attr.numRegs < FWD_MIN_REGS) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int npairs = (p.bw + nw - 1) / nw;
  kernel<<<npairs < sms ? npairs : sms, (nw + 1) * 128, L.total, s>>>(p, nw, extra...);
  return cudaGetLastError();
}

template <bool STORE_H, bool HAB, bool H32, int NCH, int HP>
cudaError_t launch_fwd_wg_width(const FwdWgParams& p, int nw, cudaStream_t s,
                                const FwdWgExtra& e) {
  if constexpr (H32)
    return launch_fwd_wg(swin_fwd_h32_wg_kernel<NCH, HP>, p, nw, false, s, e.h32);
  else if constexpr (HAB && STORE_H)
    return launch_fwd_wg(hab_fwd_h_wg_kernel<NCH, HP>, p, nw, true, s, e.dp1, e.dp2);
  else if constexpr (HAB)
    return launch_fwd_wg(hab_fwd_wg_kernel<NCH, HP>, p, nw, true, s);
  else
    return launch_fwd_wg(swin_fwd_wg_kernel<NCH, HP, STORE_H>, p, nw, false, s);
}

// Checks the widths and alignments and launches the persistent kernel on
// the packed weights p.wattn, p.wmlp (pack_fwd_wg's; H32 streams only the
// attention's). `windows`: windows a block, 1 or 2; 0 takes as many as fit.
// K1, K2 and K4b's recompute (H32) take cio = c.
template <bool STORE_H, bool HAB, bool H32 = false>
int run_fwd_wg(FwdWgParams p, int windows, void* stream, const FwdWgExtra& e = {}) {
  const int c = p.c, cio = p.cio, heads = p.heads, hidden = p.hidden;
  if (p.bw <= 0 || !fwd_widths_ok(c, heads, hidden) || cio <= 0 || cio > c || cio % 2 != 0 ||
      (!HAB && cio != c) || (HAB && p.mask != nullptr && p.nmask <= 0) || windows < 0 ||
      windows > 2 || (H32 && (HAB || STORE_H || e.h32 == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (!fwd_aligned(p.x, 16) || !fwd_aligned(p.out, 16) || (STORE_H && !fwd_aligned(p.h_out, 16)) ||
      (HAB && (!fwd_aligned(p.convx, 16) || !fwd_aligned(p.mask, 8))) ||
      !fwd_aligned(p.bias, 8) || !fwd_aligned(p.wattn, 16) || !fwd_aligned(p.wmlp, 16) ||
      !fwd_aligned(e.h32, 8))
    return (int)cudaErrorMisalignedAddress;
  p.hd = c / heads;
  const int nw = windows > 0 ? windows : fwd_windows(c, cio, heads, hidden, HAB);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nch = (c + TILE - 1) / TILE;
  if (p.hd <= 16) {
    switch (nch) {
      case 1: return (int)launch_fwd_wg_width<STORE_H, HAB, H32, 1, 16>(p, nw, s, e);
      case 2: return (int)launch_fwd_wg_width<STORE_H, HAB, H32, 2, 16>(p, nw, s, e);
      case 3: return (int)launch_fwd_wg_width<STORE_H, HAB, H32, 3, 16>(p, nw, s, e);
      default: return (int)launch_fwd_wg_width<STORE_H, HAB, H32, 4, 16>(p, nw, s, e);
    }
  }
  switch (nch) {
    case 1: return (int)launch_fwd_wg_width<STORE_H, HAB, H32, 1, 32>(p, nw, s, e);
    case 2: return (int)launch_fwd_wg_width<STORE_H, HAB, H32, 2, 32>(p, nw, s, e);
    case 3: return (int)launch_fwd_wg_width<STORE_H, HAB, H32, 3, 32>(p, nw, s, e);
    default: return (int)launch_fwd_wg_width<STORE_H, HAB, H32, 4, 32>(p, nw, s, e);
  }
}

}  // namespace
