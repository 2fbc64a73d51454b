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
// What bounds it: 4 * 64 * nk * d FLOP per window and head against the
// bf16 q, k, v and output it must move: at d = 30, nk = 64 that is 15
// FLOP per byte, far under the H100's ~295, so byte-bound (Bw = 768, 6
// heads: 71 MB, 0.021 ms at 3.35 TB/s). On the H100 the gather sets the
// floor: q, k and v come in as 30- or 60-byte runs a row, each a 4-byte
// copy a slot pair, and the copies' issue, not the bytes, takes the time
// (tools/window_attention_ablation.py; PERF.md).
//
// Design (bf16). The work items are (window, head) pairs, item b heads + h,
// walked by a persistent grid of whole multiples of heads blocks (at most
// one an SM: 132 at 6 heads), each taking items blockIdx.x, + gridDim.x,
// ...: every item of a block is of one head, whose bias the block reads
// into shared memory once (16 KB at 64 keys, 36 KB at 144). A block has nc
// consumer warpgroups (two; three for K11b at 64 keys) and one producer
// warpgroup; consumer c takes the block's items c, c + nc, ... and owns a
// ring of ns = 4 stages, each one head's q (64 x hp), k and v (NK x hp, NK
// = 64 or 144 key rows) in the K-major interleaved layout at hp = 16 or 32
// slots. The producer's 128 threads gather each item into its consumer's
// next free stage by 4-byte cp.async straight from the strided views
// (fetch_head, swin_pack.cuh: one slot pair a thread, walking the rows; keys
// past nk zero), under mbarriers, so nc * ns items are in flight while the
// consumers compute. A head whose first element sits at an odd element
// address lands at slots 1 .. d: its copies start one column early (the
// element before the head, which lies in the same allocation, meets q's
// zero) and a pair that would reach past the head's last column copies 2
// bytes. The consumer runs the OCAB mode's attention (attn_head_wg.cuh,
// shared with swin_fwd_wg.cuh's K6/K10a): the bias, plus K11b's mask[b %
// nW] read in place from the one (nW, 64, nk) tensor (never tiled over the
// batch; its loads from L2 are issued before the stage is awaited, and the
// third consumer hides them), as the scores' starting accumulator, q from
// registers scaled and masked to the head's slots, the scores on wgmma (m64
// x n64 or n144), the fp32 softmax with one reciprocal a row, P packed once
// for every k16 step, P . v on wgmma. A warp's 16 output rows are one
// contiguous run of 32 d bytes of the contiguous out (16-byte aligned): the
// warp stages them densely in shared memory and writes them with 16-byte
// stores.
//
// Shared device functions, not an attention-only mode of fwd_wg_body: that
// body's pass is a window with every head in series, behind a weight ring,
// vector staging and the residual, none of which K11 has; its items are
// (window, head) pairs with no weights, so a mode would leave the body dead
// around a different loop.
//
// The wrapper (kernels/window_attention.py::gather_plan) sends the modules'
// views (row strides 3C, C or 2C, all even) in as they are; a view whose
// row stride is odd, whose columns are not contiguous, whose heads need
// more than 32 slots, or whose q and k heads start at different parities
// is first copied on the device into a (Bw, heads, rows, d rounded up to
// even) buffer. window_attention_run checks what the plan guarantees.
//
// fp32: one head at a time on the CUDA cores (one block a window), q, k
// and v in shared memory, one warp per query row: lane j holds the scores
// of keys j, j+32, ..., one reciprocal a row, and lane d sums P.V's column
// d.

#include "attn_head_wg.cuh"

using namespace swin;

namespace {

constexpr int MAX_KEYS = 144;          // nine key tiles of 16
constexpr int WA_GATHER = 128;         // the producer's gathering threads (after the consumers)
constexpr int WA_OUT = 16 * DP * 2;    // a warp's output staging: 16 rows of d <= 32 bf16
constexpr int SMEM_MAX = 232448;       // 227 KB a block
constexpr int LDF = DP + 1;            // fp32 row stride: lanes on distinct banks

// consumer warpgroups a block and stages a consumer, measured on the H100
// (tools/window_attention_ablation.py): a third consumer hides K11b's mask
// reads from L2 and slows the mask-less shapes; at 144 keys the scores keep
// 72 fp32 registers a thread and their probabilities 36, so the block stays
// at 384 threads (168 registers each)
template <int NK, bool HAS_MASK>
constexpr int consumers() { return NK == 64 && HAS_MASK ? 3 : 2; }
constexpr int WA_STAGES = 4;

struct WgParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  long long sq[3], sk[3], sv[3];  // element strides of (Bw, heads, rows); columns contiguous
  const float* bias;              // (heads, 64, nk)
  const float* mask;              // (nw, 64, nk), or null
  bf16* out;                      // (Bw, heads, 64, d), contiguous
  int bw, heads, hd, nk, nw;
  int nc, ns;                     // consumer warpgroups a block, stages a consumer
  float scale;
};

// a stage: one head's q (64 x hp), k and v (nk_rows x hp each)
__host__ __device__ inline size_t wg_stage(int nk_rows, int hp) {
  return (size_t)(N + 2 * nk_rows) * hp * 2;
}

// the block's head's bias in shared memory: 64 rows of nk_rows + 8 fp32
// (the padding puts a warp's float2 reads of 8 rows on distinct banks)
__host__ __device__ constexpr int wg_ldb(int nk_rows) { return nk_rows + 8; }

// the block's dynamic shared memory: nc ns stages, the bias, a staging of 16
// output rows a consumer warp, the stages' two mbarriers
__host__ __device__ inline size_t wg_smem(int nk_rows, int hp, int nc, int ns) {
  return nc * ns * wg_stage(nk_rows, hp) + sizeof(float) * N * wg_ldb(nk_rows) +
         (size_t)nc * 4 * WA_OUT + 2 * (size_t)nc * ns * sizeof(uint64_t);
}

// head (b, h) of t: its first column, moved back one element when that one
// is not 4-byte aligned (*o = 1: the head lands at slots 1 .. d)
__device__ __forceinline__ const bf16* head_at(const bf16* t, const long long (&s)[3],
                                               long long b, int h, int* o) {
  const bf16* p = t + b * s[0] + h * s[1];
  *o = (int)((reinterpret_cast<uintptr_t>(p) >> 1) & 1);
  return p - *o;
}

template <int NK, int HP, bool HAS_MASK>
__global__ void __launch_bounds__(128 * consumers<NK, HAS_MASK>() + WA_GATHER, 1)
    attn_wg_kernel(const __grid_constant__ WgParams p) {
  using namespace hopper;
  extern __shared__ __align__(1024) unsigned char smem[];
  const size_t stage = wg_stage(NK, HP);
  const int nc = p.nc, ns = p.ns, heads = p.heads, hd = p.hd, nk = p.nk;
  constexpr int LDB = wg_ldb(NK);
  float* bias_s = reinterpret_cast<float*>(smem + (size_t)nc * ns * stage);
  unsigned char* outs = reinterpret_cast<unsigned char*>(bias_s + N * LDB);
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + (size_t)nc * 4 * WA_OUT);
  uint64_t* empty = full + nc * ns;
  const int tid = threadIdx.x, wgi = tid >> 7;
  if (tid == 0) {
    for (int i = 0; i < nc * ns; ++i) {
      mbar_init(&full[i], WA_GATHER);  // every gathering thread, once its copies land
      mbar_init(&empty[i], 4);         // every warp of the stage's consumer
    }
    mbar_fence_init();
  }
  // the grid is a multiple of heads: every item of the block is of head
  // blockIdx.x % heads, whose bias waits in shared memory for all of them
  const int hb = blockIdx.x % heads;
  for (int i = tid; i < N * nk; i += blockDim.x) {
    const int r = i / nk;
    bias_s[r * LDB + i - r * nk] = __ldg(p.bias + (size_t)hb * N * nk + i);
  }
  __syncthreads();
  const long long items = (long long)p.bw * heads;

  if (wgi >= nc) {
    // producer: the block's items in order, each into its consumer's next
    // stage once that consumer has released it
    const int pt = tid - nc * 128;
    long long it = blockIdx.x;
    for (int kk = 0; it < items; ++kk, it += gridDim.x) {
      const int j = kk / nc, idx = (kk - j * nc) * ns + j % ns, use = j / ns;
      if (use > 0) mbar_wait(&empty[idx], (use - 1) & 1);
      const long long b = it / heads;
      const int h = (int)(it - b * heads);
      unsigned char* stg = smem + idx * stage;
      int o;
      const bf16* src = head_at(p.q, p.sq, b, h, &o);
      fetch_head<HP, WA_GATHER, true>(stg, src, N, N, (int)p.sq[2], 0, o + hd, pt);
      src = head_at(p.k, p.sk, b, h, &o);
      fetch_head<HP, WA_GATHER, true>(stg + N * HP * 2, src, nk, NK, (int)p.sk[2], 0, o + hd,
                                      pt);
      src = head_at(p.v, p.sv, b, h, &o);
      fetch_head<HP, WA_GATHER, true>(stg + (N + NK) * HP * 2, src, nk, NK, (int)p.sv[2], 0,
                                      o + hd, pt);
      mbar_arrive_cp_async(&full[idx]);  // once this thread's copies land
    }
    return;
  }

  // consumer warpgroup wgi
  const int wi = (tid & 127) >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * wi;  // the warp's 16 rows of the window
  bf16* ost = reinterpret_cast<bf16*>(outs + (wgi * 4 + wi) * WA_OUT);
  const float qscale = round_bf16(p.scale);
  long long it = blockIdx.x + (long long)wgi * gridDim.x;
  for (int j = 0; it < items; ++j, it += (long long)nc * gridDim.x) {
    const int idx = wgi * ns + j % ns;
    const long long b = it / heads;
    const int h = (int)(it - b * heads);
    // the scores' start: the block's bias, plus the mask, whose loads from
    // L2 are in flight while the stage is awaited
    float s[NK / 2];
    head_scores_start<NK, true>(s, bias_s, LDB,
                                HAS_MASK ? p.mask + (size_t)(b % p.nw) * N * nk : nullptr, nk,
                                r0, g, t4);
    int o, ov;  // the first slots of q's (and k's) head and of v's
    head_at(p.q, p.sq, b, h, &o);
    head_at(p.v, p.sv, b, h, &ov);
    mbar_wait(&full[idx], (j / ns) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the copies, read by wgmma
    const unsigned char* q_h = smem + idx * stage;
    float acc[HP / 2];
    head_attention<NK, HP>(acc, s, q_h, q_h + N * HP * 2, q_h + (N + NK) * HP * 2, qscale, o, hd,
                           r0, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[idx]);  // this warp is done with the stage
    // the warp's rows r0 .. r0 + 15, d columns each, dense in its staging
    // (slot o_v + c is column c), then to out as 16-byte runs
#pragma unroll
    for (int jb = 0; jb < HP / 8; ++jb)
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * jb + 2 * t4 + e - ov;
          if (c >= 0 && c < hd)
            ost[(g + 8 * s2) * hd + c] = __float2bfloat16(acc[4 * jb + 2 * s2 + e]);
        }
    __syncwarp();
    const uint4* s4 = reinterpret_cast<const uint4*>(ost);
    uint4* d4 = reinterpret_cast<uint4*>(p.out + ((size_t)it * N + r0) * hd);
    for (int i = lane; i < 2 * hd; i += 32) d4[i] = s4[i];
    __syncwarp();  // the staging is read before the next item's rows land there
  }
}

struct F32Params {
  const float* q;
  const float* k;
  const float* v;
  long long sq[4], sk[4], sv[4];  // element strides of (Bw, heads, rows, d)
  const float* bias;              // (heads, 64, nk)
  const float* mask;              // (nw, 64, nk), or null
  float* out;                     // (Bw, heads, 64, d), contiguous
  int heads, hd, nk, nw;
  float scale;
};

__device__ __forceinline__ float at(const float* base, const long long (&s)[4], long long b, int h,
                                    int r, int d) {
  return base[b * s[0] + h * s[1] + r * s[2] + d * s[3]];
}

size_t smem_f32() { return sizeof(float) * ((N + 2 * MAX_KEYS) * LDF + NWARPS * MAX_KEYS); }

template <bool HAS_MASK>
__global__ void __launch_bounds__(THREADS) attn_f32_kernel(const F32Params p) {
  constexpr int KPL = (MAX_KEYS + 31) / 32;  // keys a lane scores
  extern __shared__ __align__(1024) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [N][LDF]
  float* ks = qs + N * LDF;                    // [MAX_KEYS][LDF]
  float* vs = ks + MAX_KEYS * LDF;             // [MAX_KEYS][LDF]
  float* ps = vs + MAX_KEYS * LDF;             // [NWARPS][MAX_KEYS] one row's probabilities
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int heads = p.heads, hd = p.hd, nk = p.nk;
  const long long b = blockIdx.x;
  const float* mw = HAS_MASK ? p.mask + (size_t)(b % p.nw) * N * nk : nullptr;
  float* out = p.out + (size_t)b * heads * N * hd;
  float* pw = ps + warp * MAX_KEYS;
  for (int head = 0; head < heads; ++head) {
    __syncthreads();  // the previous head's readers are done
    for (int i = tid; i < N * hd; i += THREADS) {
      const int r = i / hd, d = i - r * hd;
      qs[r * LDF + d] = at(p.q, p.sq, b, head, r, d) * p.scale;
    }
    for (int i = tid; i < nk * hd; i += THREADS) {
      const int r = i / hd, d = i - r * hd;
      ks[r * LDF + d] = at(p.k, p.sk, b, head, r, d);
      vs[r * LDF + d] = at(p.v, p.sv, b, head, r, d);
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
      // one reciprocal a row: a masked score exps to a denormal, and
      // dividing it takes the division's slow path
      const float inv = 1.f / warp_sum(l);
#pragma unroll
      for (int t = 0; t < KPL; ++t)
        if (lane + 32 * t < nk) pw[lane + 32 * t] = s[t] * inv;
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

template <typename Kernel, typename Params>
cudaError_t launch(Kernel kernel, const Params& p, int grid, int threads, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NK, int HP, bool HAS_MASK>
cudaError_t launch_wg(WgParams p, cudaStream_t stream) {
  p.nc = consumers<NK, HAS_MASK>();
  p.ns = WA_STAGES;
  while (p.ns > 1 && wg_smem(NK, HP, p.nc, p.ns) > SMEM_MAX) --p.ns;  // where four do not fit
  const size_t smem = wg_smem(NK, HP, p.nc, p.ns);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // a grid of whole multiples of heads (one head a block), at most one
  // block an SM, and no more blocks than give every consumer an item
  const long long items = (long long)p.bw * p.heads;
  const long long want = (items + p.nc - 1) / p.nc;
  const long long per = (want < sms ? want : sms) / p.heads;
  const int grid = (int)(per > 0 ? per : 1) * p.heads;
  return launch(attn_wg_kernel<NK, HP, HAS_MASK>, p, grid, 128 * p.nc + WA_GATHER, smem, stream);
}

template <bool HAS_MASK>
cudaError_t dispatch_wg(const WgParams& p, int hp, cudaStream_t stream) {
  if (p.nk <= 64)
    return hp == 16 ? launch_wg<64, 16, HAS_MASK>(p, stream)
                    : launch_wg<64, 32, HAS_MASK>(p, stream);
  return hp == 16 ? launch_wg<MAX_KEYS, 16, HAS_MASK>(p, stream)
                  : launch_wg<MAX_KEYS, 32, HAS_MASK>(p, stream);
}

// the first column's parity of t's heads: (at head 0 of window 0, from
// window to window, from head to head), the last two 0 where that dimension
// has one entry
void parities(const void* t, const long long* s, int bw, int heads, int (&par)[3]) {
  par[0] = (int)((reinterpret_cast<uintptr_t>(t) >> 1) & 1);
  par[1] = bw > 1 ? (int)(s[0] & 1) : 0;
  par[2] = heads > 1 ? (int)(s[1] & 1) : 0;
}

// the bf16 gather's conditions (gather_plan's): every row 4-byte aligned and
// its columns contiguous, q's and k's heads at the same parity, every head
// within hp slots
bool gather_ok(const void* const (&t)[3], const long long* strides, int bw, int heads, int hd,
               int hp) {
  int par[3][3];
  for (int i = 0; i < 3; ++i) {
    const long long* s = strides + 4 * i;
    if ((hd > 1 && s[3] != 1) || s[2] % 2 != 0) return false;
    parities(t[i], s, bw, heads, par[i]);
    if (hd + (par[i][0] | par[i][1] | par[i][2]) > hp) return false;
  }
  return par[0][0] == par[1][0] && par[0][1] == par[1][1] && par[0][2] == par[1][2];
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

// C entry point, bound with ctypes; returns a cudaError_t. q (bw, heads, nq,
// hd) and k, v (bw, heads, nk, hd), bf16 when is_bf16 else fp32, addressed
// through strides[12] (q's four element strides, then k's, then v's); bias
// (heads, nq, nk) fp32; mask (nw, nq, nk) fp32 or null; out (bw, heads, nq,
// hd) contiguous, in q's dtype. Takes nq = 64, hd <= 32, even nk <= 144.
// bf16: hp (16 or 32) the slots a head takes, q, k and v as gather_plan
// leaves them (even row strides, contiguous columns, q's and k's heads at
// the same parity, each within hp slots), out 16-byte aligned.
extern "C" int window_attention_run(const void* q, const void* k, const void* v,
                                    const long long* strides, const void* bias, const void* mask,
                                    void* out, int bw, int heads, int nq, int nk, int hd, int nw,
                                    float scale, int is_bf16, int hp, void* stream) {
  if (bw <= 0 || heads <= 0 || nq != N || hd <= 0 || hd > DP || nk <= 0 || nk > MAX_KEYS ||
      nk % 2 != 0 || (mask != nullptr && (nw <= 0 || bw % nw != 0)))
    return (int)cudaErrorInvalidValue;
  // bias and mask rows are read as float2
  if (!aligned(bias, 8) || !aligned(mask, 8)) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const void* const t[3] = {q, k, v};
    if ((hp != 16 && hp != 32) || !gather_ok(t, strides, bw, heads, hd, hp))
      return (int)cudaErrorInvalidValue;
    if (!aligned(out, 16)) return (int)cudaErrorMisalignedAddress;
    WgParams p = {};
    p.q = static_cast<const bf16*>(q);
    p.k = static_cast<const bf16*>(k);
    p.v = static_cast<const bf16*>(v);
    for (int i = 0; i < 3; ++i) {
      p.sq[i] = strides[i];
      p.sk[i] = strides[4 + i];
      p.sv[i] = strides[8 + i];
    }
    p.bias = static_cast<const float*>(bias);
    p.mask = static_cast<const float*>(mask);
    p.out = static_cast<bf16*>(out);
    p.bw = bw;
    p.heads = heads;
    p.hd = hd;
    p.nk = nk;
    p.nw = nw;
    p.scale = scale;
    return (int)(mask != nullptr ? dispatch_wg<true>(p, hp, st) : dispatch_wg<false>(p, hp, st));
  }
  F32Params p = {};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  for (int i = 0; i < 4; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[4 + i];
    p.sv[i] = strides[8 + i];
  }
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.out = static_cast<float*>(out);
  p.heads = heads;
  p.hd = hd;
  p.nk = nk;
  p.nw = nw;
  p.scale = scale;
  return (int)(mask != nullptr ? launch(attn_f32_kernel<true>, p, bw, THREADS, smem_f32(), st)
                               : launch(attn_f32_kernel<false>, p, bw, THREADS, smem_f32(), st));
}
