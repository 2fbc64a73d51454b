// K6: HAT's overlapping cross-attention block tail (OCAB, inference) for
// Hopper, bf16 in and out, and K10a, the same tail for training.
//
// K6 replaces the TPU kernel superresolution_def_tpu/kernels/ocab.py::
// fused_ocab_block (kernel body _make_ocab_kernel); K10a replaces
// superresolution_def_tpu/kernels/ocab_train.py::_ocab_fwd_h (kernel body
// _make_ocab_fwd_h_kernel), which is K6 that also writes h = x + proj,
// rounded to bf16, for the backward (ocab_train.cu). Per 8x8 query window:
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
// softmax with weight exp(bias), as in the reference. Keys past nk start
// at -inf.
//
// Both are the OCAB mode of K1's wgmma body, ocab_fwd_wg_kernel<NCH, HP,
// STORE_H> (swin_fwd_wg.cuh says how): persistent blocks of two windows
// (one where two do not fit in 227 KB), the heads' wproj tiles and the MLP's
// streamed by TMA through an mbarrier ring, q, k and v gathered per head by
// the producer warpgroup into a ring of stages, every product on wgmma. The
// wrapper pads the weights' channels to c (HAT's C = 90 to 96) while the
// windows keep their cio = 90 columns in device memory and LN2 its
// statistics over them; the weights come packed (ocab_block_pack_bf16):
// each head's wproj rows at the slots its gathered q, k, v take.
//
// What bounds it: 12.65 MFLOP per window (2 x 64 x 144 x 90 for QK^T and PV
// each, proj and the MLP) against the 2 x 144 x 90 bf16 keys and values, the
// query, shortcut and output windows it must read and write (86.4 KB per
// window): about 146 FLOP per byte, under the H100's ~295 FLOP/byte, so
// byte-bound at its peaks. K10a writes 11.5 KB more per window (h), and
// stays byte-bound.

#include "swin_fwd_wg.cuh"

using namespace swin;

namespace {

// windows a block and gather stages a window: the most that fit in 227 KB,
// two windows first
bool ocab_fit(int c, int cio, int heads, int hidden, int* nw, int* ns) {
  const int options[4][2] = {{2, 2}, {2, 1}, {1, 2}, {1, 1}};
  for (const auto& o : options)
    if (ocab_wg_layout(c, cio, heads, hidden, o[0], o[1]).total <= 232448) {
      *nw = o[0];
      *ns = o[1];
      return true;
    }
  *nw = *ns = 1;
  return false;
}

// the packing's tile widths: ck (c rounded up to 64) and hp (16 or 32 slots
// a head)
int ocab_ck(int c) { return (c + TILE - 1) / TILE * TILE; }
int ocab_hp(int cio, int heads) { return cio / heads <= 16 ? 16 : 32; }

size_t ocab_pack_attn(int c, int cio, int heads) {
  return (size_t)ocab_ck(c) * ocab_hp(cio, heads) * 4 * heads;
}

bool ocab_widths_ok(int c, int cio, int heads, int hidden) {
  return c > 0 && c <= MAX_C && c % 16 == 0 && cio > 0 && cio <= c && cio % 2 == 0 &&
         heads > 0 && cio % heads == 0 && cio / heads <= 32 && hidden > 0 && hidden % 4 == 0;
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <int NCH, int HP, bool STORE_H>
cudaError_t launch(const FwdWgParams& p, int nw, const OcabIn& oc, cudaStream_t s) {
  const auto kernel = ocab_fwd_wg_kernel<NCH, HP, STORE_H>;
  const FwdWgLayout L = ocab_wg_layout(p.c, p.cio, p.heads, p.hidden, nw, oc.ns);
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
  kernel<<<npairs < sms ? npairs : sms, (nw + 1) * 128, L.total, s>>>(p, nw, oc);
  return cudaGetLastError();
}

template <bool STORE_H, int HP>
cudaError_t launch_width(const FwdWgParams& p, int nw, const OcabIn& oc, cudaStream_t s) {
  switch ((p.c + TILE - 1) / TILE) {
    case 1: return launch<1, HP, STORE_H>(p, nw, oc, s);
    case 2: return launch<2, HP, STORE_H>(p, nw, oc, s);
    case 3: return launch<3, HP, STORE_H>(p, nw, oc, s);
    default: return launch<4, HP, STORE_H>(p, nw, oc, s);
  }
}

template <bool STORE_H>
int run_ocab(const void* x, const void* q, const void* k, const void* v, const void* bias,
             const void* bproj, const void* ln2_w, const void* ln2_b, const void* b1,
             const void* b2, const void* wpack, void* out, void* h, int bw, int nk, int c,
             int cio, int heads, int hidden, float scale, void* stream) {
  if (bw <= 0 || nk <= 0 || nk > OC_KEYS || nk % 2 != 0 ||
      !ocab_widths_ok(c, cio, heads, hidden))
    return (int)cudaErrorInvalidValue;
  int nw = 1, ns = 1;
  if (!ocab_fit(c, cio, heads, hidden, &nw, &ns)) return (int)cudaErrorInvalidValue;
  if (!aligned(x, 16) || !aligned(out, 16) || (STORE_H && !aligned(h, 16)) || !aligned(q, 4) ||
      !aligned(k, 4) || !aligned(v, 4) || !aligned(bias, 8) || !aligned(wpack, 16))
    return (int)cudaErrorMisalignedAddress;
  FwdWgParams p = {};
  p.x = static_cast<const bf16*>(x);
  p.bias = static_cast<const float*>(bias);
  p.bproj = static_cast<const float*>(bproj);
  p.ln2_w = static_cast<const float*>(ln2_w);
  p.ln2_b = static_cast<const float*>(ln2_b);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.wattn = static_cast<const bf16*>(wpack);
  p.wmlp = p.wattn + ocab_pack_attn(c, cio, heads);
  p.out = static_cast<bf16*>(out);
  p.h_out = static_cast<bf16*>(h);
  p.c = c;
  p.cio = cio;
  p.heads = heads;
  p.hd = cio / heads;
  p.hidden = hidden;
  p.bw = bw;
  p.scale = scale;
  const OcabIn oc = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), nk, ns};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(ocab_hp(cio, heads) == 16 ? launch_width<STORE_H, 16>(p, nw, oc, s)
                                         : launch_width<STORE_H, 32>(p, nw, oc, s));
}

}  // namespace

// C entry points, bound with ctypes; each returns a cudaError_t. x, q and out
// (and K10a's h) are (bw, 64, cio) bf16, k and v (bw, nk, cio) bf16, bias
// (heads, 64, nk) fp32; the vectors fp32 zero-padded from cio to c (hidden
// for b1); wpack ocab_block_pack_bf16's packing.

// The weights packed for K6 and K10a into wpack (ocab_block_pack_elems
// bf16, 16-byte aligned): per head four ck x hp tiles of attn_pack_kernel's
// layout, of which the kernels stream only wproj's, then mlp_pack_kernel's
// tiles; two launches on `stream`. wslots (cs, cs) bf16, cs = heads x hs:
// wproj's rows at the slots the kernels' gather puts each head's channels
// in (head h's hd rows at h hs + ((h hd) & 1)), zero elsewhere; wzero (cs,
// 3 cs) bf16 zeros for the tiles never streamed; w1 (c, hidden) and w2
// (hidden, c) bf16 at the padded width c.
extern "C" int ocab_block_pack_bf16(const void* wslots, const void* wzero, const void* w1,
                                    const void* w2, int cs, int c, int cio, int heads,
                                    int hidden, void* wpack, void* stream) {
  if (!ocab_widths_ok(c, cio, heads, hidden) || cs <= 0 || cs % heads != 0 ||
      cs / heads > ocab_hp(cio, heads))
    return (int)cudaErrorInvalidValue;
  if (!aligned(wpack, 16) || !aligned(wslots, 2) || !aligned(wzero, 2) || !aligned(w1, 2) ||
      !aligned(w2, 2))
    return (int)cudaErrorMisalignedAddress;
  const int ck = ocab_ck(c);
  const size_t na = ocab_pack_attn(c, cio, heads);
  const size_t nm = (size_t)ck * 64 * 2 * ((hidden + TILE - 1) / TILE);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* out = static_cast<bf16*>(wpack);
  attn_pack_kernel<<<(int)(na / 256 < 1024 ? na / 256 + 1 : 1024), 256, 0, s>>>(
      static_cast<const bf16*>(wzero), static_cast<const bf16*>(wslots), cs, heads, ck,
      ocab_hp(cio, heads), out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlp_pack_kernel<<<(int)(nm / 256 < 1024 ? nm / 256 + 1 : 1024), 256, 0, s>>>(
      static_cast<const bf16*>(w1), static_cast<const bf16*>(w2), c, hidden, ck, out + na);
  return (int)cudaGetLastError();
}

extern "C" size_t ocab_block_pack_elems(int c, int cio, int heads, int hidden) {
  if (!ocab_widths_ok(c, cio, heads, hidden)) return 0;
  return ocab_pack_attn(c, cio, heads) +
         (size_t)ocab_ck(c) * 64 * 2 * ((hidden + TILE - 1) / TILE);
}

// K6 on weights packed by ocab_block_pack_bf16.
extern "C" int ocab_block_bf16(const void* x, const void* q, const void* k, const void* v,
                               const void* bias, const void* bproj, const void* ln2_w,
                               const void* ln2_b, const void* b1, const void* b2,
                               const void* wpack, void* out, int bw, int nk, int c, int cio,
                               int heads, int hidden, float scale, void* stream) {
  return run_ocab<false>(x, q, k, v, bias, bproj, ln2_w, ln2_b, b1, b2, wpack, out, nullptr, bw,
                         nk, c, cio, heads, hidden, scale, stream);
}

// K10a: as ocab_block_bf16, plus h = x + proj (bw, 64, cio) bf16.
extern "C" int ocab_block_fwd_h_bf16(const void* x, const void* q, const void* k, const void* v,
                                     const void* bias, const void* bproj, const void* ln2_w,
                                     const void* ln2_b, const void* b1, const void* b2,
                                     const void* wpack, void* out, void* h, int bw, int nk,
                                     int c, int cio, int heads, int hidden, float scale,
                                     void* stream) {
  return run_ocab<true>(x, q, k, v, bias, bproj, ln2_w, ln2_b, b1, b2, wpack, out, h, bw, nk, c,
                        cio, heads, hidden, scale, stream);
}

// Dynamic shared memory one block takes at padded width c (more than 227
// KB: the widths do not fit).
extern "C" size_t ocab_block_smem_bytes(int c, int cio, int heads, int hidden) {
  if (!ocab_widths_ok(c, cio, heads, hidden)) return ~(size_t)0;
  int nw = 1, ns = 1;
  ocab_fit(c, cio, heads, hidden, &nw, &ns);
  return ocab_wg_layout(c, cio, heads, hidden, nw, ns).total;
}

// Windows a block (1 or 2) and gather stages a window, as nw * 10 + ns.
extern "C" int ocab_block_shape(int c, int cio, int heads, int hidden) {
  int nw = 1, ns = 1;
  if (!ocab_widths_ok(c, cio, heads, hidden) || !ocab_fit(c, cio, heads, hidden, &nw, &ns))
    return 0;
  return nw * 10 + ns;
}
