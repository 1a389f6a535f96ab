// FiLM-modulated SwiGLU residual layer, backward, for Hopper (K3).
//
// Replaces the Pallas TPU kernel osu_dreamer_tpu/ops/film_layer.py
// `_bwd_kernel` (launched by `_fused_film_layer_bwd_impl`). The forward
// (csrc/film_layer.cu, K2) is, per position,
//
//   h1  = rms(x) * g1 * (1 + scale) + shift,  zero outside [0, L)
//   y   = dwconv(h1);  [v|g] = y W_vg + b_vg;  s = v * silu(g)
//   hn  = rms_H(s);    o = hn W_out + b_out
//   out = x + rms(o) * g2 * (1 + gate)
//
// and this call returns dx and all eleven parameter / FiLM gradients. On the
// main path it is every FilmStack layer of latent training (fit-latent):
// bf16 (64, L, 128), H = 341 (padded to 384), K = 5, at L = 1026 / 342 / 114
// / 38, 88 layers per step.
//
// What bounds it on the H100: per row 8 C H multiply-adds of the row
// products and 3 C H of the weight products, on the tensor cores (at C 128
// about 2,100 operations a byte of x and the output gradient), and the bf16
// scratch the weight products read (dvg, hn, y, do: 5 C H / 64 bytes a row).
// The design is the backward core of csrc/ffn_bwd_core.cuh (pass A on the
// forward core, the row statistics and the block norm's backward, pass B on
// a TMA weight ring with wgmma, the finish with the transposed conv and the
// FiLM and pre-norm backward), then the two weight products dW_vg = y^T dvg
// (C x 2 Hp) and dW_out = hn^T do (Hp x C), which the Pallas kernel forms in
// its own body, on csrc/gemm_tn.cuh (TMA + wgmma, split over row chunks,
// summed in a fixed order). The scratch holds the B L real rows only. The
// hidden dimension splits across CTAs where the rows alone do not fill the
// card (the short levels, L 114 and 38). Every sum over rows is a
// fixed-order partial: two runs give bit-identical gradients.
#include "ffn_bwd_core.cuh"
#include "gemm_tn.cuh"

namespace {

odt::BwdArgs film_args(const void* x, const void* go, const void* scale, const void* shift,
                       const void* gate, const void* g1, const void* g2, const void* dww,
                       const void* dwb, const void* bvg, const void* bout, void* dx, void* ws,
                       void* ss, void* y_s, void* do_s, void* rows, void* mid, void* dvg_s,
                       void* hn_s, void* dbvg, void* dy, void* fin, int B, int L, int C, int H,
                       int Hp, int K, int nwg, int SA, int SB) {
  using odt::bf16;
  odt::BwdArgs a{};
  a.x = (const bf16*)x;
  a.go = (const bf16*)go;
  a.scale = (const bf16*)scale;
  a.shift = (const bf16*)shift;
  a.gate = (const bf16*)gate;
  a.g1 = (const bf16*)g1;
  a.g2 = (const bf16*)g2;
  a.dww = (const bf16*)dww;
  a.dwb = (const bf16*)dwb;
  a.bvg = (const float*)bvg;
  a.bout = (const bf16*)bout;
  a.ws = (float*)ws;
  a.ss = (float*)ss;
  a.y = (bf16*)y_s;
  a.dout = (bf16*)do_s;
  a.rows = (float*)rows;
  a.mid = (float*)mid;
  a.dvg = (bf16*)dvg_s;
  a.hn = (bf16*)hn_s;
  a.dbvg = (float*)dbvg;
  a.dy = (float*)dy;
  a.fin = (float*)fin;
  a.dx = (bf16*)dx;
  a.B = B;
  a.L = L;
  a.BL = B * L;
  a.C = C;
  a.H = H;
  a.Hp = Hp;
  a.K = K;
  a.SA = SA;
  a.SB = SB;
  a.nwg = nwg;
  a.frows = odt::kBmRows;
  return a;
}

bool film_width(int C) { return C == 32 || C == 64 || C == 128 || C == 256 || C == 384; }

// the weight products dW_vg = y^T dvg (C x 2 Hp) and dW_out = hn^T do (Hp x C)
int film_weight_grads(const odt::BwdArgs& a, void* pvg, void* pout, void* dwvg, void* dwout,
                      int S_vg, int S_out, cudaStream_t s) {
  using namespace odt;
  int err = (int)gemm_tn_splitk(a.y, a.C, a.dvg, 2 * a.Hp, a.BL, a.C, 2 * a.Hp, S_vg, (float*)pvg,
                                (float*)dwvg, s);
  if (err != 0) return err;
  return (int)gemm_tn_splitk(a.hn, a.Hp, a.dout, a.C, a.BL, a.Hp, a.C, S_out, (float*)pout,
                             (float*)dwout, s);
}

}  // namespace

// The pack's b_vg (2 Hp, f32) and tensor maps (wmaps); b_out bf16 (C).
// dx (B, L, C) bf16; the workspace of the plan (nwg consumer warpgroups a
// CTA, SA and SB hidden slices): ws (SA, B L, C), ss (SA, B L), rows
// (B L, 2), mid (B, ceil(L / 32), 3, C), dbvg (tiles x nwg, 2 Hp), dy
// (SB, B L, C), fin (B, ceil(L / 32), 4 + K, C) f32; y_s, do_s (B L, C),
// dvg_s (B L, 2 Hp), hn_s (B L, Hp) bf16; the weight products' chunk
// partials pvg (S_vg, C, 2 Hp), pout (S_out, Hp, C) and their sums dwvg
// (C, 2 Hp), dwout (Hp, C) f32 in the padded layout.
extern "C" int odt_film_layer_bwd(const void* x, const void* go, const void* scale,
                                  const void* shift, const void* gate, const void* g1,
                                  const void* g2, const void* dww, const void* dwb,
                                  const void* bvg, const void* bout, const void* wmaps, void* dx,
                                  void* ws, void* ss, void* y_s, void* do_s, void* rows, void* mid,
                                  void* dvg_s, void* hn_s, void* dbvg, void* dy, void* fin,
                                  void* pvg, void* pout, void* dwvg, void* dwout, int B, int L,
                                  int C, int H, int Hp, int K, int nwg, int SA, int SB, int S_vg,
                                  int S_out, void* stream) {
  using namespace odt;
  if (!film_width(C)) return (int)cudaErrorInvalidValue;
  const BwdArgs a = film_args(x, go, scale, shift, gate, g1, g2, dww, dwb, bvg, bout, dx, ws, ss,
                              y_s, do_s, rows, mid, dvg_s, hn_s, dbvg, dy, fin, B, L, C, H, Hp, K,
                              nwg, SA, SB);
  cudaStream_t s = (cudaStream_t)stream;
  int err = ffn_backward<true>(a, wmaps, s);
  if (err != 0) return err;
  return film_weight_grads(a, pvg, pout, dwvg, dwout, S_vg, S_out, s);
}

// The K3 TP form, a rank's slice of the hidden units (H, padded to Hp): y_s
// is the K2 TP form's y and ws (SA, B L, C), ss (SA, B L) its all-reduced
// workspace, which give o, the block norm's backward and n, m over the whole
// hidden width Hm. Phase 0: the row statistics, pass B on the slice and the
// slice's weight products (dy (SB, B L, C) the dY partials, summed over the
// slices into dysum (B L, C) where SB > 1, the one plane the caller
// all-reduces over the model group); phase 1: the finish on that summed dY
// (dx, the FiLM, pre-norm and conv column partials). The other arguments
// as odt_film_layer_bwd's.
extern "C" int odt_film_layer_bwd_tp(const void* x, const void* go, const void* scale,
                                     const void* shift, const void* gate, const void* g1,
                                     const void* g2, const void* dww, const void* dwb,
                                     const void* bvg, const void* bout, const void* wmaps,
                                     void* dx, void* ws, void* ss, void* y_s, void* do_s,
                                     void* rows, void* mid, void* dvg_s, void* hn_s, void* dbvg,
                                     void* dy, void* dysum, void* fin, void* pvg, void* pout,
                                     void* dwvg,
                                     void* dwout, int B, int L, int C, int H, int Hp, int Hm,
                                     int K, int nwg, int SA, int SB, int S_vg, int S_out, int phase,
                                     void* stream) {
  using namespace odt;
  if (!film_width(C) || Hm < 1 || (SB > 1 && dysum == nullptr)) return (int)cudaErrorInvalidValue;
  BwdArgs a = film_args(x, go, scale, shift, gate, g1, g2, dww, dwb, bvg, bout, dx, ws, ss, y_s,
                        do_s, rows, mid, dvg_s, hn_s, dbvg, dy, fin, B, L, C, H, Hp, K, nwg, SA, SB);
  a.Hm = Hm;
  cudaStream_t s = (cudaStream_t)stream;
  if (phase == 1) {
    if (SB > 1) a.dy = (float*)dysum, a.SB = 1;
    return ffn_backward<true>(a, wmaps, s, kBwdFinish);
  }
  if (phase != 0) return (int)cudaErrorInvalidValue;
  int err = ffn_backward<true>(a, wmaps, s, kBwdRows | kBwdPassB);
  if (err == 0 && SB > 1) err = (int)tp_fold(a.dy, SB, (size_t)a.BL * C, (float*)dysum, s);
  if (err != 0) return err;
  return film_weight_grads(a, pvg, pout, dwvg, dwout, S_vg, S_out, s);
}
