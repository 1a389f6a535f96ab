// SwiGLU conv-FFN backward for Hopper: the partial backward (K6) and the
// full backward (K5), one backward core for both.
//
// K6 replaces the Pallas TPU kernel osu_dreamer_tpu/ops/swiglu.py
// `_partial_bwd_kernel` (launched by `_fused_swiglu_partial_bwd_impl`,
// swiglu.py:492). On the main path it is the backward of the denoiser FFN in
// training: x and the output gradient bf16 (128, 152, 512), H = 1365 (padded
// to 1408), K = 5, 8 layers per step. It returns dx, the small gradients'
// partials, and dvg, hn and y for the two big weight products dW_vg = y^T dvg
// and dW_out = hn^T go, which stay torch matmuls, as the JAX package leaves
// them to XLA (swiglu.py:540-543).
//
// K5 (odt_swiglu_bwd_full) replaces `_bwd_kernel` (launched by
// `_fused_swiglu_bwd_impl`, swiglu.py:313), the backward that keeps every
// weight gradient in on-chip accumulators and that the JAX dispatch takes
// wherever its footprint fits (`bwd_kernel_feasible`: a denoiser of width
// 384 or less, e.g. C 384, H 1024). Blocks on Hopper run in no order and the
// gradients must repeat bit for bit, so K5 is K6's pass in a second mode
// followed, in the same call, by the two weight products on csrc/gemm_tn.cuh
// (TMA + wgmma, split over row chunks, summed in a fixed order).
//
// What bounds it on the H100: per row 8 C H multiply-adds on the tensor
// cores (6.3 MFLOP at C 512), against 4 C bytes of x and the output
// gradient: the tensor cores. The design is the backward core of
// csrc/ffn_bwd_core.cuh: the conv, pass A in the statistics mode of pass B's
// kernel (v|g and dhn on wgmma, the sums of s^2 and dhn s a row), the row
// statistics, pass B (v|g, dhn and dY on wgmma, one pass over the hidden
// dimension; from C 416 to 512 two warpgroups on one 64-row tile split
// dY's columns and hand each other their halves of dvg, elsewhere
// 128-column groups across CTAs), the finish (the
// transposed conv, 80 rows a CTA, 48 past C 512, and the column partials).
// K6 takes C % 32 == 0 up to 640, K5 up to 512 (ops/swiglu.py bwd_route).
//
// Tensor parallelism: odt_swiglu_bwd_tp is K6's TP form, odt_swiglu_bwd_full_tp
// K5's (the same phases on a rank's slice of the hidden units, phase 0 also
// computing the slice's weight gradients on gemm_tn.cuh, as K5 does); a TP
// slice takes the form its one-rank route names (ops/swiglu.py
// swiglu_tp_route).
#include "ffn_bwd_core.cuh"
#include "gemm_tn.cuh"

namespace {

odt::BwdArgs swiglu_args(const void* x, const void* go, const void* dww, const void* dwb,
                         const void* bvg, void* dx, void* ss, void* y_s, void* rows,
                         void* dvg_s, void* hn_s, void* dbvg, void* dy, void* fin, int B, int L,
                         int C, int H, int Hp, int K, int nwg, int SA, int SB, int frows) {
  using odt::bf16;
  odt::BwdArgs a{};
  a.x = (const bf16*)x;
  a.go = (const bf16*)go;
  a.dww = (const bf16*)dww;
  a.dwb = (const bf16*)dwb;
  a.bvg = (const float*)bvg;
  a.ss = (float*)ss;
  a.y = (bf16*)y_s;
  a.rows = (float*)rows;
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
  a.frows = frows;
  return a;
}

}  // namespace

// The pack's b_vg (2 Hp, f32) and tensor maps (wmaps). dx (B, L, C) bf16;
// the workspace of the plan (nwg consumer warpgroups a CTA, SA and SB hidden
// slices, frows the finish's rows a CTA): ss (2 SA, B L) the partial sums of
// s^2 and of dhn s, rows (B L, 2), dbvg (tiles x nwg, 2 Hp), dy
// (SB, B L, C), fin (B, ceil(L / frows), 2 + K, C) f32; y_s (B L, C), dvg_s
// (B L, 2 Hp), hn_s (B L, Hp) bf16, which the weight products read.
extern "C" int odt_swiglu_bwd(const void* x, const void* go, const void* dww, const void* dwb,
                              const void* bvg, const void* wmaps, void* dx, void* ss, void* y_s,
                              void* rows, void* dvg_s, void* hn_s, void* dbvg, void* dy,
                              void* fin, int B, int L, int C, int H, int Hp, int K, int nwg, int SA,
                              int SB, int frows, void* stream) {
  if (C > 640) return (int)cudaErrorInvalidValue;
  return odt::ffn_backward<false>(swiglu_args(x, go, dww, dwb, bvg, dx, ss, y_s, rows, dvg_s,
                                              hn_s, dbvg, dy, fin, B, L, C, H, Hp, K, nwg, SA, SB,
                                              frows),
                                  wmaps, (cudaStream_t)stream);
}

// K5: K6's arguments, then the weight products' chunk partials pvg
// (S_vg, C, 2 Hp), pout (S_out, Hp, C) and their sums dwvg (C, 2 Hp), dwout
// (Hp, C) f32 in the padded layout.
extern "C" int odt_swiglu_bwd_full(const void* x, const void* go, const void* dww, const void* dwb,
                                   const void* bvg, const void* wmaps, void* dx, void* ss,
                                   void* y_s, void* rows, void* dvg_s, void* hn_s, void* dbvg,
                                   void* dy, void* fin, void* pvg, void* pout, void* dwvg,
                                   void* dwout, int B, int L, int C, int H, int Hp, int K, int nwg,
                                   int SA, int SB, int frows, int S_vg, int S_out, void* stream) {
  using namespace odt;
  if (C > 512) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = ffn_backward<false>(swiglu_args(x, go, dww, dwb, bvg, dx, ss, y_s, rows, dvg_s,
                                            hn_s, dbvg, dy, fin, B, L, C, H, Hp, K, nwg, SA, SB,
                                            frows),
                                wmaps, s);
  if (err != 0) return err;
  err = (int)gemm_tn_splitk((const bf16*)y_s, C, (const bf16*)dvg_s, 2 * Hp, B * L, C, 2 * Hp, S_vg,
                            (float*)pvg, (float*)dwvg, s);
  if (err != 0) return err;
  return (int)gemm_tn_splitk((const bf16*)hn_s, Hp, (const bf16*)go, C, B * L, Hp, C, S_out,
                             (float*)pout, (float*)dwout, s);
}

// The K6 TP form, a rank's slice of the hidden units (H, padded to Hp):
// ws (SA, B L, C) and ss (SA, B L) are the forward's all-reduced residuals
// (the K4 TP form's workspace), which give n and m over the whole hidden
// width Hm. Phase 0: the conv (y), the row statistics from the residuals,
// pass B on the slice (dvg, hn, the vg-bias partials, the dY partials dy
// (SB, B L, C)), summed over the slices into dysum (B L, C) where SB > 1,
// the one plane the caller all-reduces over the model group; phase 1: the
// finish on that summed dY (dx, fin). The other arguments as
// odt_swiglu_bwd's.
extern "C" int odt_swiglu_bwd_tp(const void* x, const void* go, const void* dww, const void* dwb,
                                 const void* bvg, const void* wmaps, void* dx, void* ws, void* ss,
                                 void* y_s, void* rows, void* dvg_s, void* hn_s, void* dbvg,
                                 void* dy, void* dysum, void* fin, int B, int L, int C, int H,
                                 int Hp, int Hm, int K, int nwg, int SA, int SB, int frows,
                                 int phase, void* stream) {
  using namespace odt;
  if (C > 640 || ws == nullptr || Hm < 1 || (SB > 1 && dysum == nullptr))
    return (int)cudaErrorInvalidValue;
  BwdArgs a = swiglu_args(x, go, dww, dwb, bvg, dx, ss, y_s, rows, dvg_s, hn_s, dbvg, dy, fin, B,
                          L, C, H, Hp, K, nwg, SA, SB, frows);
  a.ws = (float*)ws;
  a.Hm = Hm;
  cudaStream_t s = (cudaStream_t)stream;
  if (phase == 0) {
    const int err = ffn_backward<false>(a, wmaps, s, kBwdPassA | kBwdRows | kBwdPassB);
    if (err != 0 || SB == 1) return err;
    return (int)tp_fold(a.dy, SB, (size_t)a.BL * C, (float*)dysum, s);
  }
  if (phase != 1) return (int)cudaErrorInvalidValue;
  if (SB > 1) a.dy = (float*)dysum, a.SB = 1;
  return ffn_backward<false>(a, wmaps, s, kBwdFinish);
}

// The K5 TP form: the K6 TP form's phases on a rank's slice, phase 0 then
// computing the slice's weight gradients in the same call as K5 does (the
// two products on csrc/gemm_tn.cuh, fixed-order chunk sums): dwvg (C, 2 Hp)
// = y^T dvg and dwout (Hp, C) = hn^T go from the chunk partials pvg
// (S_vg, C, 2 Hp) and pout (S_out, Hp, C), f32 in the padded layout. The
// other arguments as odt_swiglu_bwd_tp's; C at most 512, as K5.
extern "C" int odt_swiglu_bwd_full_tp(const void* x, const void* go, const void* dww,
                                      const void* dwb, const void* bvg, const void* wmaps,
                                      void* dx, void* ws, void* ss, void* y_s, void* rows,
                                      void* dvg_s, void* hn_s, void* dbvg, void* dy, void* dysum,
                                      void* fin, void* pvg, void* pout, void* dwvg, void* dwout,
                                      int B, int L, int C, int H, int Hp, int Hm, int K, int nwg,
                                      int SA, int SB, int frows, int S_vg, int S_out, int phase,
                                      void* stream) {
  using namespace odt;
  if (C > 512) return (int)cudaErrorInvalidValue;
  int err = odt_swiglu_bwd_tp(x, go, dww, dwb, bvg, wmaps, dx, ws, ss, y_s, rows, dvg_s, hn_s,
                              dbvg, dy, dysum, fin, B, L, C, H, Hp, Hm, K, nwg, SA, SB, frows,
                              phase, stream);
  if (err != 0 || phase != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  err = (int)gemm_tn_splitk((const bf16*)y_s, C, (const bf16*)dvg_s, 2 * Hp, B * L, C, 2 * Hp,
                            S_vg, (float*)pvg, (float*)dwvg, s);
  if (err != 0) return err;
  return (int)gemm_tn_splitk((const bf16*)hn_s, Hp, (const bf16*)go, C, B * L, Hp, C, S_out,
                             (float*)pout, (float*)dwout, s);
}
