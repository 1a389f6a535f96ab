// SwiGLU conv-FFN forward for Hopper (K4).
//
// Replaces the Pallas TPU kernel osu_dreamer_tpu/ops/swiglu.py `_kernel`
// (launched by `_fused_swiglu_fwd_impl`): depthwise conv (2r+1 taps) ->
// (C, 2H) projection -> v * silu(g) -> f32 RMS over H -> (H, C) projection.
// On the main path it is the denoiser FFN: bf16 (4, 759, 512), H = 1365,
// r = 2, 8 layers x 33 passes a request; in training (128, 152, 512).
//
// What bounds it on the H100: 3 C H multiply-adds a position (2.1 MFLOP at
// C 512) on the tensor cores against 2 KB in and out, so operations. The
// design is ffn_core.cuh's: TMA weight ring, wgmma products, the hidden
// dimension streamed with 1/rms applied at the end. At C 512 a CTA owns 128
// rows and 256 output columns (two column groups recompute v | g); at the
// sampler's 3,036 rows the hidden chunks also split in two across CTAs, and
// a second kernel sums the two f32 partials in order.
#include "ffn_core.cuh"

extern "C" int odt_ffn_weight_maps(const void* wvgT, const void* woutT, int C, int Hp,
                                   void* maps) {
  return odt::ffn_weight_maps(wvgT, woutT, C, Hp, maps);
}

extern "C" int odt_swiglu_fwd(const void* x, const void* dww, const void* dwb, const void* bvg,
                              const void* bout, const void* wmaps, void* out, void* ws, void* ss,
                              int B, int L, int C, int H, int Hp, int K, int S, int nc,
                              void* stream) {
  using namespace odt;
  FfnArgs a{};
  a.x = (const bf16*)x;
  a.dww = (const bf16*)dww;
  a.dwb = (const bf16*)dwb;
  a.bvg = (const float*)bvg;
  a.bout = (const bf16*)bout;
  a.ws = (float*)ws;
  a.ss = (float*)ss;
  a.BL = B * L;
  a.L = L;
  a.C = C;
  a.H = H;
  a.Hp = Hp;
  a.K = K;
  a.S = S;
  return ffn_forward<false>(a, wmaps, out, nc, (cudaStream_t)stream);
}

// The K4 TP form: a rank's slice of the hidden units (H of them, padded to
// Hp) through the core in its partial mode (phase 0: ws (S, B L, C) and ss
// (S, B L) f32; where S > 1 they are summed over the slices into sum, one
// plane (B L, C) then (B L), which the caller all-reduces over the model
// group), then the reduction kernel over the sums (phase 1, ws and ss one
// plane, S 1: 1 / rms over the whole hidden width Hm, b_out once, into out).
extern "C" int odt_swiglu_fwd_tp(const void* x, const void* dww, const void* dwb, const void* bvg,
                                 const void* bout, const void* wmaps, void* out, void* ws, void* ss,
                                 void* sum, int B, int L, int C, int H, int Hp, int Hm, int K,
                                 int S, int nc, int phase, void* stream) {
  using namespace odt;
  FfnArgs a{};
  a.x = (const bf16*)x;
  a.dww = (const bf16*)dww;
  a.dwb = (const bf16*)dwb;
  a.bvg = (const float*)bvg;
  a.bout = (const bf16*)bout;
  a.ws = (float*)ws;
  a.ss = (float*)ss;
  a.BL = B * L;
  a.L = L;
  a.C = C;
  a.H = H;
  a.Hp = Hp;
  a.Hm = Hm;
  a.K = K;
  a.S = S;
  a.partial = 1;
  if (phase == 0) {
    const int err = ffn_forward<false>(a, wmaps, (void*)x, nc, (cudaStream_t)stream);
    return err != 0 || S == 1 ? err : tp_fold_workspace(a, (float*)sum, (cudaStream_t)stream);
  }
  if (phase == 1) return ffn_finish<false>(a, out, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
