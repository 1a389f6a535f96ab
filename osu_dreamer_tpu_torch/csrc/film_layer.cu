// FiLM-modulated SwiGLU residual layer, forward, for Hopper (K2).
//
// Replaces the Pallas TPU kernel osu_dreamer_tpu/ops/film_layer.py
// `_fwd_kernel` (launched by `_fused_film_layer_fwd_impl`). Per position:
//
//   h  = rms(x) * g1 * (1 + scale) + shift      pre-norm + FiLM
//   h  = SwiGLU(h)                              dwconv -> (C,2H) -> v*silu(g)
//                                               -> rms -> (H,C)
//   out = x + rms(h) * g2 * (1 + gate)          block norm + gated residual
//
// On the main path it is every latent U-Net layer: bf16 (B, L, 128), H = 341,
// r = 2, at L = 20493 / 6831 / 2277 (48 layers a request), and latent
// training's (64, 1026, 128).
//
// What bounds it on the H100: at C 128 a position costs 3 C H = 131k
// multiply-adds against 512 bytes in and out, about 500 operations a byte,
// so the tensor cores once the chain stays on chip. The design is
// ffn_core.cuh's (TMA weight ring, wgmma products, hidden streamed), with
// the pre-norm + FiLM applied in place to each x box of the window before
// the conv. As in the Pallas kernel the conv reads zero outside [0, L) of
// the output row's batch row AFTER the FiLM (the shift makes a normed zero
// row nonzero). At C 128 a warpgroup holds its rows' whole output, so the
// block norm and the gated residual run in registers and the output leaves
// by TMA stores.
#include "ffn_core.cuh"

extern "C" int odt_film_layer_fwd(const void* x, const void* scale, const void* shift,
                                  const void* gate, const void* g1, const void* g2,
                                  const void* dww, const void* dwb, const void* bvg,
                                  const void* bout, const void* wmaps, void* out, void* ws,
                                  void* ss, int B, int L, int C, int H, int Hp, int K, int S,
                                  int nc, void* stream) {
  using namespace odt;
  FfnArgs a{};
  a.x = (const bf16*)x;
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
  a.BL = B * L;
  a.L = L;
  a.C = C;
  a.H = H;
  a.Hp = Hp;
  a.K = K;
  a.S = S;
  return ffn_forward<true>(a, wmaps, out, nc, (cudaStream_t)stream);
}


// The K2 TP form: phase 0 runs a rank's slice of the hidden units through
// the core in the backward's first-pass mode (the pre-norm + FiLM and the
// conv on the whole x, y (B L, C) bf16 stored for the K3 TP form, the
// slice's ws (S, B L, C) and ss (S, B L) f32, summed over the slices into
// sum where S > 1, one plane the caller all-reduces over the model group);
// phase 1 the reduction kernel over the sums (one plane, S 1): 1 / rms over
// the whole hidden width Hm, b_out once, the block norm and the gated
// residual, into out.
extern "C" int odt_film_layer_fwd_tp(const void* x, const void* scale, const void* shift,
                                     const void* gate, const void* g1, const void* g2,
                                     const void* dww, const void* dwb, const void* bvg,
                                     const void* bout, const void* wmaps, void* out, void* y,
                                     void* ws, void* ss, void* sum, int B, int L, int C, int H,
                                     int Hp, int Hm, int K, int S, int phase, void* stream) {
  using namespace odt;
  FfnArgs a{};
  a.x = (const bf16*)x;
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
  a.BL = B * L;
  a.L = L;
  a.C = C;
  a.H = H;
  a.Hp = Hp;
  a.Hm = Hm;
  a.K = K;
  a.S = S;
  if (phase == 0) {
    a.ystore = 1;
    a.bout = nullptr;  // the first pass adds no bias
    const int err = ffn_forward<true>(a, wmaps, y, 128, (cudaStream_t)stream);
    return err != 0 || S == 1 ? err : tp_fold_workspace(a, (float*)sum, (cudaStream_t)stream);
  }
  if (phase == 1) return ffn_finish<true>(a, out, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
