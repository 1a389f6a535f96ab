#!/usr/bin/env python3
"""How close the latent stage's kernels come to f32 at ``stack.radius`` 0
(the unit tap) against radius 2, on the card, and where the loss terms'
error comes from:

    python3 tools/radius0_terms.py [SEEDS]

from the root of a checkout (SEEDS: how many weight draws, default 8).
It prints the card's name and power limit, then
- per latent level (B32, L 2052, 684, 228, 76; C128 H341), for the unit tap
  and for 5 taps, on random inputs: the film-layer forward's (K2) mean and
  max error against the plain version in f32, as a ratio to the plain bf16
  path's (the rule chip_smoke.py holds K2 to: 1.1 / 1.5), the signed mean
  error of K2 and of the plain bf16 path (in units of the f32 output's mean
  magnitude), and the backward's (K3) max dx error beside the plain bf16
  path's;
- per radius, over SEEDS weight draws (chip_smoke.py ``randomize_`` from
  SEED + 4 + 100 k, its shipped B32 x L2052 batch, which the loss splits
  into 64 x 1026 halves), for one latent forward through the kernels, one
  through the plain bf16 versions and one plain f32 forward:
  - per level of the model (the film layers whose input has that length):
    the signed and the absolute mean error of K2's output and of the plain
    bf16 version's on the same inputs (the kernel path's), against the f32
    plain version on those inputs, in units of its mean magnitude;
  - per loss term (chip_smoke.py check_step's 13: the 11 components, s_reg
    and the self-normalised total): the signed relative error (t - f32) /
    |f32| of each path, its mean over the draws and the standard error of
    that mean;
  - the pooled mean relative error (each term's floored at LOSS_FLOOR) of
    each path and their ratio, the number chip_smoke.py's pooled rule reads;
  - the swap run: K2 at one level, the plain bf16 forward at the others;
    each level's pooled error over the plain path's, as a share of the
    kernel path's excess.
Nothing here is a check: it prints figures.
"""

from __future__ import annotations

import subprocess
import sys
from contextlib import contextmanager, nullcontext
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402

LEVELS = (2052, 684, 228, 76)
TERMS = ("hit/onset", "hit/combo", "hit/slide", "hit/sustain", "hit/whistle", "hit/finish",
         "hit/clap", "cursor/pos", "cursor/vel", "cursor/acc", "label", "s_reg", "loss")


@contextmanager
def film_route(route):
    """the film layers of the model through ``route(args)`` while open"""
    from osu_dreamer_tpu_torch.nn import blocks

    saved = blocks.film_layer
    blocks.film_layer = lambda *args: route(args)
    try:
        yield
    finally:
        blocks.film_layer = saved


def level_stats(stats: dict):
    """a film-layer route that runs K2 and records, by the input's length,
    the sums of K2's and the plain bf16 version's signed and absolute error
    against the f32 plain version on the same inputs, and of |f32|"""
    import torch

    from osu_dreamer_tpu_torch.ops import film_layer as fl

    def route(args):
        out = fl.film_layer_cuda(*args)
        ref = fl.film_layer_plain(*(t.float() for t in args)).double()
        ek = out.double() - ref
        ep = fl.film_layer_plain(*args).double() - ref
        s = stats.setdefault(args[0].shape[1], torch.zeros(6, dtype=torch.float64,
                                                          device=out.device))
        s += torch.stack([ek.sum(), ep.sum(), ek.abs().sum(), ep.abs().sum(), ref.abs().sum(),
                          torch.tensor(float(ref.numel()), dtype=torch.float64,
                                       device=out.device)])
        return out

    return route


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("radius0_terms: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from osu_dreamer_tpu_torch.models.latent import fit as latent_fit
    from osu_dreamer_tpu_torch.models.latent.model import LatentModel, LatentModelArgs
    from osu_dreamer_tpu_torch.models.latent.train import (
        LOSS_WEIGHTS, Batch, LatentTrainArgs, draw_latent, latent_loss,
    )
    from osu_dreamer_tpu_torch.ops import film_layer as fl
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict, load_yaml_config

    seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    smoke.log(smi)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    C, H = 128, 341
    for L in LEVELS:
        for K in (1, 5):
            taps = ([torch.ones(1, C, dtype=torch.bfloat16, device=dev),
                     torch.zeros(C, dtype=torch.bfloat16, device=dev)] if K == 1
                    else [rnd(K, C, scale=0.4), rnd(C, scale=0.1)])
            args = (rnd(32, L, C), *(rnd(32, C, scale=0.3) for _ in range(3)),
                    *(1 + rnd(C, scale=0.1) for _ in range(2)), *taps,
                    rnd(C, 2 * H, scale=C**-0.5), rnd(2 * H, scale=0.1),
                    rnd(H, C, scale=H**-0.5), rnd(C, scale=0.1))
            ref = fl.film_layer_plain(*(t.float() for t in args)).float()
            ek = fl.film_layer_cuda(*args).float() - ref
            ep = fl.film_layer_plain(*args).float() - ref
            unit = ref.abs().mean()
            go = rnd(32, L, C)
            dx_ref = fl.film_layer_bwd_plain(*(t.float() for t in args), go.float())[0].float()
            dxk = (fl.film_layer_bwd_cuda(*args, go)[0].float() - dx_ref).abs().max().item()
            dxp = (fl.film_layer_bwd_plain(*args, go)[0].float() - dx_ref).abs().max().item()
            smoke.log(f"{K} taps, B32 L{L} C{C} H{H}: K2 error / plain bf16's: mean "
                      f"{(ek.abs().mean() / ep.abs().mean()).item():.3f}, max "
                      f"{(ek.abs().max() / ep.abs().max()).item():.3f}; signed mean error / mean "
                      f"|f32|: K2 {(ek.mean() / unit).item():+.3e}, plain bf16 "
                      f"{(ep.mean() / unit).item():+.3e}; K3 max dx error {dxk:.4g} (plain bf16 "
                      f"{dxp:.4g}) [{smi}]")

    cfg = load_yaml_config(latent_fit.CONFIG)
    Bt, Lt = cfg["data"]["batch_size"], cfg["data"]["seq_len"]
    weights = torch.from_numpy(LOSS_WEIGHTS).to(dev)
    for radius in (0, 2):
        cfg["model"]["stack"]["radius"] = radius
        model_args = dataclass_from_dict(LatentModelArgs, cfg["model"])
        train_args = dataclass_from_dict(LatentTrainArgs, cfg["train"])
        stats: dict = {}
        signed = {"kernels": [], "plain bf16": []}  # (draws, 13) signed relative errors
        pooled = {"kernels": [], "plain bf16": []}  # (draws,) pooled floored mean
        swapped: dict = {}  # level: [pooled over draws]
        for k in range(seeds):
            g = torch.Generator(device=dev).manual_seed(smoke.SEED + 4 + 100 * k)
            bf16_model = LatentModel(model_args, torch.bfloat16).to(dev)
            smoke.randomize_(bf16_model, g)
            f32_model = LatentModel(model_args, torch.float32).to(dev)
            f32_model.load_state_dict(bf16_model.state_dict())
            batch = Batch(audio=torch.rand(Bt, Lt, 72, generator=g, device=dev),
                          chart=torch.rand(Bt, Lt, 9, generator=g, device=dev),
                          labels=torch.rand(Bt, 5, generator=g, device=dev) * 10)
            draws = draw_latent(2 * Bt, model_args.style_dim, Lt // 2 // model_args.chunk_size,
                                model_args.emb_dim, g, dev)

            def terms(model, route=None, plain: bool = False):
                """check_step's 13 terms of one forward (the film layers
                through ``route`` where given)"""
                ctx = smoke.plain_ops() if plain else film_route(route) if route else nullcontext()
                with torch.no_grad(), ctx:
                    comps, _, s_reg = latent_loss(model, batch, train_args, draws=draws)
                    total = (weights * comps / comps.clamp_min(1e-8)).sum()
                    total = total + train_args.s_reg_weight * s_reg
                return torch.cat([comps.float(), torch.stack([s_reg, total]).float()])

            def pool(t):
                return ((t - ref).abs() / ref.abs()).clamp_min(smoke.LOSS_FLOOR).mean().item()

            ref = terms(f32_model, plain=True)
            for what, t in (("kernels", terms(bf16_model, level_stats(stats))),
                            ("plain bf16", terms(bf16_model, plain=True))):
                signed[what].append(((t - ref) / ref.abs()).double().cpu())
                pooled[what].append(pool(t))
            for level in sorted(stats, reverse=True):
                def only_at(args, level=level):
                    run = fl.film_layer_cuda if args[0].shape[1] == level else fl.film_layer_plain
                    return run(*args)
                swapped.setdefault(level, []).append(pool(terms(bf16_model, only_at)))
            smoke.log(f"radius {radius}, draw {k}: pooled mean relative error of the 13 terms: "
                      f"kernels {pooled['kernels'][-1]:.4g}, plain bf16 "
                      f"{pooled['plain bf16'][-1]:.4g} (ratio "
                      f"{pooled['kernels'][-1] / pooled['plain bf16'][-1]:.3f}); K2 at one level "
                      "only: " + ", ".join(f"L{lv} {v[-1]:.4g}" for lv, v in swapped.items()))
            del bf16_model, f32_model
            torch.cuda.empty_cache()

        n = len(pooled["kernels"])
        for level in sorted(stats, reverse=True):
            sk, sp, ak, ap, mag, cnt = stats[level].tolist()
            unit = mag / cnt
            smoke.log(f"radius {radius}, level L{level} ({int(cnt) // n} outputs a draw, film "
                      f"layers on the kernel path's inputs, {n} draws): signed mean error / mean "
                      f"|f32|: K2 {sk / cnt / unit:+.3e}, plain bf16 {sp / cnt / unit:+.3e}; mean "
                      f"|error| / mean |f32|: K2 {ak / cnt / unit:.3e}, plain bf16 "
                      f"{ap / cnt / unit:.3e} [{smi}]")
        for what in signed:
            rel = torch.stack(signed[what])
            mean, sem = rel.mean(0), rel.std(0) / n**0.5 if n > 1 else torch.zeros(len(TERMS))
            smoke.log(f"radius {radius}, {what}: signed relative error by term, mean +- standard "
                      f"error over {n} draws: " + ", ".join(
                          f"{name} {m:+.2e} +- {e:.1e}" for name, m, e in
                          zip(TERMS, mean.tolist(), sem.tolist())))
        pk = sum(pooled["kernels"]) / n
        pp = sum(pooled["plain bf16"]) / n
        smoke.log(f"radius {radius}: pooled mean relative error over {n} draws: kernels {pk:.4g}, "
                  f"plain bf16 {pp:.4g}, ratio {pk / pp:.3f} (per draw "
                  + ", ".join(f"{a / b:.3f}" for a, b in zip(pooled["kernels"],
                                                            pooled["plain bf16"]))
                  + ") [" + smi + "]")
        for level, vals in swapped.items():
            sw = sum(vals) / n
            share = (sw - pp) / (pk - pp) if pk != pp else float("nan")
            smoke.log(f"radius {radius}: K2 at L{level} only, plain bf16 elsewhere: pooled "
                      f"{sw:.4g} ({sw / pp:.3f}x the plain path), share of the kernel path's "
                      f"excess {share:+.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
