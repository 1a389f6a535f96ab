#!/usr/bin/env python3
"""How close the latent stage's kernels come to f32 at ``stack.radius`` 0
(the unit tap) against radius 2, on the card:

    python3 tools/radius0_terms.py [SEEDS]

from the root of a checkout (SEEDS: how many weight draws, default 4).
It prints the card's name and power limit, then
- per latent level (B32, L 2052, 684, 228, 76; C128 H341), for the unit tap
  and for 5 taps: the film-layer forward's (K2) mean and max error against
  the plain version in f32, as a ratio to the plain bf16 path's (the rule
  chip_smoke.py holds K2 to: 1.1 / 1.5), and the backward's (K3) max dx
  error beside the plain bf16 path's;
- per radius and weight draw (chip_smoke.py ``randomize_`` from SEED + 4 +
  100 k, its shipped B32 x L2052 batch): the 13 loss terms of one latent
  forward through the kernels and through the plain bf16 versions, each
  term's error relative to the f32 plain forward (floored at 1e-3), pooled
  by mean and max, and the kernel path's pooled errors over the plain
  path's (the ratios chip_smoke.py's pooled-terms rule reads).
"""

from __future__ import annotations

import subprocess
import sys
from contextlib import nullcontext
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402

LEVELS = (2052, 684, 228, 76)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("radius0_terms: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from osu_dreamer_tpu_torch.models.latent import fit as latent_fit
    from osu_dreamer_tpu_torch.models.latent.model import LatentModel, LatentModelArgs
    from osu_dreamer_tpu_torch.models.latent.train import (
        Batch, LatentTrainArgs, draw_latent, latent_loss,
    )
    from osu_dreamer_tpu_torch.ops import film_layer as fl
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict, load_yaml_config

    seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 4
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
            ek = (fl.film_layer_cuda(*args).float() - ref).abs()
            ep = (fl.film_layer_plain(*args).float() - ref).abs()
            go = rnd(32, L, C)
            dx_ref = fl.film_layer_bwd_plain(*(t.float() for t in args), go.float())[0].float()
            dxk = (fl.film_layer_bwd_cuda(*args, go)[0].float() - dx_ref).abs().max().item()
            dxp = (fl.film_layer_bwd_plain(*args, go)[0].float() - dx_ref).abs().max().item()
            smoke.log(f"{K} taps, B32 L{L} C{C} H{H}: K2 error / plain bf16's: mean "
                      f"{(ek.mean() / ep.mean()).item():.3f}, max {(ek.max() / ep.max()).item():.3f}; "
                      f"K3 max dx error {dxk:.4g} (plain bf16 {dxp:.4g}) [{smi}]")

    cfg = load_yaml_config(latent_fit.CONFIG)
    Bt, Lt = cfg["data"]["batch_size"], cfg["data"]["seq_len"]
    for radius in (0, 2):
        cfg["model"]["stack"]["radius"] = radius
        model_args = dataclass_from_dict(LatentModelArgs, cfg["model"])
        train_args = dataclass_from_dict(LatentTrainArgs, cfg["train"])
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

            def terms(model, plain: bool):
                with torch.no_grad(), smoke.plain_ops() if plain else nullcontext():
                    comps, _, s_reg = latent_loss(model, batch, train_args, draws=draws)
                return torch.cat([comps.float(), s_reg.float()[None]])

            ref = terms(f32_model, True)
            kr, pr = (((t - ref).abs() / ref.abs()).clamp_min(smoke.LOSS_FLOOR)
                      for t in (terms(bf16_model, False), terms(bf16_model, True)))
            smoke.log(f"radius {radius}, draw {k}: the 13 terms' relative errors, kernels mean "
                      f"{kr.mean().item():.4g} max {kr.max().item():.4g}, plain bf16 mean "
                      f"{pr.mean().item():.4g} max {pr.max().item():.4g}: ratio mean "
                      f"{(kr.mean() / pr.mean()).item():.3f}, max {(kr.max() / pr.max()).item():.3f}")
            del bf16_model, f32_model
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
