"""Chart WAE training: the port's ``init_latent_training`` state and
``make_train_step`` (f32 parameters, bf16 compute, AdamW with clip and
warm-up, the loss's running normalisation; no EMA model), step after step,
as ``fit-latent`` runs it without its data pipeline and logging.

A unit is one step, ``train_step(state, batch, draws)``, on a pool of
batches of windows drawn on the device and cycled, each with its seven loss
draws injected (wae_traffic.py). The closed loop is the denoiser cell's
(denoiser_step.py). Set-up drives the state through its first steps on
batches whose rows all differ and keeps what the check compares: each
step's 11 loss components and MMD term, the first clipped gradient (from
the optimizer's first moment after one step), and the change of the
weights after the last of them. The same state then runs the window.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import traffic, wae_traffic
from portbench.cell import count_syncs, now, sync
from portbench.compare import leaf_gaps, leaf_norms, median_leaf, moved_leaves, worst_leaf
from portbench.drivers.denoiser_step import TrainCell
from portbench.latent_work import latent_train_flops
from portbench.reference import wae
from portbench.reference.numerics import set_f32_matmul
from portbench.weights import draw_state

PREFIX = "latent."  # the reference's names of the WAE's weights
# the numbers of a step's loss the check compares: fit-latent's 11 components
# (models/latent/train.py LOSS_COMPONENTS), then the MMD term
NUMBERS = ("hit/onset", "hit/combo", "hit/slide", "hit/sustain", "hit/whistle", "hit/finish",
           "hit/clap", "cursor/pos", "cursor/vel", "cursor/acc", "label", "s_reg")


def vector_gaps(prog: dict[str, torch.Tensor], ref: dict[str, torch.Tensor]) -> dict[str, float]:
    """each leaf's |prog - ref|, over the larger of the reference's norm of
    that leaf and of the median leaf (compare.py ``leaf_gaps`` compares the
    two norms alone, which a rounding that turns a leaf's direction hardly
    moves)"""
    norms = leaf_norms(ref)
    med = float(np.median(list(norms.values())))
    return {k: float(torch.linalg.vector_norm(prog[k].double() - ref[k].double()))
            / max(n, med, 1e-30) for k, n in norms.items()}


class LatentCell(TrainCell):
    # the denoiser cell's closed loop, named in this class too, so that what
    # looks up a cell's own methods (a test's clock) finds it
    run = TrainCell.run

    def setup(self) -> None:
        from osu_dreamer_tpu_torch.models.latent.model import LatentModelArgs, StackArgs
        from osu_dreamer_tpu_torch.models.latent.train import (
            Batch, LatentDraws, LatentTrainArgs, init_latent_training,
        )
        from osu_dreamer_tpu_torch.nn.schedule import LRScheduleArgs
        from osu_dreamer_tpu_torch.train.state import OptimizerArgs

        lat, tr = self.cfg["latent"], self.cfg["train"]
        opt = OptimizerArgs(lr=tr["opt"]["lr"], weight_decay=tr["opt"]["weight_decay"],
                            grad_clip=tr["opt"]["grad_clip"],
                            schedule=LRScheduleArgs(**tr["opt"]["schedule"]))
        args = LatentTrainArgs(opt=opt, **{k: tr[k] for k in (
            "s_reg_weight", "s_noise", "z_noise", "s_mask_frac", "z_mask_frac")})
        self.state, self.train_step = init_latent_training(
            LatentModelArgs(**dict(lat, stack=StackArgs(**lat["stack"]))), args,
            traffic.seed_of(self.seed, "state"), self.device, getattr(torch, self.cfg["dtype"]))
        model = self.state.model
        shapes = {PREFIX + k: tuple(v.shape) for k, v in model.state_dict().items()}
        self.weights = draw_state(shapes, self.seed, self.device, self.cfg.get("damped"))
        model.load_state_dict({k[len(PREFIX):]: v for k, v in self.weights.items()})
        self.batches = [Batch(*b) for b in wae_traffic.windows(self.wl, self.seed, self.device)]
        self.draws = [LatentDraws(*wae_traffic.draws(self.cfg, self.wl, self.seed, i, self.device))
                      for i in range(self.wl["pool"])]
        self.flops_per_unit = latent_train_flops(self.cfg, self.B, self.l)

        names = [PREFIX + k for k, _ in model.named_parameters()]
        params = dict(zip(names, model.parameters()))
        p0 = {k: v.detach().clone() for k, v in params.items()}
        steps = []
        for i in range(self.wl["setup_steps"]):
            m = self.unit()
            steps.append(torch.stack([m[k] for k in NUMBERS]))
            if i == 0:
                b1 = self.state.opt.b1
                self.first_grad = {k: mu / (1.0 - b1) for k, mu in zip(names, self.state.opt.mu)}
        sync(self.device)
        steps = torch.stack(steps).double().cpu()
        self.components, self.s_reg = steps[:, :-1].tolist(), steps[:, -1].tolist()
        self.change = {k: params[k].detach() - p0[k] for k in names}
        _, self.syncs = count_syncs(self.device, self.unit)
        self.run_units(self.wl["warmup_units"] - 1)

    def unit(self, issue_ms: list | None = None) -> dict:
        i = self.issued
        self.issued += 1
        k = i % len(self.batches)
        t0 = now()
        out = self.train_step(self.state, self.batches[k], self.draws[k])
        if issue_ms is not None:
            issue_ms.append((now() - t0) * 1e3)
        return out

    def reference(self, numerics: str, rows: slice | None = None) -> dict:
        n = self.wl["setup_steps"]
        return wae.train_steps(self.weights, self.cfg, self.batches[:n], self.draws[:n],
                               wae.TrainNumerics(numerics), rows=rows)

    def check(self, kinds=("program",)) -> dict[str, dict[str, float]]:
        """{kind: {"loss_gap": the largest relative gap of a step's 11 loss
        components and its MMD term; "grad_median_gap": the median leaf's
        ``vector_gaps`` of the first clipped gradient (the worst leaf's, in
        ``self.diag``); "change_gap": the worst leaf's gap of the norms of the
        weights' change after the set-up steps}}. Kinds: "program" (the timed
        path's), "fp8" (the control: the reference in fp8 in the program's
        place, every tensor that the program holds in bf16 held in fp8;
        wae.py ``TrainNumerics``), "half_batch" (the reference on half of
        each batch's windows in the program's place)"""
        self.free()
        set_f32_matmul()
        ref = self.reference("f32")
        moved = moved_leaves(ref["grad"])
        ref_change = {k: ref["params"][k] - self.weights[k] for k in self.weights}
        ref_losses = [c + [s] for c, s in zip(ref["components"], ref["s_reg"])]
        out = {}
        for kind in kinds:
            if kind == "program":
                losses = [c + [s] for c, s in zip(self.components, self.s_reg)]
                grad, change = self.first_grad, self.change
            elif kind in ("fp8", "half_batch"):
                prog = (self.reference("fp8") if kind == "fp8" else
                        self.reference("f32", rows=slice(0, self.B // 2)))
                losses = [c + [s] for c, s in zip(prog["components"], prog["s_reg"])]
                grad = prog["grad"]
                change = {k: prog["params"][k] - self.weights[k] for k in self.weights}
            else:
                raise ValueError(f"no check kind {kind!r} in a train cell")
            grad_gaps = vector_gaps(grad, ref["grad"])
            change = worst_leaf(leaf_gaps(change, ref_change, moved))
            loss = max((abs(a - b) / abs(b), step, NUMBERS[j])
                       for step, (p, r) in enumerate(zip(losses, ref_losses))
                       for j, (a, b) in enumerate(zip(p, r)))
            self.diag[kind] = {"grad_worst_gap": worst_leaf(grad_gaps), "change_leaf": change[1],
                               "loss_step_number": loss[1:]}
            out[kind] = {"loss_gap": loss[0], "grad_median_gap": median_leaf(grad_gaps),
                         "change_gap": change[0]}
        return out


def build(cfg: dict, wl: dict, seed: int, device) -> LatentCell:
    return LatentCell(cfg, wl, seed, device)
