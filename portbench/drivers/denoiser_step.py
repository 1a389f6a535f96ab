"""Denoiser training: the port's ``make_train_step`` on one ``TrainState``
(f32 parameters, bf16 compute, AdamW, EMA), step after step, as
``fit-denoiser`` runs it without its data pipeline and logging.

A unit is one step, ``train_step(state, batch, t, x0)``, on a pool of
latent batches drawn on the device and cycled, with the interpolation
times and noise injected. Set-up drives the state through its first steps
on batches whose rows all differ and keeps what the check compares: each
step's loss, the first clipped gradient (from the optimizer's first moment
after one step), and the change of the weights and of the EMA after the
last of them. The same state then runs the window.
"""

from __future__ import annotations

import copy

import torch

from portbench import traffic
from portbench.cell import Window, count_syncs, device_ctx, now, sync
from portbench.compare import leaf_gaps, median_leaf, moved_leaves, worst_leaf
from portbench.reference import chain
from portbench.reference.numerics import Numerics, set_f32_matmul
from portbench.roofline import denoiser_train_flops
from portbench.weights import draw_state

PREFIX = "diffusion."  # the reference's names of the denoiser's weights


class TrainCell:
    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, torch.device(device)
        self.limits = wl.get("limits", {})
        self.B, self.l = wl["batch"], wl["seq_len"]
        self.items_per_unit = self.B
        self.cuda = self.device.type == "cuda"
        self.issued = 0
        self.diag: dict = {}  # check kind -> the worst leaves and the worst leaf's grad gap

    def setup(self) -> None:
        from osu_dreamer_tpu_torch.models.diffusion.model import (
            BackboneArgs, DiffusionModel, DiffusionModelArgs,
        )
        from osu_dreamer_tpu_torch.models.diffusion.train import (
            DiffusionTrainArgs, LatentBatch, make_train_step,
        )
        from osu_dreamer_tpu_torch.nn.schedule import LRScheduleArgs
        from osu_dreamer_tpu_torch.train.state import OptimizerArgs, TrainState, make_optimizer

        d, tr = dict(self.cfg["diffusion"]), self.cfg["train"]
        d["backbone"] = BackboneArgs(**d["backbone"])
        with device_ctx(self.device):
            model = DiffusionModel(DiffusionModelArgs(**d), getattr(torch, self.cfg["dtype"]))
        shapes = {PREFIX + k: tuple(v.shape) for k, v in model.state_dict().items()}
        self.weights = draw_state(shapes, self.seed, self.device, self.cfg.get("damped"))
        model.load_state_dict({k[len(PREFIX):]: v for k, v in self.weights.items()})
        opt = OptimizerArgs(lr=tr["opt"]["lr"], weight_decay=tr["opt"]["weight_decay"],
                            grad_clip=tr["opt"]["grad_clip"],
                            schedule=LRScheduleArgs(**tr["opt"]["schedule"]))
        args = DiffusionTrainArgs(opt=opt, osl_weight=tr["osl_weight"],
                                  del_weight=tr["del_weight"], ema_decay=tr["ema_decay"])
        self.state = TrainState(step=0, model=model,
                                opt=make_optimizer(list(model.parameters()), opt),
                                ema_model=copy.deepcopy(model).requires_grad_(False),
                                generator=traffic.generator(self.device, self.seed, "state"))
        self.train_step = make_train_step(args)
        self.batches = [LatentBatch(*b) for b in
                        traffic.latent_batches(self.cfg, self.wl, self.seed, self.device)]
        self.noise = [traffic.train_noise(self.cfg, self.B, self.l, self.seed, i, self.device)
                      for i in range(self.wl["pool"])]
        self.flops_per_unit = denoiser_train_flops(self.cfg, self.B, self.l)

        names = [PREFIX + k for k, _ in model.named_parameters()]
        params = dict(zip(names, model.parameters()))
        p0 = {k: v.detach().clone() for k, v in params.items()}
        self.losses = []
        for i in range(self.wl["setup_steps"]):
            self.losses.append(self.unit()["loss"])
            if i == 0:
                b1 = self.state.opt.b1
                self.first_grad = {k: m / (1.0 - b1) for k, m in zip(names, self.state.opt.mu)}
        sync(self.device)
        self.losses = [float(x) for x in self.losses]
        self.change = {k: params[k].detach() - p0[k] for k in names}
        ema = dict(zip(names, self.state.ema_model.parameters()))
        self.ema_change = {k: ema[k].detach() - p0[k] for k in names}
        _, self.syncs = count_syncs(self.device, self.unit)
        self.run_units(self.wl["warmup_units"] - 1)

    def unit(self, issue_ms: list | None = None) -> dict:
        i = self.issued
        self.issued += 1
        k = i % len(self.batches)
        t, x0 = self.noise[k]
        t0 = now()
        out = self.train_step(self.state, self.batches[k], t, x0)
        if issue_ms is not None:
            issue_ms.append((now() - t0) * 1e3)
        return out

    def run_units(self, n: int) -> int:
        for _ in range(n):
            self.unit()
        sync(self.device)
        return n

    def run(self, seconds: float) -> Window:
        win = Window()
        sync(self.device)
        events, stamps = [], []  # off the card the host's clock is the device's
        if self.cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = now()
        stamps.append(t0)
        while now() - t0 < seconds:
            self.unit(win.host_issue_ms)
            win.units += 1
            if self.cuda:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            else:
                stamps.append(now())
        sync(self.device)
        win.seconds = now() - t0
        win.items = win.units * self.items_per_unit
        win.unit_ms = ([a.elapsed_time(b) for a, b in zip(events, events[1:])] if self.cuda
                       else [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])])
        return win

    def free(self) -> None:
        self.__dict__.pop("state", None)
        self.__dict__.pop("train_step", None)
        if self.cuda:
            torch.cuda.empty_cache()

    def reference(self, numerics: str, rows: slice | None = None) -> dict:
        n = self.wl["setup_steps"]
        return chain.train_steps(self.weights, self.cfg,
                                 [(b.h, b.z, b.s) for b in self.batches[:n]], self.noise[:n],
                                 Numerics(numerics), rows=rows)

    def check(self, kinds=("program",)) -> dict[str, dict[str, float]]:
        """{kind: {"loss_gap": the largest relative gap of a step's loss;
        "grad_median_gap": the median leaf's gap of the norms of the first
        clipped gradient (the worst leaf's, in ``self.diag``, swings with
        the one 6-element bias whose gradient sums every position);
        "change_gap", "ema_gap": the worst leaf's gap of the norms of the
        weights' and the EMA's change after the set-up steps}}. Kinds: "program" (the
        timed path's), "fp8" (the control: the reference in fp8 in the
        program's place), "half_batch" (the reference on half of each
        batch's rows in the program's place)"""
        self.free()
        set_f32_matmul()
        ref = self.reference("f32")
        moved = moved_leaves(ref["grad"])
        ref_change = {k: ref["params"][k] - self.weights[k] for k in self.weights}
        ref_ema = {k: ref["ema"][k] - self.weights[k] for k in self.weights}
        out = {}
        for kind in kinds:
            if kind == "program":
                losses, grad = self.losses, self.first_grad
                change, ema_change = self.change, self.ema_change
            elif kind in ("fp8", "half_batch"):
                prog = (self.reference("fp8") if kind == "fp8" else
                        self.reference("f32", rows=slice(0, self.B // 2)))
                losses, grad = prog["loss"], prog["grad"]
                change = {k: prog["params"][k] - self.weights[k] for k in self.weights}
                ema_change = {k: prog["ema"][k] - self.weights[k] for k in self.weights}
            else:
                raise ValueError(f"no check kind {kind!r} in a train cell")
            grad_gaps = leaf_gaps(grad, ref["grad"])
            change = worst_leaf(leaf_gaps(change, ref_change, moved))
            ema = worst_leaf(leaf_gaps(ema_change, ref_ema, moved))
            self.diag[kind] = {"grad_worst_gap": worst_leaf(grad_gaps),
                               "change_leaf": change[1], "ema_leaf": ema[1]}
            out[kind] = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["loss"])),
                         "grad_median_gap": median_leaf(grad_gaps),
                         "change_gap": change[0], "ema_gap": ema[0]}
        return out


def build(cfg: dict, wl: dict, seed: int, device) -> TrainCell:
    return TrainCell(cfg, wl, seed, device)
