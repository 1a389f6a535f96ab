"""Bulk mapset generation: batches of songs x difficulty rows through the
port's batch sampler, back to host memory as predict fetches them.

A unit is one batch: ``build_batch_sampler(LDM)`` -> ``sample(waves,
real_frames, labels, ...)`` with the starting noise drawn by the benchmark,
the quantized chart and labels copied to pinned host memory behind a CUDA
event, then, once the next batch has been issued, the wait on that event
and ``dequantize_chart``. The checked output is one finished batch, drawn
from the seed, against the reference's chain from the same waves, labels,
noise and weights.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import traffic
from portbench.cell import Window, count_syncs, device_ctx, now, sync
from portbench.compare import worst_row_gap
from portbench.reference import chain
from portbench.reference.numerics import Numerics, set_f32_matmul
from portbench.roofline import mapset_batch_flops
from portbench.weights import draw_state


def ldm_args(cfg: dict):
    from osu_dreamer_tpu_torch.models.diffusion.model import BackboneArgs, DiffusionModelArgs
    from osu_dreamer_tpu_torch.models.inference.model import LDMArgs
    from osu_dreamer_tpu_torch.models.latent.model import LatentModelArgs, StackArgs
    from osu_dreamer_tpu_torch.models.style.model import StyleModelArgs

    lat, d = dict(cfg["latent"]), dict(cfg["diffusion"])
    lat["stack"] = StackArgs(**lat["stack"])
    d["backbone"] = BackboneArgs(**d["backbone"])
    return LDMArgs(latent=LatentModelArgs(**lat), style=StyleModelArgs(**cfg["style"]),
                   diffusion=DiffusionModelArgs(**d))


class PredictCell:
    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, torch.device(device)
        self.limits = wl.get("limits", {})
        self.S, self.D = wl["songs"], wl["difficulties"]
        self.items_per_unit = self.S * self.D
        self.cuda = self.device.type == "cuda"
        self.done: list[tuple] = []  # (batch index, hit u8, xy i16, labels) of finished batches
        self.issued = 0

    # ------------------------------------------------------------ set-up ----
    def setup(self) -> None:
        if self.cfg["sampling"]["fused_prologue"]:
            raise ValueError("this driver runs the shipped path: fused_prologue false")
        from osu_dreamer_tpu_torch.models.inference.model import LDM
        from osu_dreamer_tpu_torch.models.inference.sampler import build_batch_sampler

        dtype = getattr(torch, self.cfg["dtype"])
        with device_ctx(self.device):
            self.model = LDM(ldm_args(self.cfg), dtype).eval()
        shapes = {k: tuple(v.shape) for k, v in self.model.state_dict().items()}
        self.weights = draw_state(shapes, self.seed, self.device, self.cfg.get("damped"))
        self.model.load_state_dict(self.weights)
        self.sample = build_batch_sampler(self.model)
        lat = self.cfg["latent"]
        self.chunk = lat["stride"] ** lat["n_downs"]
        self.pool = [(traffic.songs(self.wl, self.seed, i, self.chunk, self.device),
                      traffic.labels(self.wl, self.seed, i, self.device))
                     for i in range(self.wl["pool"])]
        self.n_frames = self.pool[0][0]["n_frames"]
        self.out_frames = self.pool[0][0]["out_frames"]
        self.flops_per_unit = mapset_batch_flops(self.cfg, self.S, self.D, self.out_frames)
        self.run_units(self.wl["warmup_units"] - 1)
        self.finish(self.dispatch(probe=True))  # after the first batch's one-off table uploads
        self.done.clear()

    # -------------------------------------------------------------- units ----
    def noise(self, i: int):
        return traffic.sampler_noise(self.cfg, self.S * self.D, self.out_frames // self.chunk,
                                     self.seed, i, self.device)

    def dispatch(self, issue_ms: list | None = None, probe: bool = False):
        """issue batch ``self.issued``; ``probe``: count the host syncs of the
        sampler's call into ``self.syncs``"""
        i = self.issued
        self.issued += 1
        songs, labels = self.pool[i % len(self.pool)]
        s0, x0 = self.noise(i)
        smp = self.cfg["sampling"]

        def call():
            return self.sample(songs["waves"], songs["real_frames"], labels, None, self.n_frames,
                               self.out_frames, smp["steps"], smp["guidance"], s0=s0, x0=x0)

        t0 = now()
        if probe:
            out, self.syncs = count_syncs(self.device, call)
        else:
            out = call()
        if issue_ms is not None:
            issue_ms.append((now() - t0) * 1e3)
        if not self.cuda:
            return i, out, None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                     for t in out)
        ready = torch.cuda.Event()
        ready.record()
        return i, host, ready

    def finish(self, pending) -> None:
        from osu_dreamer_tpu_torch.models.inference.sampler import dequantize_chart

        i, (hit, xy, labels), ready = pending
        if ready is not None:
            ready.synchronize()
        hit, xy, labels = hit.numpy(), xy.numpy(), labels.float().numpy()
        dequantize_chart(hit, xy)  # the host's last step of a batch, as predict takes it
        self.done.append((i, hit.copy(), xy.copy(), labels.copy()))

    def run_units(self, n: int) -> int:
        pending = None
        for _ in range(n):
            out = self.dispatch()
            if pending is not None:
                self.finish(pending)
            pending = out
        if pending is not None:
            self.finish(pending)
        sync(self.device)
        return n

    def run(self, seconds: float) -> Window:
        win = Window()
        sync(self.device)
        first = len(self.done)
        t0 = now()
        pending = None
        while now() - t0 < seconds:
            out = self.dispatch(win.host_issue_ms)
            if pending is not None:
                self.finish(pending)
            pending = out
        if pending is not None:
            self.finish(pending)
        win.seconds = now() - t0
        win.units = len(self.done) - first
        win.items = win.units * self.items_per_unit
        return win

    # -------------------------------------------------------------- check ----
    def free(self) -> None:
        for name in ("model", "sample"):
            self.__dict__.pop(name, None)
        if self.cuda:
            torch.cuda.empty_cache()

    def picked(self) -> tuple:
        """the finished batch the check compares, drawn from the seed"""
        rng = np.random.default_rng(traffic.seed_of(self.seed, "pick"))
        return self.done[int(rng.integers(len(self.done)))]

    def reference(self, i: int, numerics: str):
        songs, labels = self.pool[i % len(self.pool)]
        s0, x0 = self.noise(i)
        smp = self.cfg["sampling"]
        P = {k: v.float() for k, v in self.weights.items()}
        return chain.mapset_batch(P, self.cfg, songs["waves"], songs["real_frames"], labels, s0,
                                  x0, self.n_frames, self.out_frames, smp["steps"],
                                  smp["style_steps"], smp["guidance"], Numerics(numerics))

    def check(self, kinds=("program",)) -> dict[str, dict[str, float]]:
        """{kind: {"chart_gap", "labels_gap"}}: the worst row's relative
        2-norm gap of the dequantized chart and of the labels. Kinds:
        "program" (the timed path's), "fp8" (the control: the reference in
        fp8 in the program's place), "answer" (the program's chart with one
        row's hit channels inverted)"""
        from osu_dreamer_tpu_torch.models.inference.sampler import dequantize_chart

        self.free()
        set_f32_matmul()
        i, hit, xy, labels = self.picked()
        ref_chart, ref_labels = self.reference(i, "f32")
        out = {}
        for kind in kinds:
            if kind in ("program", "answer"):
                chart, lab = dequantize_chart(hit, xy), labels
                if kind == "answer":
                    chart[0, :, :chain.M.HIT_DIM] = 1.0 - chart[0, :, :chain.M.HIT_DIM]
            elif kind == "fp8":
                chart, lab = self.reference(i, "fp8")
            else:
                raise ValueError(f"no check kind {kind!r} in a predict cell")
            out[kind] = {"chart_gap": worst_row_gap(chart, ref_chart),
                         "labels_gap": worst_row_gap(lab, ref_labels)}
        return out


def build(cfg: dict, wl: dict, seed: int, device) -> PredictCell:
    return PredictCell(cfg, wl, seed, device)
