#!/usr/bin/env python3
"""Smoke check of the PyTorch port (osu_dreamer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout. It needs one CUDA card, ``nvcc`` for sm_90a and
nothing of JAX; without a card it exits nonzero and prints no result.

1. Builds the seven CUDA kernels from osu_dreamer_tpu_torch/csrc/ (one nvcc
   per source, in parallel; printing the build seconds) and holds each
   against its plain PyTorch version on the card (bf16; f32 for the
   resonator; TF32 off), timing both with CUDA events: the inference kernels
   at the inference slice's shapes, the training kernels (SwiGLU backward,
   fused attention forward and backward) at the denoiser's training shape
   B128 L152 and at a ragged length.
2. Runs a small slice (2 short songs x 2 difficulties) through the kernels
   and through the plain versions in bf16, and holds both to the plain
   versions in f32. Its denoiser runs at L <= 256, so through the fused
   attention forward.
3. Runs the full-width slice (LDMArgs() defaults, seeded random weights,
   bf16): two synthetic 120 s songs x two difficulty rows, 32 denoiser
   steps, 16 style steps, once more with style guidance 2.0. The device part
   runs under torch.cuda.set_sync_debug_mode("error"), so a host sync inside
   the samplers fails the run; every inference kernel must launch.
4. Trains the denoiser at full width (the port's models/diffusion/config.yml:
   depth 8, width 512, 16 x 64 heads, batch 128 x 152, bf16 compute, f32
   parameters) through ``fit.run`` on a seeded synthetic cached-latent
   corpus written under build/: 2 warm-up steps and 20 timed steps, then EMA
   validation and the best/last checkpoints. Every loss must be finite and
   every training kernel must launch during the timed steps. Then one step's
   loss and gradients through the kernels (bf16) and through the plain
   versions (bf16) are each held to a plain f32 step on the same batch, t and
   x0 (random full-strength weights).

Prints the card's name and power limit, one JSON line of per-kernel results,
and last ``{"ok": true, "device": {...}}``. Any failure raises.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
SONG_SECONDS = 120.0
DIFFS = [(5.0, 9.0, 8.0, 4.0, 6.0), (3.0, 5.0, 5.0, 4.0, 4.0)]  # predict's default + one
STEPS = 32  # denoiser steps; the style prior takes the LDM's default of 16

# bf16 kernels are held to 4 ulp of the largest reference magnitude: they
# round wherever the plain version rounds, but their products accumulate in
# another order, so an intermediate bf16 rounding can flip and pass through
# the next projection. The f32 resonator: 1e-5 absolute (states are O(1)).
BF16_ULPS = 4
F32_ATOL = 1e-5
# The small slice (charts and labels) runs three times on the same weights
# and noise: bf16 through the kernels, bf16 through the plain versions, and
# f32 through the plain versions (the reference). With random full-strength
# gains the 48 film layers amplify bf16 rounding, so the two bf16 runs differ
# from each other by about as much as each differs from the reference; the
# kernel path must stay about as close to the reference as the plain path.
SLICE_MEAN_RATIO = 1.1
SLICE_MAX_RATIO = 1.5
# The training kernels' gradients are held to autograd of the plain version
# in f32 on the same (bf16-valued) inputs: the max abs error must stay within
# GRAD_REL of the largest magnitude of the f32 gradient. The kernels compute
# the gradient of the bf16 forward in f32, so they differ from the f32
# reference by the forward's bf16 rounding: about 0.5-1.6 % of the largest
# magnitude at B128 L152, as the plain bf16 autograd does; weight gradients
# summed over B*L = 19,456 rows are no exception.
GRAD_REL = 0.03
TRAIN_WARMUP = 2
TRAIN_TIMED = 20
# the one-step comparison's floor for the loss terms: 1e-3 of the f32 value
LOSS_FLOOR = 1e-3

KERNEL_META = {
    "resonator": ("osu_dreamer_tpu_torch/csrc/resonator.cu", "osu_dreamer_tpu/ops/resonator.py:115"),
    "film_layer": ("osu_dreamer_tpu_torch/csrc/film_layer.cu", "osu_dreamer_tpu/ops/film_layer.py:401"),
    "swiglu": ("osu_dreamer_tpu_torch/csrc/swiglu.cu", "osu_dreamer_tpu/ops/swiglu.py:135"),
    "flash_attention": ("osu_dreamer_tpu_torch/csrc/flash_attention.cu",
                        "osu_dreamer_tpu/ops/long_attention.py:274"),
    "swiglu_bwd": ("osu_dreamer_tpu_torch/csrc/swiglu_bwd.cu", "osu_dreamer_tpu/ops/swiglu.py:492"),
    "fused_attention_fwd": ("osu_dreamer_tpu_torch/csrc/fused_attention.cu",
                            "osu_dreamer_tpu/ops/fused_attention.py:345"),
    "fused_attention_bwd": ("osu_dreamer_tpu_torch/csrc/fused_attention.cu",
                            "osu_dreamer_tpu/ops/fused_attention.py:399"),
}
INFERENCE_KERNELS = ("resonator", "film_layer", "swiglu", "flash_attention")
TRAINING_KERNELS = ("swiglu", "swiglu_bwd", "fused_attention_fwd", "fused_attention_bwd")


def log(msg: str) -> None:
    print(msg, flush=True)


def synth_wave(seed: int, seconds: float, sr: int) -> np.ndarray:
    """clicks on a beat grid over a few decaying tones"""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n, dtype=np.float64) / sr
    wave = np.zeros(n)
    for f in rng.uniform(60.0, 2000.0, size=4):
        wave += 0.1 * np.sin(2 * np.pi * f * t) * (0.5 + 0.5 * np.sin(2 * np.pi * t / rng.uniform(3, 9)))
    beat = 60.0 / rng.uniform(90, 180)
    burst = rng.normal(size=400) * np.exp(-np.arange(400) / 60.0)
    for onset in np.arange(0.5, seconds - 0.1, beat / 2):
        i = int(onset * sr)
        wave[i : i + 400] += 0.6 * burst
    return wave.astype(np.float32)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from osu_dreamer_tpu_torch.audio import spectrogram
    from osu_dreamer_tpu_torch.audio.constants import SR
    from osu_dreamer_tpu_torch.audio.spectrogram import prep_wave_for_model
    from osu_dreamer_tpu_torch.models.inference.artifact import init_random
    from osu_dreamer_tpu_torch.models.inference.model import LDM, LDMArgs
    from osu_dreamer_tpu_torch.models.inference.sampler import build_batch_sampler
    from osu_dreamer_tpu_torch.nn import attention, blocks
    from osu_dreamer_tpu_torch.ops import (
        _build, film_layer, fused_attention, long_attention, resonator, swiglu,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout
    nvcc = next(line for line in nvcc.splitlines() if "release" in line).strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc {nvcc} "
        f"python {sys.version.split()[0]}")

    path, seconds = _build.build()
    log(f"kernels built in {seconds:.1f} s -> {path.relative_to(ROOT)}")
    _build.library()

    # ---- 1. each kernel against its plain version at the slice's shapes ----
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def ffn(C, H, K=5):
        return [rnd(K, C, scale=0.4), rnd(C, scale=0.1), rnd(C, 2 * H, scale=C**-0.5),
                rnd(2 * H, scale=0.1), rnd(H, C, scale=H**-0.5), rnd(C, scale=0.1)]

    def film_args(B, L, zero_film):
        C = 128
        film = [torch.zeros(B, C, dtype=torch.bfloat16, device=dev) if zero_film
                else rnd(B, C, scale=0.3) for _ in range(3)]
        return (rnd(B, L, C), *film, 1 + rnd(C, scale=0.1), 1 + rnd(C, scale=0.1), *ffn(C, 341))

    S, D = 2, len(DIFFS)
    B = S * D
    cases = {  # name -> (kernel, plain, [(label, args)]); the first is the JSON line's time
        "resonator": (resonator.resonate_cuda, resonator.resonate_plain, [
            ("S2 K20480", (rnd(S, 20480, 98, scale=0.3, dtype=torch.float32),)),
        ]),
        "film_layer": (film_layer.film_layer_cuda, film_layer.film_layer_plain, [
            ("B4 L20493 FiLM", film_args(B, 20493, False)),
            ("B2 L20493 zero FiLM", film_args(S, 20493, True)),
            ("B4 L2277 FiLM", film_args(B, 2277, False)),
        ]),
        "swiglu": (swiglu.swiglu_cuda, swiglu.swiglu_plain, [
            ("B4 L759 C512", (rnd(B, 759, 512), *ffn(512, 1365))),
            ("B128 L152 C512 (training)", (rnd(128, 152, 512), *ffn(512, 1365))),
        ]),
        "flash_attention": (long_attention.attention_cuda, long_attention.attention_plain, [
            ("B4 L759 H16", tuple(rnd(B, 759, 16, 64) for _ in range(3))),
            ("B1 L2500 H16", tuple(rnd(1, 2500, 16, 64) for _ in range(3))),
        ]),
    }

    def cuda_ms(fn, args, reps=20) -> float:
        fn(*args)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    results = {}
    for name, (kernel, plain, shapes) in cases.items():
        worst = 0.0
        for i, (label, args) in enumerate(shapes):
            got, want = kernel(*args).float(), plain(*args).float()
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"{name} {label}: non-finite kernel output")
            err = (got - want).abs().max().item()
            if name == "resonator":
                tol = F32_ATOL
            else:
                tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
            log(f"{name} {label}: max_abs_err {err:.3g} (tolerance {tol:.3g})")
            if not err <= tol:
                raise RuntimeError(f"{name} {label}: kernel disagrees with its plain version")
            worst = max(worst, err)
            ms, plain_ms = cuda_ms(kernel, args), cuda_ms(plain, args)
            log(f"{name} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if i == 0:
                results[name] = {"ms": ms, "plain_ms": plain_ms}
        results[name]["max_abs_err"] = worst

    # ---- 1b. the training kernels at the denoiser's training shape ----
    def check_grads(label, names, got, ref, plain) -> float:
        """each kernel gradient within GRAD_REL of the largest magnitude of
        the f32 plain gradient -> the worst max abs error"""
        worst = 0.0
        for name, g, r, p in zip(names, got, ref, plain):
            g, r, p = g.float(), r.float(), p.float()
            if not bool(torch.isfinite(g).all()):
                raise RuntimeError(f"{label} {name}: non-finite kernel gradient")
            err, scale = (g - r).abs().max().item(), r.abs().max().item()
            log(f"{label} {name}: max_abs_err {err:.4g} vs f32 (plain bf16 "
                f"{(p - r).abs().max().item():.4g}; tolerance {GRAD_REL * scale:.4g} = "
                f"{GRAD_REL} x max |f32| {scale:.4g})")
            if not err <= GRAD_REL * scale:
                raise RuntimeError(f"{label} {name}: kernel gradient disagrees with the plain one")
            worst = max(worst, err)
        return worst

    def backward_ms(fn, leaves, grad_out) -> float:
        """CUDA-event ms of autograd's backward over a graph built once"""
        leaves = [t.detach().requires_grad_() for t in leaves]
        y = fn(*leaves)
        return cuda_ms(lambda: torch.autograd.grad(y, leaves, grad_out, retain_graph=True), ())

    H_ATT = 16
    for i, (label, Bt, Lt) in enumerate((("B128 L152 H16", 128, 152), ("B4 L77 H16", 4, 77))):
        qkv = rnd(Bt, Lt, 3 * H_ATT * 64, scale=0.7)
        qg, kg = (1 + rnd(64, scale=0.1, dtype=torch.float32) for _ in range(2))
        fwd_args = (qkv, qg, kg, H_ATT)
        res = fused_attention.fused_attention_fwd_cuda(*fwd_args)
        want = fused_attention.rope_attention_plain(*fwd_args).float()
        torch.cuda.synchronize()
        err = (res[0].float() - want).abs().max().item()
        tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
        log(f"fused_attention_fwd {label}: max_abs_err {err:.3g} (tolerance {tol:.3g})")
        if not (bool(torch.isfinite(res[0]).all()) and err <= tol):
            raise RuntimeError(f"fused_attention_fwd {label}: kernel disagrees with its plain version")
        grad = rnd(Bt, Lt, H_ATT * 64)
        bwd_args = (qkv, grad, *res, qg, kg, H_ATT)
        worst_bwd = check_grads(
            f"fused_attention_bwd {label}", ("dqkv", "dq_gamma", "dk_gamma"),
            fused_attention.fused_attention_bwd_cuda(*bwd_args),
            fused_attention.fused_attention_bwd_plain(qkv.float(), grad.float(), *res, qg, kg, H_ATT),
            fused_attention.fused_attention_bwd_plain(*bwd_args),
        )
        times = {
            "fused_attention_fwd": (cuda_ms(fused_attention.fused_attention_fwd_cuda, fwd_args),
                                    cuda_ms(fused_attention.rope_attention_plain, fwd_args), err),
            "fused_attention_bwd": (
                cuda_ms(fused_attention.fused_attention_bwd_cuda, bwd_args),
                backward_ms(lambda a, b, c: fused_attention.rope_attention_plain(a, b, c, H_ATT),
                            (qkv, qg, kg), grad),
                worst_bwd),
        }
        for name, (ms, plain_ms, e) in times.items():
            log(f"{name} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if i == 0:
                results[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": e}
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], e)

    for i, (label, Bt, Lt) in enumerate((("B128 L152 C512 H1365", 128, 152),
                                         ("B4 L77 C512 H1365", 4, 77))):
        x = rnd(Bt, Lt, 512)
        w = [t.float() for t in ffn(512, 1365)[:5]]  # f32 parameters, as in training
        go = rnd(Bt, Lt, 512)
        names = ("dx", "d_dw_kernel", "d_dw_bias", "d_vg_kernel", "d_vg_bias", "d_out_kernel",
                 "d_out_bias")
        worst_bwd = check_grads(
            f"swiglu_bwd {label}", names, swiglu.swiglu_bwd_cuda(x, *w, go),
            swiglu.swiglu_bwd_plain(x.float(), *w, go.float()), swiglu.swiglu_bwd_plain(x, *w, go),
        )
        ms = cuda_ms(swiglu.swiglu_bwd_cuda, (x, *w, go))
        zero_bias = torch.zeros(512, device=dev)
        plain_ms = backward_ms(lambda *a: swiglu.swiglu_plain(*a, zero_bias), (x, *w), go)
        log(f"swiglu_bwd {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if i == 0:
            results["swiglu_bwd"] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": worst_bwd}
        results["swiglu_bwd"]["max_abs_err"] = max(results["swiglu_bwd"]["max_abs_err"], worst_bwd)

    # ---- 2. small slice: through the kernels vs through the plain versions ----
    args = LDMArgs()
    model = init_random(args, torch.Generator(device=dev).manual_seed(SEED), dev)
    assert model.dtype == torch.bfloat16
    sample = build_batch_sampler(model)
    chunk = args.latent.chunk_size
    labels = torch.tensor(DIFFS, dtype=torch.float32, device=dev)

    def upload(waves_np):
        preps = [prep_wave_for_model(w, chunk) for w in waves_np]
        if len({p[2] for p in preps}) != 1:
            raise ValueError("songs of one batch must share a wave bucket")
        waves = torch.from_numpy(np.stack([p[0] for p in preps])).to(dev)
        real = torch.tensor([p[1] for p in preps], device=dev)
        return waves, real, preps[0][2], preps[0][3]

    @contextmanager
    def plain_ops():
        """every kernel dispatch swapped for its plain version (the SwiGLU
        and attention backward then come from autograd of the plain ones)"""
        saved = (blocks.film_layer, blocks.swiglu, attention.long_flash_attention,
                 attention.fused_norm_rope_attention, spectrogram.resonate_frames)
        blocks.film_layer, blocks.swiglu = film_layer.film_layer_plain, swiglu.swiglu_plain
        attention.long_flash_attention = long_attention.attention_plain
        attention.fused_norm_rope_attention = fused_attention.rope_attention_plain
        spectrogram.resonate_frames = resonator.resonate_plain
        try:
            yield
        finally:
            (blocks.film_layer, blocks.swiglu, attention.long_flash_attention,
             attention.fused_norm_rope_attention, spectrogram.resonate_frames) = saved

    small = upload([synth_wave(SEED + 10 + i, 6.0, SR) for i in range(S)])
    reference = LDM(args, torch.float32).to(dev).eval()
    reference.load_state_dict(model.state_dict())
    charts = {}
    for name, ldm, use_plain in (("kernels", model, False), ("plain", model, True),
                                 ("plain_f32", reference, True)):
        with torch.inference_mode(), (plain_ops() if use_plain else nullcontext()):
            spec = spectrogram.spec_for_model_batch(*small)
            chart, lab = ldm(spec, labels, 4, style_steps=4, style_guidance=2.0,
                             generator=torch.Generator(device=dev).manual_seed(SEED))
        charts[name] = torch.cat([chart.float().flatten(), lab.float().flatten()])
    if not bool(torch.isfinite(charts["kernels"]).all()):
        raise RuntimeError("small slice: non-finite output")
    err = {k: (charts[k] - charts["plain_f32"]).abs() for k in ("kernels", "plain")}
    log("small slice (2 songs x 2 diffs, 6 s, 4 steps, CFG 2.0), distance from the f32 "
        "plain path: " + ", ".join(
            f"bf16 {k} max {e.max().item():.4g} mean {e.mean().item():.4g}" for k, e in err.items()))
    if not (err["kernels"].mean() <= SLICE_MEAN_RATIO * err["plain"].mean()
            and err["kernels"].max() <= SLICE_MAX_RATIO * err["plain"].max()):
        raise RuntimeError("small slice: the kernel path is farther from the f32 reference "
                           "than the plain bf16 path")

    # ---- 3. the full-width slice ----
    waves_np = [synth_wave(SEED + i, SONG_SECONDS, SR) for i in range(S)]

    def request(guidance: float, seed: int):
        t0 = time.perf_counter()
        waves, real, n_frames, out_frames = upload(waves_np)
        generator = torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            hit, xy, lab = sample(waves, real, labels, generator, n_frames, out_frames, STEPS,
                                  guidance)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        out = hit.cpu().numpy(), xy.cpu().numpy(), lab.float().cpu().numpy()
        return time.perf_counter() - t0, out_frames, out

    request(1.0, SEED)  # warm-up
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    runs = [(g, *request(g, SEED + 1)) for g in (1.0, 1.0, 1.0, 2.0)]
    launches_infer = dict(_build.launches)
    log(f"launches during the full-width inference runs: {launches_infer}")
    missing = [k for k in INFERENCE_KERNELS if launches_infer[k] == 0]
    if missing:
        raise RuntimeError(f"the inference path never launched: {missing}")

    for guidance, wall, out_frames, (hit, xy, lab) in runs:
        if hit.shape != (B, out_frames, 7) or hit.dtype != np.uint8:
            raise RuntimeError(f"bad hit output {hit.shape} {hit.dtype}")
        if xy.shape != (B, out_frames, 2) or xy.dtype != np.int16:
            raise RuntimeError(f"bad xy output {xy.shape} {xy.dtype}")
        if lab.shape != (B, 5) or not np.isfinite(lab).all() or lab.min() < 0 or lab.max() > 10:
            raise RuntimeError(f"bad labels {lab}")
        if hit.max() == hit.min():
            raise RuntimeError("the hit channels are constant")
        log(f"request (S={S} songs x D={D} diffs, {SONG_SECONDS:.0f} s, {STEPS} steps, "
            f"guidance {guidance}): {wall * 1e3:.1f} ms wall, "
            f"{B / wall * 60:.1f} maps/min [{smi}]")
    same = all(np.array_equal(a, b) for a, b in zip(runs[0][3], runs[1][3]))
    if not same:
        raise RuntimeError("two seeded runs of the same request differ")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- 4. full-width denoiser training through fit.run ----
    from osu_dreamer_tpu_torch.data.synth import write_latent_corpus
    from osu_dreamer_tpu_torch.models.diffusion import fit as diffusion_fit
    from osu_dreamer_tpu_torch.models.diffusion.model import DiffusionModel, DiffusionModelArgs
    from osu_dreamer_tpu_torch.models.diffusion.train import (
        DiffusionTrainArgs, LatentBatch, diffusion_loss,
    )
    from osu_dreamer_tpu_torch.train.state import stratified_logit_normal_t
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict, load_yaml_config

    cfg = load_yaml_config(diffusion_fit.CONFIG)
    md = cfg["model"]
    workdir = ROOT / "build" / "smoke_fit"
    shutil.rmtree(workdir, ignore_errors=True)
    steps = TRAIN_WARMUP + TRAIN_TIMED
    t0 = time.perf_counter()
    # 64 mapsets x 4 maps x 12 windows of 152; 2 mapsets held out for
    # validation, 62 x 48 = 2976 training windows >= 22 batches of 128
    write_latent_corpus(workdir / "data", 64, 4, 152 * 12, md["a_dim"], md["emb_dim"],
                        md["style_dim"], SEED)
    cfg["data"].update(data_dir=str(workdir / "data"), max_per_map=-1, max_val_count=2)
    cfg["fit"].update(run_dir=str(workdir / "runs"), max_steps=steps, log_every=5)
    log(f"synthetic cached-latent corpus written in {time.perf_counter() - t0:.1f} s")

    marks: dict[int, tuple[float, dict]] = {}
    step_metrics: list[dict] = []

    def on_step(step: int, metrics: dict) -> None:
        step_metrics.append(metrics)
        if step in (TRAIN_WARMUP, steps):
            torch.cuda.synchronize()
            marks[step] = (time.perf_counter(), dict(_build.launches))
            if step == TRAIN_WARMUP:
                torch.cuda.reset_peak_memory_stats()

    _build.reset_launches()
    state = diffusion_fit.run(cfg, device=dev, on_step=on_step)
    launches_train = dict(_build.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"launches during fit-denoiser: {launches_train}")
    if state.step != steps or len(step_metrics) != steps:
        raise RuntimeError(f"fit-denoiser ran {state.step} steps, not {steps}")
    (ta, la), (tb, lb) = marks[TRAIN_WARMUP], marks[steps]
    timed = {k: lb[k] - la[k] for k in TRAINING_KERNELS}
    log(f"launches during the {TRAIN_TIMED} timed steps: {timed}")
    missing = [k for k, n in timed.items() if n == 0]
    if missing:
        raise RuntimeError(f"the training path never launched: {missing}")
    losses = {k: [float(m[k]) for m in step_metrics] for k in ("loss", "osl", "del", "u_mape")}
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise RuntimeError(f"non-finite training loss: {losses}")
    for ckpt in ("last", "best"):
        if not (workdir / "runs" / ckpt / "state.pt").exists():
            raise RuntimeError(f"fit-denoiser wrote no {ckpt} checkpoint")
    ms_step = (tb - ta) / TRAIN_TIMED * 1e3
    log(f"fit-denoiser (depth 8, width 512, 16 x 64 heads, B128 x L152, bf16): "
        f"{ms_step:.2f} ms/step, {1e3 / ms_step:.3f} steps/s over {TRAIN_TIMED} steps after "
        f"{TRAIN_WARMUP} warm-up; peak device memory {peak_gib:.2f} GiB [{smi}]")
    log("losses per step: " + json.dumps({k: [round(x, 5) for x in v] for k, v in losses.items()})
        + f" [{smi}]")
    del state
    torch.cuda.empty_cache()

    # one step through the kernels and through the plain versions (bf16),
    # each against a plain f32 step on the same batch, t and x0; random
    # full-strength weights (flax's zero-initialised layers would leave most
    # gradients exactly zero)
    model_args = dataclass_from_dict(DiffusionModelArgs, cfg["model"])
    train_args = dataclass_from_dict(DiffusionTrainArgs, cfg["train"])
    bf16_model = DiffusionModel(model_args, torch.bfloat16).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    with torch.no_grad():
        for name, p in bf16_model.named_parameters():
            draw = torch.randn(p.shape, generator=gen, device=dev)
            if p.dim() >= 2:
                draw = draw / float(np.prod(p.shape[:-1])) ** 0.5
            elif name.endswith("gamma"):
                draw = 1.0 + 0.1 * draw
            else:
                draw = 0.1 * draw
            p.copy_(draw)
    f32_model = DiffusionModel(model_args, torch.float32).to(dev)
    f32_model.load_state_dict(bf16_model.state_dict())
    Bt, Lt = 128, 152
    z = torch.randn(Bt, Lt, md["emb_dim"], generator=gen, device=dev)
    batch = LatentBatch(h=torch.rand(Bt, Lt, md["a_dim"], generator=gen, device=dev),
                        z=z / z.square().mean(-1, keepdim=True).sqrt(),
                        s=torch.randn(Bt, md["style_dim"], generator=gen, device=dev),
                        labels=torch.rand(Bt, 5, generator=gen, device=dev) * 10)
    t_inj = stratified_logit_normal_t(Bt, gen, dev)
    x0_inj = torch.randn(batch.z.shape, generator=gen, device=dev)

    def loss_and_grads(model, plain: bool):
        with plain_ops() if plain else nullcontext():
            loss, aux = diffusion_loss(model, batch, train_args, t=t_inj, x0=x0_inj)
            grads = torch.autograd.grad(loss, list(model.parameters()))
        terms = torch.stack([aux[k].detach().float() for k in ("loss", "osl", "del", "u_mape")])
        return terms, torch.cat([g.flatten().float() for g in grads])

    ref_terms, ref_grads = loss_and_grads(f32_model, True)
    step_err = {}
    for name, plain in (("kernels", False), ("plain", True)):
        terms, grads = loss_and_grads(bf16_model, plain)
        step_err[name] = ((terms - ref_terms).abs(), (grads - ref_grads).abs())
    (kt, kg), (pt, pg) = step_err["kernels"], step_err["plain"]
    log(f"one train step vs the f32 plain step: loss terms (loss, osl, del, u_mape) f32 "
        f"{ref_terms.tolist()}, |err| kernels {kt.tolist()} plain bf16 {pt.tolist()}; "
        f"gradients ({ref_grads.numel()} values, max |f32| {ref_grads.abs().max().item():.4g}) "
        f"kernels mean {kg.mean().item():.4g} max {kg.max().item():.4g}, plain bf16 mean "
        f"{pg.mean().item():.4g} max {pg.max().item():.4g}")
    if not bool((kt <= torch.maximum(SLICE_MAX_RATIO * pt, LOSS_FLOOR * ref_terms.abs())).all()):
        raise RuntimeError("train step: the kernel path's loss is farther from the f32 step than "
                           "the plain bf16 path's")
    if not (kg.mean() <= SLICE_MEAN_RATIO * pg.mean() and kg.max() <= SLICE_MAX_RATIO * pg.max()):
        raise RuntimeError("train step: the kernel path's gradients are farther from the f32 "
                           "step than the plain bf16 path's")
    shutil.rmtree(workdir, ignore_errors=True)

    kernels = [
        {"name": name, "route": "cuda", "source": KERNEL_META[name][0],
         "replaces": KERNEL_META[name][1],
         "launches": launches_infer[name] + launches_train[name], **results[name]}
        for name in _build.KERNELS
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
