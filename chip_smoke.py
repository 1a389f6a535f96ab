#!/usr/bin/env python3
"""Smoke check of the PyTorch port (osu_dreamer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout. It needs one CUDA card, ``nvcc`` for sm_90a and
nothing of JAX; without a card it exits nonzero and prints no result.

1. Builds the four CUDA kernels from osu_dreamer_tpu_torch/csrc/ (printing
   the build seconds) and holds each against its plain PyTorch version on
   the card at the shapes the inference slice gives it (bf16; f32 for the
   resonator; TF32 off), timing both with CUDA events.
2. Runs a small slice (2 short songs x 2 difficulties) through the kernels
   and through the plain versions in bf16, and holds both to the plain
   versions in f32.
3. Runs the full-width slice (LDMArgs() defaults, seeded random weights,
   bf16): two synthetic 120 s songs x two difficulty rows, 32 denoiser
   steps, 16 style steps, once more with style guidance 2.0. The device part
   runs under torch.cuda.set_sync_debug_mode("error"), so a host sync inside
   the samplers fails the run; every kernel's launch count must grow.

Prints the card's name and power limit, one JSON line of per-kernel results,
and last ``{"ok": true, "device": {...}}``. Any failure raises.
"""

from __future__ import annotations

import json
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

KERNEL_META = {
    "resonator": ("osu_dreamer_tpu_torch/csrc/resonator.cu", "osu_dreamer_tpu/ops/resonator.py:115"),
    "film_layer": ("osu_dreamer_tpu_torch/csrc/film_layer.cu", "osu_dreamer_tpu/ops/film_layer.py:401"),
    "swiglu": ("osu_dreamer_tpu_torch/csrc/swiglu.cu", "osu_dreamer_tpu/ops/swiglu.py:135"),
    "flash_attention": ("osu_dreamer_tpu_torch/csrc/flash_attention.cu",
                        "osu_dreamer_tpu/ops/long_attention.py:274"),
}


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
    from osu_dreamer_tpu_torch.ops import _build, film_layer, long_attention, resonator, swiglu

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
        saved = (blocks.film_layer, blocks.swiglu, attention.long_flash_attention,
                 spectrogram.resonate_frames)
        blocks.film_layer, blocks.swiglu = film_layer.film_layer_plain, swiglu.swiglu_plain
        attention.long_flash_attention = long_attention.attention_plain
        spectrogram.resonate_frames = resonator.resonate_plain
        try:
            yield
        finally:
            (blocks.film_layer, blocks.swiglu, attention.long_flash_attention,
             spectrogram.resonate_frames) = saved

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
    launches = dict(_build.launches)
    log(f"launches during the full-width runs: {launches}")
    missing = [k for k in _build.KERNELS if launches[k] == 0]
    if missing:
        raise RuntimeError(f"the main path never launched: {missing}")

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

    kernels = [
        {"name": name, "route": "cuda", "source": KERNEL_META[name][0],
         "replaces": KERNEL_META[name][1], "launches": launches[name], **results[name]}
        for name in _build.KERNELS
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
