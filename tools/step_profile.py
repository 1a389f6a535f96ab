#!/usr/bin/env python3
"""The FFN backward kernels and one train step of each stage on the card,
for the checkout in the working directory, read with this repository's
chip_smoke.py measures (its graph-replay timer, ``step_kernels`` and the
kernel families, which name this tree's kernels and the parent's):

    cd CHECKOUT && python3 /path/to/this/repo/tools/step_profile.py [SECTION ...]

tools/parent_vs_change.sh runs it from both checkouts in one call, so the
two trees are timed by the same code. SECTION names what to run (K1, K11,
K12, K3, K5, K6, K9, K10, latent, denoiser, prologue; all of them when none
is named).
It prints the card's name and power limit, then:
- the resonator (K1) at S2 K20480 and the fused prologue forward (K11) at
  B4 L759 and B128 L152 (C512 F3072; f32 parameters holding bf16 values, as
  chip_smoke.py passes them): device ms a call over replays of a CUDA graph
  of 20 calls, the plain version's the same way, then each kernel's device
  ms a call (torch.profiler over 5 calls), so a kernel of several launches
  shows each;
- the fused prologue backward (K12) at the shapes of chip_smoke.py phase 1d
  (B128 L152 C512, B4 L77 C512, B128 L152 C384, B128 L152 C640, F 3072):
  device ms a call by graph replay, autograd of the plain version the same
  way, then each kernel's device ms a call (torch.profiler over 5 calls),
  which splits it by launch;
- K3 (film-layer backward) at B64 L1026 and B64 L38, C 128, K6 (SwiGLU
  partial backward, its two torch matmuls included) at B128 L152 C512 and
  K5 at B128 L152 C384, and the fused norm + RoPE attention forward (K9)
  and backward (K10) at B128 L152 H16: device ms a call over replays of a
  CUDA graph of 20 calls, then each kernel's device ms a call
  (torch.profiler over 5 calls);
- one full-width latent train step (the package config, B32 x 2052) and one
  denoiser step (B128 x L152, width 512), also with
  OSU_DREAMER_FUSED_PROLOGUE=1, on a random batch, seeded, after two
  warm-up steps, under torch.profiler: device-busy ms and the FFN
  backward's kernel ms (with the prologue on, K11's and K12's too);
- (section "long") phase 4f's denoiser step at 16 x 64 heads, B64 x L320
  (past the JAX gate: the streamed K7 with lse and the long attention
  backward), with the long backward of this tree and, where the checkout's
  chip_smoke.py has it, its two-launch design (``two_launch_bwd``) in
  turns (one pass, two launches, one pass, two launches): host ms a step
  over LONG_STEPS synchronised steps, then one step under torch.profiler
  (device busy, the long backward's and K7's ms).
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from contextlib import nullcontext
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SEED = 0
SECTIONS = ("K1", "K11", "K12", "K3", "K5", "K6", "K9", "K10", "latent", "denoiser",
            "prologue", "long")
# section "long": phase 4f's denoiser step (16 x 64 heads, B64 x L320, past
# the JAX gate), its long attention backward by the one pass and by the
# two-launch design in turns; host ms over LONG_STEPS steps each turn
LONG_STEPS = 10
LONG_FAMILIES = {"long backward": r"long_attention_bwd_kernel|attention_delta_kernel"
                                  r"|attention_stream_bwd",
                 "K7 streamed": r"attention_stream_fwd_kernel"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("step_profile: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    wanted = set(sys.argv[1:]) or set(SECTIONS)
    if wanted - set(SECTIONS):
        print(f"step_profile: unknown sections {sorted(wanted - set(SECTIONS))}; "
              f"choose from {SECTIONS}", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())  # the checkout's package
    spec = importlib.util.spec_from_file_location("chip_smoke_measures", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from osu_dreamer_tpu_torch.models.diffusion import fit as diffusion_fit
    from osu_dreamer_tpu_torch.models.diffusion.model import DiffusionModelArgs
    from osu_dreamer_tpu_torch.models.diffusion.train import (
        DiffusionTrainArgs, LatentBatch, init_diffusion_training,
    )
    from osu_dreamer_tpu_torch.models.latent import fit as latent_fit
    from osu_dreamer_tpu_torch.models.latent.model import LatentModelArgs
    from osu_dreamer_tpu_torch.models.latent.train import (
        Batch, LatentTrainArgs, init_latent_training,
    )
    from osu_dreamer_tpu_torch.ops import film_layer, film_qkv, fused_attention, resonator, swiglu
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict, load_yaml_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; checkout {os.getcwd()}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def ffn(C, H):  # f32 parameters holding bf16 values, as in training
        return [rnd(5, C, scale=0.4).float(), rnd(C, scale=0.1).float(),
                rnd(C, 2 * H, scale=C**-0.5).float(), rnd(2 * H, scale=0.1).float(),
                rnd(H, C, scale=H**-0.5).float(), rnd(C, scale=0.1).float()]

    def kernels(fn, args, calls=5) -> str:
        """each kernel's device ms a call, by name (its template arguments
        kept), in the order of its first launch"""
        fn(*args)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(*args)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmpdir:
            trace = Path(tmpdir) / "trace.json"
            prof.export_chrome_trace(str(trace))
            events = json.loads(trace.read_text())["traceEvents"]
        times: dict[str, float] = {}
        for e in sorted((e for e in events if e.get("cat") == "kernel" and "dur" in e),
                        key=lambda e: float(e["ts"])):
            name = e["name"].split("(")[0].replace("void ", "").replace("odt::", "")[:60]
            times[name] = times.get(name, 0.0) + float(e["dur"]) / 1e3 / calls
        return "; ".join(f"{k} {v:.4f}" for k, v in times.items())

    if "K1" in wanted:
        frames = rnd(2, 20480, 98, scale=0.3, dtype=torch.float32)
        print(f"K1 resonator S2 K20480: {smoke.graph_ms(resonator.resonate_cuda, (frames,)):.4f} ms "
              f"(graph replay), plain {smoke.graph_ms(resonator.resonate_plain, (frames,)):.4f} ms; "
              f"by kernel, ms: {kernels(resonator.resonate_cuda, (frames,))} [{smi}]", flush=True)
        del frames

    def prologue(B, L, C):  # f32 parameters holding bf16 values, as chip_smoke.py passes them
        return (rnd(B, L, C), rnd(B, C, scale=0.3), rnd(B, C, scale=0.3), rnd(B, L, C, scale=0.5),
                rnd(C, 3072, scale=C**-0.5).float(), rnd(3072, scale=0.1).float())

    for B, L in ((4, 759), (128, 152)) if "K11" in wanted else ():
        args = prologue(B, L, 512)
        print(f"K11 film_qkv_fwd B{B} L{L} C512 F3072: "
              f"{smoke.graph_ms(film_qkv.film_qkv_fwd_cuda, args):.4f} ms (graph replay), plain "
              f"{smoke.graph_ms(film_qkv.film_qkv_plain, args):.4f} ms; by kernel, ms: "
              f"{kernels(film_qkv.film_qkv_fwd_cuda, args)} [{smi}]", flush=True)
    for B, L, C in ((128, 152, 512), (4, 77, 512), (128, 152, 384), (128, 152, 640)):
        if "K12" not in wanted:
            break
        args = (*prologue(B, L, C), rnd(B, L, 3072))
        print(f"K12 film_qkv_bwd B{B} L{L} C{C} F3072: "
              f"{smoke.graph_ms(film_qkv.film_qkv_bwd_cuda, args):.4f} ms (graph replay), plain "
              f"{smoke.graph_grad_ms(film_qkv.film_qkv_plain, args[:6], args[6]):.4f} ms; by "
              f"kernel, ms: {kernels(film_qkv.film_qkv_bwd_cuda, args)} [{smi}]", flush=True)
    args = None
    for B, L in ((64, 1026), (64, 38)) if "K3" in wanted else ():
        args = (rnd(B, L, 128), *(rnd(B, 128, scale=0.3) for _ in range(3)),
                1 + rnd(128, scale=0.1), 1 + rnd(128, scale=0.1), *ffn(128, 341), rnd(B, L, 128))
        print(f"K3 film_layer_bwd B{B} L{L} C128 H341: "
              f"{smoke.graph_ms(film_layer.film_layer_bwd_cuda, args):.4f} ms (graph replay); by kernel, "
              f"ms: {kernels(film_layer.film_layer_bwd_cuda, args)} [{smi}]", flush=True)
    for name, fn, C, H in (("K6 swiglu_bwd", swiglu.swiglu_bwd_cuda, 512, 1365),
                           ("K5 swiglu_bwd_full", swiglu.swiglu_bwd_full_cuda, 384, 1024)):
        if name[:2] not in wanted:
            continue
        args = (rnd(128, 152, C), *ffn(C, H)[:5], rnd(128, 152, C))
        print(f"{name} B128 L152 C{C} H{H}: {smoke.graph_ms(fn, args):.4f} ms (graph replay); by "
              f"kernel, ms: {kernels(fn, args)} [{smi}]", flush=True)
    if wanted & {"K9", "K10"}:
        qkv = rnd(128, 152, 3 * 16 * 64, scale=0.7)
        qg, kg = (1 + rnd(64, scale=0.1, dtype=torch.float32) for _ in range(2))
        res = fused_attention.fused_attention_fwd_cuda(qkv, qg, kg, 16)
        for name, fn, args in (
                ("K9 fused_attention_fwd", fused_attention.fused_attention_fwd_cuda,
                 (qkv, qg, kg, 16)),
                ("K10 fused_attention_bwd", fused_attention.fused_attention_bwd_cuda,
                 (qkv, rnd(128, 152, 16 * 64), *res, qg, kg, 16))):
            if name.split()[0] in wanted:
                print(f"{name} B128 L152 H16: {smoke.graph_ms(fn, args):.4f} ms (graph replay); "
                      f"by kernel, ms: {kernels(fn, args)} [{smi}]", flush=True)
        del qkv, res
    args = None
    torch.cuda.empty_cache()

    def profile(what, state, step, batch, families) -> None:
        for _ in range(2):
            step(state, batch)
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmpdir:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                step(state, batch)
                torch.cuda.synchronize()
            trace = Path(tmpdir) / "trace.json"
            prof.export_chrome_trace(str(trace))
            print(f"{what}: one step under torch.profiler: "
                  f"{smoke.step_kernels(trace, families)} [{smi}]", flush=True)

    if "latent" in wanted:
        cfg = load_yaml_config(latent_fit.CONFIG)
        margs = dataclass_from_dict(LatentModelArgs, cfg["model"])
        state, step = init_latent_training(
            margs, dataclass_from_dict(LatentTrainArgs, cfg["train"]), SEED, dev, torch.bfloat16)
        smoke.randomize_(state.model, gen)
        Bt, Lt = cfg["data"]["batch_size"], cfg["data"]["seq_len"]
        batch = Batch(audio=torch.rand(Bt, Lt, 72, generator=gen, device=dev),
                      chart=torch.rand(Bt, Lt, 9, generator=gen, device=dev),
                      labels=torch.rand(Bt, 5, generator=gen, device=dev) * 10)
        profile(f"latent step (B{Bt} x L{Lt})", state, step, batch, smoke.LATENT_FAMILIES)
        del state, step, batch
        torch.cuda.empty_cache()

    for what, families, env in (("denoiser step", smoke.DENOISER_FAMILIES, nullcontext),
                                ("denoiser step, OSU_DREAMER_FUSED_PROLOGUE=1",
                                 {**smoke.DENOISER_FAMILIES, **smoke.PROLOGUE_FAMILIES},
                                 smoke.fused_prologue)):
        if ("prologue" if env is smoke.fused_prologue else "denoiser") not in wanted:
            continue
        cfg = load_yaml_config(diffusion_fit.CONFIG)
        md = cfg["model"]
        state, step = init_diffusion_training(
            dataclass_from_dict(DiffusionModelArgs, md),
            dataclass_from_dict(DiffusionTrainArgs, cfg["train"]), SEED, dev, torch.bfloat16)
        smoke.randomize_(state.model, gen)
        Bt, Lt = cfg["data"]["batch_size"], cfg["data"]["seq_len"]
        z = torch.randn(Bt, Lt, md["emb_dim"], generator=gen, device=dev)
        batch = LatentBatch(h=torch.rand(Bt, Lt, md["a_dim"], generator=gen, device=dev),
                            z=z / z.square().mean(-1, keepdim=True).sqrt(),
                            s=torch.randn(Bt, md["style_dim"], generator=gen, device=dev),
                            labels=torch.rand(Bt, 5, generator=gen, device=dev) * 10)
        with env():
            profile(f"{what} (B{Bt} x L{Lt})", state, step, batch, families)
        del state, step, batch
        torch.cuda.empty_cache()

    if "long" in wanted:
        import time

        from osu_dreamer_tpu_torch.ops import long_attention

        cfg = load_yaml_config(diffusion_fit.CONFIG)
        md = cfg["model"]
        state, step = init_diffusion_training(
            dataclass_from_dict(DiffusionModelArgs, md),
            dataclass_from_dict(DiffusionTrainArgs, cfg["train"]), SEED, dev, torch.bfloat16)
        smoke.randomize_(state.model, gen)
        Bt, Lt = 64, 320
        z = torch.randn(Bt, Lt, md["emb_dim"], generator=gen, device=dev)
        batch = LatentBatch(h=torch.rand(Bt, Lt, md["a_dim"], generator=gen, device=dev),
                            z=z / z.square().mean(-1, keepdim=True).sqrt(),
                            s=torch.randn(Bt, md["style_dim"], generator=gen, device=dev),
                            labels=torch.rand(Bt, 5, generator=gen, device=dev) * 10)
        one_pass = long_attention.attention_bwd_cuda
        designs = [("one pass", one_pass)]
        if hasattr(smoke, "two_launch_bwd"):
            designs.append(("two launches", smoke.two_launch_bwd))
        try:
            for what, bwd in designs * 2:
                long_attention.attention_bwd_cuda = bwd
                for _ in range(2):
                    step(state, batch)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(LONG_STEPS):
                    step(state, batch)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / LONG_STEPS * 1e3
                print(f"denoiser step 16 x 64 heads B{Bt} x L{Lt}, long backward {what}: "
                      f"{ms:.2f} ms/step over {LONG_STEPS} steps [{smi}]", flush=True)
                profile(f"denoiser step 16 x 64 heads (B{Bt} x L{Lt}), long backward {what}",
                        state, step, batch, LONG_FAMILIES)
        finally:
            long_attention.attention_bwd_cuda = one_pass
        del state, step, batch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
