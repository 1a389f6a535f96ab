"""fit-denoiser: config -> cached-latent streams -> train loop.

Counterpart of osu_dreamer_tpu/models/diffusion/fit.py. Validation parity:
each held-out full map is cut into ``val_batches`` equal segments (padded or
cut to the training window), stacked as a batch and scored with the
distance-marching losses on the EMA weights; the checkpoint monitor is
val/loss.

The ``parallel:`` block (parallel/config.py): ``dp`` trains on that many
ranks, one a device, each on its rows of every global batch; ``sp`` shards
the window length over sp ranks (ring attention, halo'd convs); ``tp``
splits the attention heads and the FFN hidden units over model groups of tp
ranks (parallel/tp.py). Every window trains: where ``attention_route``
sends the attention off the fused kernels (beyond the JAX
``fused_attention_fits``), the long attention's forward and backward
kernels take it, as the JAX package differentiates its long attention
there. Refused before step 1, as the JAX train step fails there too (it
passes no dropout PRNG): ``backbone.dropout > 0``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from ...data.pipeline import (
    batched, count_latent_windows, hold_out_mapsets, latent_windows, prefetch,
)
from ...nn.schedule import lr_at
from ...train.checkpoint import restore_train_state
from ...train.loop import FitArgs, Stage, fit, parallel_context
from ...train.state import TrainState
from ...utils import dataclass_from_dict, load_yaml_config
from ...utils.device import resolve_device
from .model import DiffusionModelArgs
from .train import DiffusionTrainArgs, LatentBatch, diffusion_loss, init_diffusion_training

CONFIG = Path(__file__).parent / "config.yml"


@dataclass
class DiffusionDataArgs:
    data_dir: str = "./data"
    seq_len: int = 152
    batch_size: int = 128
    max_val_count: int = 128
    max_val_frac: float = 0.3
    max_per_map: int = 1
    shuffle_buffer: int = 512


def run(
    config: str | Path | dict | None = None,
    resume_from: str | None = None,
    device: torch.device | str = "cuda",
    on_step: Optional[Callable[[int, dict], None]] = None,
    devices: Optional[Sequence[torch.device | str]] = None,
) -> TrainState:
    """train the denoiser as ``config`` (a YAML file, by default the
    package's config.yml, or the parsed dict) says, on ``device`` (a CUDA
    card unless ``cpu`` is asked for); ``on_step(step, metrics)`` runs after
    every step (in every rank: a module-level function when the run is
    spread). ``devices``: the devices the ``parallel:`` block may spread the
    run over (one rank each; by default every visible device of
    ``device``'s type). A spread run returns rank 0's final state, read back
    from its ``last`` checkpoint"""
    device = resolve_device(device, "train")
    cfg = config if isinstance(config, dict) else load_yaml_config(config or CONFIG)
    model_args = dataclass_from_dict(DiffusionModelArgs, cfg.get("model", {}))
    train_args = dataclass_from_dict(DiffusionTrainArgs, cfg.get("train", {}))
    data_args = dataclass_from_dict(DiffusionDataArgs, cfg.get("data", {}))
    fit_args = dataclass_from_dict(FitArgs, cfg.get("fit", {}))
    par, device = parallel_context(cfg, data_args.batch_size, device, devices)
    bb = model_args.backbone
    if bb.seq_axis is not None:
        raise ValueError("backbone.seq_axis is set from parallel.sp, not by the model config")
    if par.sp_axis is not None:
        if data_args.seq_len % par.sp != 0:
            raise ValueError(
                f"data.seq_len {data_args.seq_len} must divide over "
                f"parallel.sp={par.sp}"
            )
        if bb.dropout > 0:
            raise ValueError(
                "parallel.sp with backbone.dropout > 0 is unsupported: "
                "per-shard dropout masks would be correlated"
            )
        # every shard must span the conv receptive radii (ffn radius + the
        # 2-frame u-head halo), or halo exchange degenerates
        min_shard = max(2, bb.radius)
        if data_args.seq_len // par.sp < min_shard:
            raise ValueError(
                f"seq_len/sp = {data_args.seq_len // par.sp} frames per shard "
                f"is below the {min_shard}-frame conv radius; lower "
                "parallel.sp"
            )
    if bb.dropout > 0:
        raise NotImplementedError(
            "backbone.dropout > 0 does not train: the JAX train step applies the model with "
            "no dropout PRNG and fails there too (flax InvalidRngError)")
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    if par.needs_launch:
        par.launch(run, cfg, resume_from, device, on_step, devices)
        state, _ = init_diffusion_training(model_args, train_args, fit_args.seed, device, dtype)
        return restore_train_state(Path(fit_args.run_dir) / "last", state)

    train_sets, val_sets = hold_out_mapsets(
        Path(data_args.data_dir), "*.latent.npz", data_args.max_val_count,
        data_args.max_val_frac,
    )
    state, train_step = init_diffusion_training(model_args, train_args, fit_args.seed, device,
                                                dtype, par)

    def to_device(b) -> LatentBatch:
        return LatentBatch(*(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in b))

    # multi-host: every host's epoch truncated to the same step count, so
    # the collectives stay in lockstep
    lockstep = par.lockstep_steps(count_latent_windows(
        train_sets, data_args.seq_len, data_args.max_per_map, shard=par.input_shard,
    )) if par.process_count > 1 else None

    def train_stream(epoch: int) -> Iterator[LatentBatch]:
        stream = latent_windows(
            train_sets, data_args.seq_len, shuffle_buffer=data_args.shuffle_buffer,
            max_per_map=data_args.max_per_map, seed=fit_args.seed + epoch,
            shard=par.input_shard,
        )
        batches = par.lockstep_stream(prefetch(batched(stream, par.local_batch_size)),
                                      lockstep)
        for b in batches:
            # this rank's rows, and under sp its span of h and z
            yield to_device(par.shard_batch(b, seq_fields=(0, 1)))

    val_seg, vb = data_args.seq_len, train_args.val_batches

    @torch.no_grad()
    def validate(state: TrainState) -> dict[str, float]:
        generator = torch.Generator(device=device).manual_seed(0)
        totals: dict[str, torch.Tensor] = {}
        n = 0
        for sample in latent_windows(val_sets, None):
            seg = sample.z.shape[0] // vb
            if seg == 0:
                continue
            take = vb * seg
            h = sample.h[:take].reshape(vb, seg, -1)
            z = sample.z[:take].reshape(vb, seg, -1)
            if seg < val_seg:  # pad segments to the training window
                pad = ((0, 0), (0, val_seg - seg), (0, 0))
                h, z = np.pad(h, pad, mode="edge"), np.pad(z, pad, mode="edge")
            else:
                h, z = h[:, :val_seg], z[:, :val_seg]
            batch = to_device((h, z, np.broadcast_to(sample.s, (vb, *sample.s.shape)),
                               np.broadcast_to(sample.labels, (vb, *sample.labels.shape))))
            _, aux = diffusion_loss(state.ema_model, batch, train_args, generator, train=False)
            for name, v in aux.items():
                totals[name] = totals.get(name, 0.0) + v
            n += 1
        return {f"val/{k}": float(v) / n for k, v in totals.items()} if n else {}

    stage = Stage(
        name="denoiser",
        hparams={"model": cfg.get("model", {}), "train": cfg.get("train", {})},
        state=state,
        train_step=train_step,
        train_stream=train_stream,
        validate=validate,
        lr_schedule=lambda step: lr_at(step, train_args.opt.lr, train_args.opt.schedule),
        on_step=on_step,
    )
    return fit(stage, fit_args, resume_from, par)
