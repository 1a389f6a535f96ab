"""fit-style: config -> style-code streams -> train loop.

Counterpart of osu_dreamer_tpu/models/style/fit.py. The training stream is
every map's (s, labels) from the encode-latents cache, batched with the last
partial batch dropped. Validation: the whole held-out split's style codes
and labels, collected once, scored with the distance-marching losses on the
EMA model (no label dropout) and with the generative metric suite
(``evaluate_style``); the checkpoint monitor is val/energy_dist. The
``parallel:`` block's ``dp`` trains on that many ranks, one a device
(parallel/config.py), and ``tp`` on model groups of replicas, since no leaf
is split; ``parallel.sp`` raises as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from ...data.pipeline import count_latent_windows, hold_out_mapsets, latent_windows, prefetch
from ...nn.schedule import lr_at
from ...train.checkpoint import restore_train_state
from ...train.loop import FitArgs, Stage, fit, parallel_context
from ...train.state import TrainState
from ...utils import dataclass_from_dict, load_yaml_config
from ...utils.device import resolve_device
from .model import StyleModelArgs
from .train import StyleTrainArgs, evaluate_style, init_style_training, style_loss

CONFIG = Path(__file__).parent / "config.yml"


@dataclass
class StyleDataArgs:
    data_dir: str = "./data"
    batch_size: int = 512
    max_val_count: int = 512
    max_val_frac: float = 0.3
    shuffle_buffer: int = 512


def _batched_pairs(stream: Iterable, batch_size: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """(s, labels) pairs -> stacked batches of ``batch_size``; the last
    partial batch is dropped, as in the JAX package"""
    buf_s, buf_l = [], []
    for s, l in stream:
        buf_s.append(s)
        buf_l.append(l)
        if len(buf_s) == batch_size:
            yield np.stack(buf_s), np.stack(buf_l)
            buf_s, buf_l = [], []


def run(
    config: str | Path | dict | None = None,
    resume_from: str | None = None,
    device: torch.device | str = "cuda",
    on_step: Optional[Callable[[int, dict], None]] = None,
    devices: Optional[Sequence[torch.device | str]] = None,
) -> TrainState:
    """train the style prior as ``config`` (a YAML file, by default the
    package's config.yml, or the parsed dict) says, on ``device`` (a CUDA
    card unless ``cpu`` is asked for); ``on_step(step, metrics)`` runs after
    every step (in every rank when the run is spread); ``devices`` and the
    return of a spread run as in models/diffusion/fit.py ``run``"""
    device = resolve_device(device, "train")
    cfg = config if isinstance(config, dict) else load_yaml_config(config or CONFIG)
    model_args = dataclass_from_dict(StyleModelArgs, cfg.get("model", {}))
    train_args = dataclass_from_dict(StyleTrainArgs, cfg.get("train", {}))
    data_args = dataclass_from_dict(StyleDataArgs, cfg.get("data", {}))
    fit_args = dataclass_from_dict(FitArgs, cfg.get("fit", {}))
    par, device = parallel_context(cfg, data_args.batch_size, device, devices)
    if par.sp_axis is not None:
        raise ValueError("parallel.sp applies to the denoiser stage only (its backbone is "
                         "sequence-parallel-aware); this stage scales via dp/tp")
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    if par.needs_launch:
        par.launch(run, cfg, resume_from, device, on_step, devices)
        state, _ = init_style_training(model_args, train_args, fit_args.seed, device, dtype)
        return restore_train_state(Path(fit_args.run_dir) / "last", state)

    train_sets, val_sets = hold_out_mapsets(
        Path(data_args.data_dir), "*.latent.npz", data_args.max_val_count,
        data_args.max_val_frac,
    )
    state, train_step = init_style_training(model_args, train_args, fit_args.seed, device, dtype,
                                            par)

    # multi-host: every host's epoch truncated to the same step count
    lockstep = par.lockstep_steps(count_latent_windows(
        train_sets, None, shard=par.input_shard,
    )) if par.process_count > 1 else None

    def train_stream(epoch: int):
        # style codes are per map: stream full maps, keep (s, labels)
        stream = (
            (sample.s, sample.labels)
            for sample in latent_windows(train_sets, None,
                                         shuffle_buffer=data_args.shuffle_buffer,
                                         seed=fit_args.seed + epoch, shard=par.input_shard)
        )
        batches = par.lockstep_stream(
            prefetch(_batched_pairs(stream, par.local_batch_size)), lockstep)
        for styles, labels in batches:
            styles, labels = par.shard_batch((styles, labels))
            yield (torch.from_numpy(styles).float().to(device),
                   torch.from_numpy(labels).float().to(device))

    # the val split, collected once (at most max_val_count maps)
    val = [(sample.s, sample.labels) for sample in latent_windows(val_sets, None)]
    val_s = val_labels = None
    if val:
        val_s = torch.from_numpy(np.stack([s for s, _ in val])).float().to(device)
        val_labels = torch.from_numpy(np.stack([l for _, l in val])).float().to(device)

    @torch.no_grad()
    def validate(state: TrainState) -> dict[str, float]:
        if val_s is None:
            return {}
        generator = torch.Generator(device=device).manual_seed(0)
        _, aux = style_loss(state.ema_model, val_s, val_labels, train_args, generator,
                            train=False)
        out = {f"val/{k}": float(v) for k, v in aux.items()}
        gen = evaluate_style(state.ema_model, val_s, val_labels, generator)
        out.update({f"val/{k}": v for k, v in gen.items()})
        return out

    stage = Stage(
        name="style",
        hparams={"model": cfg.get("model", {}), "train": cfg.get("train", {})},
        state=state,
        train_step=train_step,
        train_stream=train_stream,
        validate=validate,
        lr_schedule=lambda step: lr_at(step, train_args.opt.lr, train_args.opt.schedule),
        on_step=on_step,
    )
    return fit(stage, fit_args, resume_from, par)
