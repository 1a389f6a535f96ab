"""fit-style: config -> style-code streams -> train loop, on one device.

Counterpart of osu_dreamer_tpu/models/style/fit.py. The training stream is
every map's (s, labels) from the encode-latents cache, batched with the last
partial batch dropped. Validation: the whole held-out split's style codes
and labels, collected once, scored with the distance-marching losses on the
EMA model (no label dropout) and with the generative metric suite
(``evaluate_style``); the checkpoint monitor is val/energy_dist. Out of
scope: any ``parallel`` block other than one device (``parallel.sp`` raises
as in the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from ...data.pipeline import hold_out_mapsets, latent_windows, prefetch
from ...nn.schedule import lr_at
from ...train.loop import FitArgs, Stage, check_single_device, fit
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
) -> TrainState:
    """train the style prior as ``config`` (a YAML file, by default the
    package's config.yml, or the parsed dict) says, on ``device`` (a CUDA
    card unless ``cpu`` is asked for); ``on_step(step, metrics)`` runs after
    every step"""
    device = resolve_device(device, "train")
    cfg = config if isinstance(config, dict) else load_yaml_config(config or CONFIG)
    model_args = dataclass_from_dict(StyleModelArgs, cfg.get("model", {}))
    train_args = dataclass_from_dict(StyleTrainArgs, cfg.get("train", {}))
    data_args = dataclass_from_dict(StyleDataArgs, cfg.get("data", {}))
    fit_args = dataclass_from_dict(FitArgs, cfg.get("fit", {}))
    parallel = cfg.get("parallel") or {}
    if parallel.get("sp", 1) not in (1, None):
        raise ValueError("parallel.sp applies to the denoiser stage only (its backbone is "
                         "sequence-parallel-aware); this stage scales via dp/tp")
    check_single_device(parallel)

    train_sets, val_sets = hold_out_mapsets(
        Path(data_args.data_dir), "*.latent.npz", data_args.max_val_count,
        data_args.max_val_frac,
    )
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    state, train_step = init_style_training(model_args, train_args, fit_args.seed, device, dtype)

    def train_stream(epoch: int):
        # style codes are per map: stream full maps, keep (s, labels)
        stream = (
            (sample.s, sample.labels)
            for sample in latent_windows(train_sets, None,
                                         shuffle_buffer=data_args.shuffle_buffer,
                                         seed=fit_args.seed + epoch)
        )
        for styles, labels in prefetch(_batched_pairs(stream, data_args.batch_size)):
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
    return fit(stage, fit_args, resume_from)
