"""fit-latent: config -> chart-signal streams -> train loop.

Counterpart of osu_dreamer_tpu/models/latent/fit.py. Validation parity: each
held-out full map at batch 1, bucket-padded (edge replication) to a multiple
of 2 * chunk * BUCKET_CHUNKS frames and scored under its valid-length mask:
threshold-free onset soft-Dice, cursor velocity R^2, their harmonic-mean
``eval/score`` (the checkpoint monitor, max mode), cursor pixel MAE, label MAE
(on ``decode``'s clipped labels) and the smallest per-dimension z variance.
The ``parallel:`` block's ``dp`` trains on that many ranks, one a device
(parallel/config.py; the MMD over the global batch), ``tp`` splits the
FilmStacks' hidden units over model groups (parallel/tp.py);
``parallel.sp`` raises as in the JAX package. After each validation
``on_validation`` logs the reconstruction figure of the first held-out map
(``reconstruction``: the chart, its reconstruction, their difference and
the up-sampled latent under the spectrogram, data/plot.py), skipped with a
log line where matplotlib cannot be imported.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from ...data.pipeline import (
    batched, count_signal_windows, hold_out_mapsets, pad_to_multiple, prefetch, signal_windows,
)
from ...nn.schedule import lr_at
from ...signal.encoding import Channel
from ...train.checkpoint import restore_train_state
from ...train.loop import FitArgs, Stage, fit, parallel_context
from ...train.state import TrainState
from ...utils import dataclass_from_dict, load_yaml_config
from ...utils.device import resolve_device
from .model import LatentModel, LatentModelArgs
from .train import Batch, LatentTrainArgs, init_latent_training

CONFIG = Path(__file__).parent / "config.yml"
BUCKET_CHUNKS = 32  # val bucket = 2 * chunk * this many chunks (~10 s)
_PLAYFIELD = (512.0, 384.0)


@dataclass
class LatentDataArgs:
    data_dir: str = "./data"
    seq_len: int = 2052
    batch_size: int = 32
    max_val_count: int = 64
    max_val_frac: float = 0.3
    max_per_map: int = 1
    shuffle_buffer: int = 1


@torch.no_grad()
def val_metrics(model: LatentModel, spec: torch.Tensor, chart: torch.Tensor,
                labels: torch.Tensor, length: int) -> dict[str, torch.Tensor]:
    """one padded full map (batch 1): the loss-free reconstruction sums and
    per-map metrics, as device scalars"""
    z, s = model.encode_chart(chart)
    pred_chart, pred_labels = model.decode(z, s, spec=spec)
    L = chart.shape[1]
    mask = (torch.arange(L, device=chart.device) < length).float()[None, :]

    t = chart[..., Channel.ONSET].float() * mask
    p = pred_chart[..., Channel.ONSET].float() * mask

    scale = torch.tensor(_PLAYFIELD, device=chart.device)
    true_xy = chart[..., 7:].float() * scale
    pred_xy = pred_chart[..., 7:].float() * scale
    vmask = (mask[:, 1:] * mask[:, :-1])[..., None]
    true_v = torch.diff(true_xy, dim=1) * vmask
    pred_v = torch.diff(pred_xy, dim=1) * vmask
    v_mean = true_v.sum(dim=1, keepdim=True) / vmask.sum().clamp_min(1.0)
    n = mask.sum().clamp_min(1.0)
    return {
        "on_tt": (t * t).sum(),
        "on_pt": (p * t).sum(),
        "on_pp": (p * p).sum(),
        "cur_res": ((pred_v - true_v) ** 2).sum(),
        "cur_tot": (((true_v - v_mean) * vmask) ** 2).sum(),
        "cursor_px_mae": ((pred_xy - true_xy).abs() * mask[..., None]).sum() / (n * 2),
        "label_mae": (pred_labels.float() - labels).abs().mean(),
        "z_var_min": z.float().var(dim=(0, 1), unbiased=False).min(),
    }


@torch.no_grad()
def reconstruction(model: LatentModel, sample, bucket: int, chunk_size: int, device
                   ) -> tuple[np.ndarray, list[np.ndarray]]:
    """the JAX ``on_validation``'s arrays for one full map (``sample``, a
    ``signal_windows`` item), bucket-padded as in validation: (the
    spectrogram (A, L), [the chart x, its reconstruction p, x - p, the
    latent z repeated ``chunk_size`` times a frame], each (C, L) f32)"""
    spec, chart = (torch.from_numpy(pad_to_multiple(a, bucket))[None].to(device)
                   for a in (sample.audio, sample.chart))
    z, s = model.encode_chart(chart)
    pred, _ = model.decode(z, s, spec=spec)
    L = sample.audio.shape[0]
    x = chart[0, :L].float().cpu().numpy().T
    p = pred[0, :L].float().cpu().numpy().T
    z_up = np.repeat(z[0].float().cpu().numpy(), chunk_size, axis=0)[:L].T
    return sample.audio.T, [x, p, x - p, z_up]


def run(
    config: str | Path | dict | None = None,
    resume_from: str | None = None,
    device: torch.device | str = "cuda",
    on_step: Optional[Callable[[int, dict], None]] = None,
    devices: Optional[Sequence[torch.device | str]] = None,
) -> TrainState:
    """train the chart autoencoder as ``config`` (a YAML file, by default the
    package's config.yml, or the parsed dict) says, on ``device`` (a CUDA card
    unless ``cpu`` is asked for); ``on_step(step, metrics)`` runs after every
    step (in every rank when the run is spread); ``devices`` and the return
    of a spread run as in models/diffusion/fit.py ``run``"""
    device = resolve_device(device, "train")
    cfg = config if isinstance(config, dict) else load_yaml_config(config or CONFIG)
    model_args = dataclass_from_dict(LatentModelArgs, cfg.get("model", {}))
    train_args = dataclass_from_dict(LatentTrainArgs, cfg.get("train", {}))
    data_args = dataclass_from_dict(LatentDataArgs, cfg.get("data", {}))
    fit_args = dataclass_from_dict(FitArgs, cfg.get("fit", {}))
    par, device = parallel_context(cfg, data_args.batch_size, device, devices)
    if par.sp_axis is not None:
        raise ValueError("parallel.sp applies to the denoiser stage only (its backbone is "
                         "sequence-parallel-aware); this stage scales via dp/tp")
    chunk2 = 2 * model_args.chunk_size
    if data_args.seq_len % chunk2:
        raise ValueError(f"seq_len {data_args.seq_len} must be a multiple of {chunk2}")
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    if par.needs_launch:
        par.launch(run, cfg, resume_from, device, on_step, devices)
        state, _ = init_latent_training(model_args, train_args, fit_args.seed, device, dtype)
        return restore_train_state(Path(fit_args.run_dir) / "last", state)

    train_sets, val_sets = hold_out_mapsets(
        Path(data_args.data_dir), "*.map.npy", data_args.max_val_count, data_args.max_val_frac,
    )
    state, train_step = init_latent_training(model_args, train_args, fit_args.seed, device,
                                             dtype, par)

    # multi-host: every host's epoch truncated to the same step count
    lockstep = par.lockstep_steps(count_signal_windows(
        train_sets, data_args.seq_len, data_args.max_per_map, shard=par.input_shard,
    )) if par.process_count > 1 else None

    def train_stream(epoch: int) -> Iterator[Batch]:
        stream = signal_windows(
            train_sets, data_args.seq_len, shuffle_buffer=data_args.shuffle_buffer,
            max_per_map=data_args.max_per_map, seed=fit_args.seed + epoch,
            shard=par.input_shard,
        )
        batches = par.lockstep_stream(prefetch(batched(stream, par.local_batch_size)),
                                      lockstep)
        for b in batches:
            yield Batch(*(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                          for x in par.shard_batch(b)))

    bucket = chunk2 * BUCKET_CHUNKS

    def validate(state: TrainState) -> dict[str, float]:
        sums = dict.fromkeys(("on_tt", "on_pt", "on_pp", "cur_res", "cur_tot"), 0.0)
        per_map: dict[str, list[float]] = {"cursor_px_mae": [], "label_mae": [], "z_var_min": []}
        for sample in signal_windows(val_sets, None, flip_augment=False):
            spec, chart = (torch.from_numpy(pad_to_multiple(a, bucket))[None].to(device)
                           for a in (sample.audio, sample.chart))
            labels = torch.from_numpy(sample.labels)[None].to(device)
            m = val_metrics(state.model, spec, chart, labels, sample.audio.shape[0])
            for k in sums:
                sums[k] += float(m[k])
            for k in per_map:
                per_map[k].append(float(m[k]))
        if not per_map["z_var_min"]:
            return {}
        dice = 2 * sums["on_pt"] / max(sums["on_pp"] + sums["on_tt"], 1e-8)
        r2 = 1.0 - sums["cur_res"] / max(sums["cur_tot"], 1e-8)
        cursor_q = sums["cur_tot"] / max(sums["cur_tot"] + sums["cur_res"], 1e-8)
        score = 2 * dice * cursor_q / max(dice + cursor_q, 1e-8)
        return {
            "eval/hit/dice": dice,
            "eval/cursor/vel/r2": r2,
            "eval/score": score,
            **{f"eval/{k}": float(np.mean(v)) for k, v in per_map.items()},
        }

    def on_validation(state: TrainState, step: int, logger) -> None:
        """the reconstruction figure of the first val map, where matplotlib
        imports (every validating rank runs the forward, which is collective
        under tensor parallelism; the writer draws and logs it)"""
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            if logger.write:
                print(f"[latent] step {step}: no reconstruction figure (matplotlib cannot be "
                      "imported)")
            return
        sample = next(signal_windows(val_sets, None, flip_augment=False), None)
        if sample is None:
            return
        audio, signals = reconstruction(state.model, sample, bucket, model_args.chunk_size,
                                        device)
        if not logger.write:
            return
        from ...data.plot import plot_signals

        with plot_signals(audio, signals) as fig:
            logger.figure("samples", fig, step)

    stage = Stage(
        name="latent",
        hparams={"model": cfg.get("model", {}), "train": cfg.get("train", {})},
        state=state,
        train_step=train_step,
        train_stream=train_stream,
        validate=validate,
        on_validation=on_validation,
        lr_schedule=lambda step: lr_at(step, train_args.opt.lr, train_args.opt.schedule),
        on_step=on_step,
    )
    return fit(stage, fit_args, resume_from, par)
