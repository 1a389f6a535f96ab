"""Generic fit loop: epochs of steps, validation, checkpoints, early stop.

Counterpart of osu_dreamer_tpu/train/loop.py: per-step logging (train/
prefix), validation every ``val_every`` epochs (and on the final one),
followed by the stage's ``on_validation`` hook (the latent stage's figure),
best-by-metric checkpointing with a rolling ``last``, early stopping, exact
resume from the stored stream position. ``max_steps`` stops a run after that
many steps.

In a run spread over ranks (``par``) every rank runs the loop in lockstep:
rank 0 alone validates and runs the stage's ``on_validation`` (with the rest
of its model group under tensor parallelism, whose forward is collective;
rank 0's metrics are broadcast, so early stopping agrees) and writes the
logs, figures and checkpoints, the others
waiting at a barrier after each write; under tensor parallelism every rank
first gathers the whole state (train/state.py), which rank 0 writes in the
one-process layout; every rank resumes from the same checkpoint; at the end
the ranks' parameters must be equal bit for bit, a tensor-parallel rank's
slices across its data group. A failing rank raises at once (its final save
is left out, since the other ranks are not there to meet it).
"""

from __future__ import annotations

import itertools
import time
from contextlib import nullcontext
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterable, Optional, Sequence

import torch

from ..parallel.config import ParallelArgs, Parallelism, build_parallelism
from ..parallel.distributed import visible_devices
from ..parallel.tp import layout_of
from ..utils.config import dataclass_from_dict
from .checkpoint import BestCheckpointKeeper, read_progress, restore_train_state
from .logging import MetricsLogger
from .profiling import StepTimer, device_trace
from .state import TrainState


@dataclass
class FitArgs:
    run_dir: str = "runs/run"
    max_epochs: int = -1          # -1: until early stopping / max_steps / interrupt
    max_steps: int = -1
    log_every: int = 10
    monitor: str = "val/loss"
    monitor_mode: str = "min"
    early_stop_patience: int = 0  # 0: disabled
    early_stop_min_delta: float = 0.0
    val_every: int = 1
    # record a torch.profiler trace of this epoch into <run_dir>/trace; -1 off
    trace_epoch: int = -1
    save_last_every_s: float = 60.0
    seed: int = 0


@dataclass
class Stage:
    """everything the loop needs to train one model stage"""

    name: str
    hparams: dict[str, Any]
    state: TrainState
    train_step: Callable[[TrainState, Any], dict]   # updates the state in place
    train_stream: Callable[[int], Iterable]          # epoch -> batches
    validate: Optional[Callable[[TrainState], dict[str, float]]] = None
    # (state, step, logger) after validation, e.g. validation figures
    on_validation: Optional[Callable[[TrainState, int, MetricsLogger], None]] = None
    lr_schedule: Optional[Callable[[int], float]] = None
    # (step, metrics) after every train step, e.g. for a caller's timing
    on_step: Optional[Callable[[int, dict], None]] = None


def parallel_context(cfg: dict, batch_size: int, device: torch.device,
                     devices: Optional[Sequence[torch.device | str]] = None
                     ) -> tuple[Parallelism, torch.device]:
    """a fit's ``parallel:`` block resolved over ``devices`` (by default
    every visible device of ``device``'s type) -> (the context, the device
    this process trains on: its rank's inside a rank, else ``device``)"""
    par = build_parallelism(dataclass_from_dict(ParallelArgs, cfg.get("parallel") or {}),
                            batch_size, devices or visible_devices(device))
    return par, par.device if par.rank is not None else device


def fit(stage: Stage, args: FitArgs, resume_from: Optional[str] = None,
        par: Optional[Parallelism] = None) -> TrainState:
    run_dir = Path(args.run_dir)
    spread = par is not None and par.world_size > 1
    writer = par is None or par.is_writer
    say = print if writer else (lambda *a, **k: None)
    logger = MetricsLogger(run_dir / "tb", write=writer)
    keeper = BestCheckpointKeeper(run_dir, args.monitor, args.monitor_mode,
                                  args.save_last_every_s, write=writer)

    def save(metrics: dict[str, float]) -> bool:
        # a tensor-parallel state gathers on every rank, whether rank 0 writes
        whole = state.state_dict() if layout_of(state.model) is not None else state
        improved = keeper.update(whole, stage.hparams, metrics, progress)
        if spread:
            par.barrier()
        return improved

    state = stage.state
    start_epoch = skip_batches = 0
    if resume_from:
        restore_train_state(resume_from, state)
        prog = read_progress(resume_from)
        start_epoch = int(prog.get("epoch", 0))
        skip_batches = int(prog.get("batch_in_epoch", 0))
        say(f"resumed from {resume_from} at step {state.step}"
            + (f" (epoch {start_epoch}, {skip_batches} batches in)" if prog else ""))

    best = keeper.best_metric
    stale_epochs = 0
    epoch = start_epoch
    stop = False
    timer = StepTimer()
    progress = {"epoch": epoch, "batch_in_epoch": skip_batches}
    failed = True
    try:
        while not stop and (args.max_epochs < 0 or epoch < args.max_epochs):
            epoch_t0 = time.time()
            n_batches = skip_batches
            progress = {"epoch": epoch, "batch_in_epoch": n_batches}
            trace = device_trace(run_dir / "trace") if epoch == args.trace_epoch else nullcontext()
            with trace:
                stream = stage.train_stream(epoch)
                if skip_batches:
                    stream = itertools.islice(stream, skip_batches, None)
                    skip_batches = 0
                stream_it = iter(stream)
                epoch_complete = True
                for batch in stream_it:
                    metrics = stage.train_step(state, batch)
                    n_batches += 1
                    progress["batch_in_epoch"] = n_batches
                    timer.tick()
                    step = state.step
                    if stage.on_step is not None:
                        stage.on_step(step, metrics)
                    if step % args.log_every == 0:
                        scalars = dict(metrics)
                        if stage.lr_schedule is not None:
                            # the update that produced `step` read the schedule
                            # at the count before it
                            scalars["lr"] = stage.lr_schedule(step - 1)
                        logger.scalars(scalars, step, prefix="train/")
                        if timer.steps_per_sec > 0:
                            logger.scalars({"steps_per_sec": timer.steps_per_sec}, step,
                                           prefix="perf/")
                    if args.max_steps > 0 and step >= args.max_steps:
                        stop = True
                        # a stop on the epoch's last batch completed the epoch:
                        # peek one batch to tell (the peeked batch is dropped;
                        # a resume regenerates the deterministic stream)
                        sentinel = object()
                        epoch_complete = next(stream_it, sentinel) is sentinel
                        break
            if n_batches == 0:
                raise RuntimeError(
                    "training stream yielded no batches: most often the dataset has fewer "
                    "windows than data.batch_size (partial batches are dropped); lower "
                    "batch_size or raise max_per_map"
                )

            is_final = (args.max_epochs >= 0 and epoch == args.max_epochs - 1) or stop
            run_val = (epoch + 1) % max(1, args.val_every) == 0 or is_final
            val_metrics: dict[str, float] = {}
            if run_val and stage.validate is not None:
                val_metrics = stage.validate(state) if par is None or par.validates else {}
                if spread:
                    val_metrics = par.broadcast(val_metrics)
                logger.scalars(val_metrics, state.step)
            if run_val and stage.on_validation is not None and (par is None or par.validates):
                stage.on_validation(state, state.step, logger)
            # after a completed epoch e a restart begins cleanly at epoch e+1;
            # a max_steps stop mid-epoch keeps the mid-epoch position
            if epoch_complete:
                progress = {"epoch": epoch + 1, "batch_in_epoch": 0}
            improved = save(val_metrics)
            logger.flush()
            monitored = val_metrics.get(args.monitor)
            say(f"[{stage.name}] epoch {epoch}: {n_batches} steps in "
                f"{time.time() - epoch_t0:.1f}s"
                + (f" | {args.monitor}={monitored:.5f}" if monitored is not None else "")
                + (" *best*" if improved else ""))

            if args.early_stop_patience > 0 and monitored is not None:
                better = (best is None
                          or (args.monitor_mode == "min"
                              and monitored < best - args.early_stop_min_delta)
                          or (args.monitor_mode == "max"
                              and monitored > best + args.early_stop_min_delta))
                if better:
                    best, stale_epochs = monitored, 0
                else:
                    stale_epochs += 1
                    if stale_epochs >= args.early_stop_patience:
                        say(f"[{stage.name}] early stop: {args.monitor} stale for "
                            f"{stale_epochs} epochs")
                        stop = True
            epoch += 1
        failed = False
    except KeyboardInterrupt:
        failed = False
        say(f"[{stage.name}] interrupted at step {state.step}; last checkpoint kept")
    finally:
        # always leave a current `last` with the exact stream position
        if not (failed and spread):
            keeper.min_save_interval_s = 0.0
            save({})
        logger.close()
    if spread:
        models = [state.model] + ([state.ema_model] if state.ema_model is not None else [])
        layout = layout_of(state.model)
        split = set(layout.splits) if layout is not None else set()
        tensors = [p for m in models for n, p in m.named_parameters() if n not in split]
        slices = [p for m in models for n, p in m.named_parameters() if n in split]
        digest = par.check_replicas(tensors, slices)
        say(f"[{stage.name}] {par.world_size} ranks hold the same parameters "
            f"(sha256 {digest[:16]})")
    return state
