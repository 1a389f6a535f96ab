"""Model replicas for generation: one copy of the model a card, each batch's
song rows split over them.

Counterpart of the JAX ``data_parallel_mesh`` and ``replicate``
(osu_dreamer_tpu/parallel/) as ``predict`` and ``serve`` use them: where the
JAX package shards a batch's song axis over a 1-D ``data`` mesh under
``shard_map``, the port keeps one process with one replica a device and runs
each shard from its own host thread (models/inference/sampler.py
``build_sharded_sampler``). No collective is involved: the shards meet only
on the host, once a sampler, to calibrate the step size over the whole batch.

A device list may repeat a device (``cuda:0`` twice, ``cpu`` twice): each
entry still gets its own replica, so one card, or the CPU, runs the sharded
path the way several cards do.
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch


def replica_devices(n: int) -> list[torch.device]:
    """the first ``n`` visible cards"""
    visible = torch.cuda.device_count()
    if not 1 <= n <= visible:
        raise ValueError(f"{n} replica devices asked for, {visible} cards visible")
    return [torch.device("cuda", i) for i in range(n)]


def replicate(model: torch.nn.Module, devices: Sequence[torch.device | str]) -> list:
    """``model`` (its weights loaded once) as one replica a device: the first
    replica is ``model`` itself where it already lives on ``devices[0]``,
    every other a copy of it moved to its device. Inference only: the
    copies hold no gradients"""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("no replica devices")
    home = next(model.parameters()).device
    replicas = []
    for i, dev in enumerate(devices):
        if i == 0 and _same_device(home, dev):
            replicas.append(model)
            continue
        with torch.no_grad():
            replica = copy.deepcopy(model).to(dev)
        replica.requires_grad_(False)
        replicas.append(replica)
    return replicas


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    index = lambda d: torch.cuda.current_device() if d.index is None else d.index  # noqa: E731
    return index(a) == index(b)


def song_shards(n_songs: int, n_replicas: int) -> list[slice]:
    """the songs of a batch split over at most ``n_replicas`` shards in
    order, as evenly as they go (the first shards take one more): one shard
    a replica while songs last, never an empty one"""
    n = min(n_songs, n_replicas)
    base, extra = divmod(n_songs, n)
    bounds, start = [], 0
    for k in range(n):
        stop = start + base + (k < extra)
        bounds.append(slice(start, stop))
        start = stop
    return bounds
