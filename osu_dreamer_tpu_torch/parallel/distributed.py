"""Processes, ranks and their rendezvous.

Counterpart of osu_dreamer_tpu/parallel/distributed.py. The JAX package runs
one process per host that drives all of the host's devices; the port runs one
process per device (a rank), as PyTorch does:
- ``init_multihost`` joins this process to the run's process group as rank
  ``process_id`` of ``num_processes`` (one device a host);
- ``launch`` starts one rank per local device with ``torch.multiprocessing``
  (start method ``spawn``, as CUDA needs), joins them into the process group
  and runs the same function in each. A failing rank fails ``launch`` with
  its traceback and stops the others; a rank that hangs in a collective
  fails at the process group's timeout;
- ``input_shard`` is this host's share of the input: each host streams a
  disjoint subset of the dataset.

Ranks on cards of their own talk over NCCL; ranks on the CPU, or sharing one
card, over gloo (NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import os
import socket
import time
from datetime import timedelta
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# how long a collective may wait for the other ranks before its rank fails
COLLECTIVE_TIMEOUT_S = 1800.0


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL where every rank has a card of its own, gloo otherwise"""
    cards = [d.index for d in devices if d.type == "cuda"]
    return "nccl" if len(cards) == len(devices) and len(set(cards)) == len(cards) else "gloo"


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: torch.device | str = "cpu",
    timeout_s: float | None = None,
) -> tuple[int, int]:
    """join the process group at ``tcp://<coordinator_address>`` as rank
    ``process_id`` of ``num_processes`` (no-op without a coordinator);
    -> (process_index, process_count)"""
    if coordinator_address is not None and not dist.is_initialized():
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend_for([device]), init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
            timeout=timedelta(seconds=timeout_s or COLLECTIVE_TIMEOUT_S),
        )
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def input_shard() -> tuple[int, int]:
    """(num_shards, shard_index) for this process's input pipeline: one
    shard a host. A rank that ``launch`` started reads its host from the
    torchrun variables it sets (GROUP_WORLD_SIZE, GROUP_RANK); a process
    that joined alone is a host of its own"""
    if "GROUP_WORLD_SIZE" in os.environ:
        return int(os.environ["GROUP_WORLD_SIZE"]), int(os.environ["GROUP_RANK"])
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _rank_main(local_rank: int, fn: Callable, args: tuple, devices: list[torch.device],
               world_size: int, host: int, hosts: int, init_method: str,
               timeout_s: float) -> None:
    rank = host * len(devices) + local_rank
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(local_rank),
                      LOCAL_WORLD_SIZE=str(len(devices)), GROUP_RANK=str(host),
                      GROUP_WORLD_SIZE=str(hosts))
    device = devices[local_rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:  # ranks on the CPU share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
    dist.init_process_group(backend_for(devices), init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    fn(*args)
    dist.destroy_process_group()


def launch(fn: Callable, args: tuple, devices: Sequence[torch.device], world_size: int,
           host: int = 0, hosts: int = 1, init_method: str | None = None,
           timeout_s: float | None = None, deadline_s: float | None = None) -> None:
    """run ``fn(*args)`` in one spawned rank per device of ``devices``: rank
    ``host * len(devices) + i`` on ``devices[i]``, in a process group of
    ``world_size`` ranks that meet at ``init_method`` (a free local port
    when None). Waits for every rank; a rank's exception is raised here, with
    its traceback, after the other ranks are stopped. ``deadline_s``: stop
    the ranks and raise TimeoutError when they have not all finished by
    then"""
    devices = [torch.device(d) for d in devices]
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    timeout_s = timeout_s or COLLECTIVE_TIMEOUT_S
    context = mp.start_processes(
        _rank_main, args=(fn, args, devices, world_size, host, hosts, init_method, timeout_s),
        nprocs=len(devices), join=False, start_method="spawn",
    )
    start = time.monotonic()
    while not context.join(timeout=5.0):
        if deadline_s is not None and time.monotonic() - start >= deadline_s:
            for proc in context.processes:
                if proc.is_alive():
                    proc.kill()
            for proc in context.processes:
                proc.join(timeout=10.0)
            raise TimeoutError(f"the ranks did not finish within {deadline_s:.0f} s")


def visible_devices(device: torch.device) -> list[torch.device]:
    """the devices a run of ``device``'s type may spread over: every visible
    card, or the one CPU"""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]

