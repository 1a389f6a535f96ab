"""Config-driven parallelism: the ``parallel:`` block of the stage configs.

Counterpart of osu_dreamer_tpu/parallel/config.py, with the same keys and
meaning:

    parallel:
      dp: -1            # data-parallel devices: -1 = auto (all that divide
                        # the batch), 1 = single device, N = exactly N
      tp: 1             # tensor-parallel span: Megatron-style slices of the
                        # attention heads and SwiGLU hidden units over a
                        # (data, model) grid of ranks (parallel/tp.py)
      sp: 1             # sequence-parallel span (denoiser stage only)
      coordinator: null # multi-host: host:port every host meets at
      num_processes: null
      process_id: null

Each fit calls ``build_parallelism`` first, with the devices it may use (by
default every visible card). The port runs one rank per device: where the
resolved world holds more than one rank, the fit ``launch``es its ranks and
each runs the fit again, finding the process group joined. Data ranks take
their own rows of every global batch, and the ranks of a sequence-parallel
group their own span of the window; each of them holds the whole model,
computes the same global loss, and the gradients are averaged over all
ranks, so the replicas stay equal bit for bit. Under tensor parallelism a
model group of ``tp`` consecutive ranks takes the same rows and draws and
each rank holds its slice of the attention heads and SwiGLU hidden units
(parallel/tp.py); the gradients are averaged over the data group (the q/k
norm gains summed over the model group first) and clipped by their global
norm. There is no GSPMD and no kernel gate: a rank runs its own tensors, so
every op with a kernel takes it, and the FFNs their kernels' TP forms.

Multi-host: each host runs the fit with its ``process_id``; it streams its
own input shard (``input_shard``), loads ``local_batch_size`` rows a step
and hands each of its ranks its share; global rank = process_id x local ranks
+ local rank, and the ranks meet at ``tcp://<coordinator>``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from datetime import timedelta
from itertools import islice
from typing import Any, Callable, Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from . import distributed
from .collectives import comm_timer, optional_group
from .mesh import auto_data_parallel, rank_grid
from .tp import TPLayout, tp_grid


@dataclass
class ParallelArgs:
    dp: int = -1
    tp: int = 1
    # sequence-parallel span (denoiser stage only): the window length is
    # sharded over `sp` ranks — ring attention, halo'd convs, all-reduced
    # length means
    sp: int = 1
    coordinator: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


@dataclass
class Parallelism:
    """the resolved parallel context of one fit run. In the process that
    resolves it ``rank`` is None: with more than one rank it ``launch``es
    them; inside a rank (``join``) it holds the rank and its groups"""

    input_shard: Optional[tuple[int, int]]
    process_index: int
    process_count: int
    # rows THIS host loads per step (global batch / process_count)
    local_batch_size: int = 0
    # "sp" when the window length is sharded over sp ranks, else None
    sp_axis: Optional[str] = None
    world_size: int = 1
    sp: int = 1
    tp: int = 1
    # this host's rank devices, one a local rank
    devices: list[torch.device] = field(default_factory=lambda: [torch.device("cpu")])
    coordinator: Optional[str] = None
    timeout_s: float = distributed.COLLECTIVE_TIMEOUT_S
    rank: Optional[int] = None
    world_group: Any = None
    data_group: Any = None   # the ranks holding the same span or slice (None: one rank)
    sp_group: Any = None     # the ranks of this rank's window (None: sp 1)
    model_group: Any = None  # the ranks of this rank's model (None: tp 1)

    # ---- layout ----

    @property
    def inner(self) -> int:
        """the ranks that take the same rows: a sequence-parallel or a
        model group"""
        return self.sp * self.tp

    @property
    def n_data(self) -> int:
        return self.world_size // self.inner

    @property
    def data_rank(self) -> int:
        return (self.rank or 0) // self.inner

    @property
    def sp_rank(self) -> int:
        return (self.rank or 0) % self.sp

    @property
    def model_rank(self) -> int:
        return (self.rank or 0) % self.tp

    @property
    def n_local(self) -> int:
        return self.world_size // self.process_count

    @property
    def device(self) -> torch.device:
        """this rank's device"""
        return self.devices[(self.rank or 0) % self.n_local]

    @property
    def is_writer(self) -> bool:
        """rank 0 (or the single process) writes logs and checkpoints"""
        return not self.rank

    @property
    def validates(self) -> bool:
        """rank 0 validates, with the rest of its model group under tensor
        parallelism (the forward is collective there)"""
        return self.data_rank == 0 and (self.tp > 1 or not self.rank)

    @property
    def needs_launch(self) -> bool:
        return self.world_size > 1 and self.rank is None

    def launch(self, fn: Callable, *args) -> None:
        """run ``fn(*args)`` in this host's ranks, one a local device"""
        init = f"tcp://{self.coordinator}" if self.coordinator else None
        distributed.launch(fn, args, self.devices[: self.n_local], self.world_size,
                           host=self.process_index, hosts=self.process_count,
                           init_method=init, timeout_s=self.timeout_s)

    def join(self) -> "Parallelism":
        """inside a rank of the joined process group: take the rank and make
        the groups (every rank makes every group, in one order)"""
        if dist.get_world_size() != self.world_size:
            raise RuntimeError(f"the process group has {dist.get_world_size()} ranks, the "
                               f"parallel config resolves to {self.world_size}")
        self.rank = dist.get_rank()
        timeout = timedelta(seconds=self.timeout_s)
        self.world_group = dist.group.WORLD
        data_groups, inner_groups = rank_grid(self.n_data, self.inner)
        for ranks in data_groups:
            group = optional_group(ranks, timeout)
            if self.rank in ranks:
                self.data_group = group
        for ranks in inner_groups:
            group = optional_group(ranks, timeout)
            if self.rank in ranks:
                if self.sp > 1:
                    self.sp_group = group
                if self.tp > 1:
                    self.model_group = group
        return self

    # ---- batches ----

    def shard_batch(self, batch: Any, seq_fields: Sequence[int] = ()) -> Any:
        """this rank's rows of the host's batch (a tuple of arrays or tensors,
        batch-major), and of the fields ``seq_fields`` its span of the length
        axis (axis 1)"""
        if self.rank is None:
            return batch
        rows = self.local_batch_size * self.process_count // self.n_data
        lo = ((self.rank % self.n_local) // self.inner) * rows
        out = []
        for i, x in enumerate(batch):
            x = x[lo:lo + rows]
            if i in seq_fields and self.sp > 1:
                span = x.shape[1] // self.sp
                x = x[:, self.sp_rank * span:(self.sp_rank + 1) * span]
            out.append(x)
        return type(batch)(*out) if hasattr(batch, "_fields") else type(batch)(out)

    def take_rows(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        """this rank's ``rows`` rows of a draw made at the global batch"""
        return x[self.data_rank * rows:(self.data_rank + 1) * rows]

    def take_span(self, x: torch.Tensor, length: int) -> torch.Tensor:
        """this rank's ``length`` frames (axis 1) of a draw made at the
        global window length"""
        return x[:, self.sp_rank * length:(self.sp_rank + 1) * length]

    def lockstep_steps(self, local_windows: int) -> Optional[int]:
        """multi-host: the per-epoch train-step count EVERY host must run —
        the minimum across hosts of (local windows // local batch). Hosts
        with ragged input shards would otherwise drift out of lockstep on
        the collectives and hang. None when single-process."""
        if self.process_count <= 1:
            return None
        local = torch.tensor([local_windows // max(self.local_batch_size, 1)],
                             dtype=torch.int64, device=self.device)
        if self.rank is not None:
            dist.all_reduce(local, op=dist.ReduceOp.MIN)
        return int(local.item())

    def lockstep_stream(self, batches: Iterable, lockstep: Optional[int]) -> Iterable:
        """apply the ``lockstep_steps`` truncation to an epoch's batches"""
        return batches if lockstep is None else islice(batches, lockstep)

    # ---- collectives of the train step ----

    def average_gradients(self, grads: Sequence[torch.Tensor],
                          layout: Optional[TPLayout] = None) -> list[torch.Tensor]:
        """the gradients averaged over every rank (one all-reduce of the flat
        gradient): the same bits on every rank. Under tensor parallelism
        over the data group only (a model group's ranks hold the same
        replicated gradients and their own slices' gradients), the partial
        gradients of ``layout`` summed over the model group first"""
        if self.world_group is None:
            return list(grads)
        grads = list(grads)
        group, n = self.world_group, self.world_size
        if self.tp > 1:
            group, n = self.data_group, self.n_data
            kinds = layout.kinds() if layout is not None else ["replicated"] * len(grads)
            part = [i for i, k in enumerate(kinds) if k == "partial"]
            if part and self.model_group is not None:
                flat = torch.cat([grads[i].reshape(-1) for i in part])
                with comm_timer.span("tp", flat.device):
                    dist.all_reduce(flat, group=self.model_group)
                for i, f in zip(part, flat.split([grads[i].numel() for i in part])):
                    grads[i] = f.view_as(grads[i])
            if group is None:
                return grads
        flat = torch.cat([g.reshape(-1) for g in grads])
        with comm_timer.span("grad_all_reduce", flat.device):
            dist.all_reduce(flat, group=group)
        flat = flat / n
        return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]

    def grad_norm(self, grads: Sequence[torch.Tensor],
                  layout: Optional[TPLayout]) -> Optional[torch.Tensor]:
        """the global norm of the whole model's gradient under tensor
        parallelism (the squares of the slices' gradients summed over the
        model group, every other leaf's counted once: the replicated ones
        and the partial ones, which ``average_gradients`` has already summed
        over the group); None where a rank holds the whole gradient (the
        optimizer's own norm)"""
        if layout is None or self.model_group is None:
            return None
        kinds = layout.kinds()
        sq = [torch.stack([g.float().square().sum() for g, k in zip(grads, kinds)
                           if (k == "sharded") == sharded]
                          or [grads[0].new_zeros((), dtype=torch.float32)]).sum()
              for sharded in (True, False)]
        with comm_timer.span("tp", sq[0].device):
            dist.all_reduce(sq[0], group=self.model_group)
        return torch.sqrt(sq[0] + sq[1])

    def mean_over_data(self, metrics: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """per-rank batch means -> their mean over the data ranks (the JAX
        ``pmean`` over ``data``), detached"""
        if self.data_group is None:
            return {k: v.detach() for k, v in metrics.items()}
        stacked = torch.stack([v.detach().float() for v in metrics.values()])
        dist.all_reduce(stacked, group=self.data_group)
        return dict(zip(metrics, stacked / self.n_data))

    def barrier(self) -> None:
        if self.world_group is not None:
            dist.barrier(group=self.world_group)

    def broadcast(self, obj: Any) -> Any:
        """rank 0's ``obj`` on every rank"""
        if self.world_group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.world_group)
        return box[0]

    def check_replicas(self, tensors: Iterable[torch.Tensor],
                       slices: Iterable[torch.Tensor] = ()) -> str:
        """the SHA-256 of ``tensors``' bytes, which must be the same on every
        rank, and of ``slices``' (a tensor-parallel rank's own), which must
        be the same on every rank of its data group (raises otherwise) ->
        the digest of ``tensors``"""
        digest = _digest(tensors)
        checks = [(digest, self.world_group, self.world_size, "replicas")]
        if self.tp > 1:
            checks.append((_digest(slices), self.data_group, self.n_data, "slices"))
        for mine, group, n, what in checks:
            if group is None:
                continue
            digests = [None] * n
            dist.all_gather_object(digests, mine, group=group)
            if len(set(digests)) != 1:
                raise RuntimeError(f"the ranks' {what} differ: {digests}")
        return digest


def _digest(tensors: Iterable[torch.Tensor]) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def build_parallelism(args: ParallelArgs, batch_size: int,
                      devices: Optional[Sequence[torch.device | str]] = None,
                      timeout_s: Optional[float] = None) -> Parallelism:
    """resolve the parallel config over ``devices`` (this host's: by default
    its visible cards, or the CPU where there is none) into the ranks of the
    run. Inside a rank (the process group
    joined) it also takes the rank and makes the groups; a coordinator with
    one device a host joins this process to the group here.

    The checks are the JAX package's, in its order and with its messages,
    and one of the port's: a model group stays within one host."""
    if devices is None:
        devices = distributed.visible_devices(
            torch.device("cuda" if torch.cuda.is_available() else "cpu"))
    devices = [torch.device(d) for d in devices]
    joined = dist.is_available() and dist.is_initialized()
    if args.coordinator:
        if args.num_processes is None or args.process_id is None:
            raise ValueError("parallel.coordinator needs parallel.num_processes and "
                             "parallel.process_id")
        n_proc, proc_id = args.num_processes, args.process_id
    else:
        n_proc, proc_id = 1, 0
    n_global = n_proc * len(devices)
    say = print if not joined else (lambda *a, **k: None)

    if n_proc > 1 and batch_size % n_proc != 0:
        raise ValueError(
            f"global batch size {batch_size} must divide evenly over "
            f"{n_proc} processes"
        )

    if args.tp > 1 and args.sp > 1:
        raise ValueError("parallel.tp and parallel.sp cannot be combined (yet)")

    if n_proc > 1 and args.tp <= 1 and args.sp <= 1:
        # multi-host DP: the ranks MUST span every host's devices — dp=1
        # would train N divergent models with no gradient sync
        if args.dp == 1:
            raise ValueError(
                "parallel.dp=1 with a multi-process coordinator would train "
                "divergent models (each host would optimize alone, no "
                "gradient sync); set dp to the global device count or 'auto'"
            )
        if args.dp > 1 and args.dp != n_global:
            raise ValueError(
                f"multi-host dp must span every device: parallel.dp={args.dp}"
                f" but {n_global} global devices across {n_proc} processes"
            )
        if batch_size % n_global != 0:
            raise ValueError(
                f"multi-host: global batch {batch_size} must divide over all "
                f"{n_global} devices (trimming the mesh would drop some "
                "hosts' devices)"
            )
    if args.sp > 1 and args.coordinator:
        raise ValueError(
            "parallel.sp is single-process for now: the sp train step's "
            "shard_map expects the full global batch on every host, which "
            "the multi-host input path does not provide (yet)"
        )

    sp, tp, sp_axis = 1, 1, None
    if args.sp > 1:
        if n_global % args.sp != 0:
            raise ValueError(
                f"{n_global} devices not divisible by parallel.sp={args.sp}"
            )
        n_data = n_global // args.sp
        if batch_size % max(n_data, 1) != 0:
            raise ValueError(
                f"batch size {batch_size} not divisible by the {n_data}-way "
                f"data axis of the (data={n_data}, sp={args.sp}) mesh"
            )
        world, sp, sp_axis = n_global, args.sp, "sp"
        say(f"[parallel] sequence-parallel: (data={n_data}, sp={args.sp}) mesh, "
            "window length sharded over sp")
    elif args.tp > 1:
        n_data = tp_grid(n_global, args.tp)
        if batch_size % n_data != 0:
            raise ValueError(
                f"batch size {batch_size} not divisible by the {n_data}-way "
                f"data axis of the (data={n_data}, model={args.tp}) mesh; "
                "adjust data.batch_size or parallel.tp"
            )
        if len(devices) % args.tp != 0:
            raise ValueError(
                f"parallel.tp={args.tp} must divide each host's {len(devices)} devices: "
                "a model group stays within one host"
            )
        world, tp = n_global, args.tp
        say(f"[parallel] tensor-parallel: (data={n_data}, model={args.tp}) "
            "mesh, Megatron-style param sharding")
    elif args.dp == 1:
        world = 1  # explicit single-device
    elif args.dp > 1:
        if args.dp > n_global:
            raise ValueError(f"parallel.dp={args.dp} but only {n_global} devices")
        if batch_size % args.dp != 0:
            raise ValueError(
                f"batch size {batch_size} not divisible by parallel.dp={args.dp}"
            )
        world = args.dp
        say(f"[parallel] data-parallel over {args.dp} devices (configured)")
    elif n_proc > 1:
        world = n_global  # all devices, validated divisible above
    else:
        # inside a rank the launcher's resolution is the process group's size
        world = dist.get_world_size() if joined else auto_data_parallel(batch_size,
                                                                         len(devices))

    shard = (n_proc, proc_id) if n_proc > 1 else None
    if shard is not None:
        say(f"[parallel] multi-host: process {proc_id}/{n_proc}, "
            "input stream sharded per host")
    par = Parallelism(
        input_shard=shard,
        process_index=proc_id,
        process_count=n_proc,
        local_batch_size=batch_size // n_proc,
        sp_axis=sp_axis,
        world_size=world,
        sp=sp,
        tp=tp,
        devices=devices,
        coordinator=args.coordinator,
        timeout_s=timeout_s or distributed.COLLECTIVE_TIMEOUT_S,
    )
    if world > 1 and n_proc > 1 and par.n_local == 1 and not joined:
        # one device a host: this process is the host's one rank
        distributed.init_multihost(args.coordinator, n_proc, proc_id, devices[0],
                                   par.timeout_s)
        joined = True
    if world > 1 and joined:
        par.join()
    return par
