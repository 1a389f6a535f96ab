"""The collectives of the port's parallel runs, built on ``all_reduce`` and
point-to-point sends only.

- ``all_reduce_sum`` and ``all_gather_rows`` have a backward, so a loss made
  the same on every rank through them is differentiated as JAX differentiates
  a ``psum``/``pmean`` under ``shard_map``: each rank's gradient is the group
  size times its own share, which the gradient average over all ranks
  (``Parallelism.average_gradients``) turns into the true sum of the shares;
- ``enter_model`` and ``leave_model`` are Megatron's two conjugate
  operators of a tensor-parallel region: entering it is the identity
  forward and an all-reduce of the gradient backward; leaving it an
  all-reduce forward and the identity backward (every rank of the model
  group holds the same loss, so the gradient reaching the sum is already
  whole). ``tp_all_reduce_`` is the in-place sum the FFN kernels' TP forms
  run between their phases;
- ``exchange`` posts one batch of sends and receives between ranks. Gloo
  takes point-to-point buffers in host memory only (a CUDA tensor fails in
  its socket write), so on a gloo group a CUDA tensor is staged through
  pinned host buffers; NCCL sends CUDA tensors as they are;
- ``comm_timer`` times the collectives by kind with CUDA events when it is
  enabled (a run's ``{kind: ms}``), and costs nothing when it is not.

Only ``all_reduce`` is asked of a backend among the collectives: the
gather is a zero-padded sum, exact, and works where a backend has no
all-gather or reduce-scatter for a tensor's device.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional, Sequence

import torch
import torch.distributed as dist


class CommTimer:
    """CUDA-event spans of the collectives, by kind ("grad_all_reduce",
    "ring", "halo", ...); off unless ``enabled``, and CPU tensors are never
    timed"""

    def __init__(self) -> None:
        self.enabled = False
        self._spans: dict[str, list[tuple[torch.cuda.Event, torch.cuda.Event]]] = {}

    def reset(self) -> None:
        self._spans = {}

    @contextmanager
    def span(self, kind: str, device: torch.device) -> Iterator[None]:
        if not self.enabled or device.type != "cuda":
            yield
            return
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        yield
        end.record()
        self._spans.setdefault(kind, []).append((start, end))

    def ms(self) -> dict[str, tuple[float, int]]:
        """{kind: (total ms, spans)} since the last ``reset``"""
        if self._spans:
            torch.cuda.synchronize()
        return {kind: (sum(a.elapsed_time(b) for a, b in spans), len(spans))
                for kind, spans in self._spans.items()}


comm_timer = CommTimer()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        with comm_timer.span("all_reduce", x.device):
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        out = grad.contiguous().clone()
        with comm_timer.span("all_reduce", grad.device):
            dist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """the sum of ``x`` over ``group`` on every rank, with a backward (the
    sum of the ranks' gradients); ``group`` None: ``x`` itself"""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        n, i = dist.get_world_size(group), dist.get_rank(group)
        ctx.group, ctx.rows = group, (i * x.shape[0], (i + 1) * x.shape[0])
        out = x.new_zeros((n * x.shape[0], *x.shape[1:]))
        out[ctx.rows[0]:ctx.rows[1]] = x
        with comm_timer.span("all_reduce", x.device):
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        out = grad.contiguous().clone()
        with comm_timer.span("all_reduce", grad.device):
            dist.all_reduce(out, group=ctx.group)
        return out[ctx.rows[0]:ctx.rows[1]], None


def tp_all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the model group ``group``, in place (timed as
    "tp"); ``group`` None: ``x`` as it is"""
    if group is not None:
        with comm_timer.span("tp", x.device):
            dist.all_reduce(x, group=group)
    return x


class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return tp_all_reduce_(grad.contiguous().clone(), ctx.group), None


class _LeaveModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        return tp_all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def enter_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` entering a tensor-parallel region of ``group``: the identity,
    whose backward sums the ranks' gradients; ``group`` None: ``x``"""
    return x if group is None else _EnterModel.apply(x, group)


def leave_model(x: torch.Tensor, group) -> torch.Tensor:
    """the ranks' partial ``x`` summed over ``group`` on leaving a
    tensor-parallel region, whose backward is the identity; ``group``
    None: ``x``"""
    return x if group is None else _LeaveModel.apply(x, group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """the ranks' ``x`` stacked on the first axis in group-rank order, on
    every rank, with a backward (this rank's rows of the summed gradient);
    ``group`` None: ``x`` itself"""
    if group is None:
        return x
    return _AllGatherRows.apply(x, group)


def exchange(sends: Sequence[tuple[torch.Tensor, int]],
             recvs: Sequence[tuple[torch.Size, int]],
             group, dtype: torch.dtype, device: torch.device,
             kind: str) -> list[torch.Tensor]:
    """one batch of point-to-point transfers within ``group``: each of
    ``sends`` is (tensor, group rank of the receiver), each of ``recvs`` is
    (shape, group rank of the sender) -> the received tensors on ``device``,
    in ``recvs``' order. Between two ranks at most one message goes each
    way"""
    stage = device.type == "cuda" and dist.get_backend(group) == "gloo"
    ops, bufs = [], []
    with comm_timer.span(kind, device):
        for tensor, peer in sends:
            t = tensor.detach().to(dtype).contiguous()
            if stage:  # gloo's sockets read host memory: a pinned copy
                t = torch.empty(t.shape, dtype=dtype, pin_memory=True).copy_(t)
            ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(group, peer), group))
        for shape, peer in recvs:
            buf = (torch.empty(shape, dtype=dtype, pin_memory=True) if stage
                   else torch.empty(shape, dtype=dtype, device=device))
            ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, peer), group))
            bufs.append(buf)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        out = [b.to(device, non_blocking=True) for b in bufs] if stage else bufs
    return out


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` passed one step round the ring of ``group``: to the next rank,
    and the previous rank's ``x`` received (group size > 1)"""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    return exchange([(x, (i + 1) % n)], [(x.shape, (i - 1) % n)], group, x.dtype, x.device,
                    "ring")[0]


def optional_group(ranks: list[int], timeout=None) -> Optional[object]:
    """``dist.new_group(ranks)``, which every rank must call in the same
    order; None for a group of one rank, whose collectives are the identity"""
    group = dist.new_group(ranks, timeout=timeout)
    return group if len(ranks) > 1 else None
