"""Tensor parallelism: Megatron-style slices of the attention and SwiGLU
modules over a model group of ranks.

Counterpart of osu_dreamer_tpu/parallel/tp.py. The JAX package places
parameters on a ``(data, model)`` mesh by path rules and lets GSPMD insert the
collectives; the port runs one rank a device, so a rank HOLDS its slice of
each ruled module as parameters of its own and the modules run the slice
(nn/blocks.py ``SwiGLU``, nn/attention.py ``RoPEAttention``), with the
collectives of parallel/collectives.py (``enter_model``, ``leave_model``,
``tp_all_reduce_``) around the attention and inside the FFN kernels' TP forms
(ops/swiglu.py ``swiglu_tp``, ops/film_layer.py ``film_layer_tp``).

A module is split where ``DEFAULT_TP_RULES`` (the JAX rules, over the port's
parameter paths, which keep the flax names) match its parameters, by whole
units: a SwiGLU's hidden units (the same columns of both halves of the packed
``[v|g]``, their biases, the rows of ``out_kernel``) and an attention's heads
(the heads' q, k and v columns of the packed ``[q|k|v]``, the qkv bias, the
rows of ``out``). The units split as evenly as possible (683/682 of 1365); the
JAX package replicates a leaf that does not divide instead. A module with
fewer units than ranks stays replicated, as the JAX fallback does. Every
other leaf is replicated.

A rank inits the whole model from the fit's seed and keeps its slice, so a
tensor-parallel run starts from the one-process weights. Checkpoints hold
the gathered whole tensors (``TPLayout.gather_state``) in the one-process
layout; a resume slices them again (``TPLayout.scatter_state``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from .collectives import comm_timer

# path pattern -> (split axis, packed blocks along it); first match wins, no
# match: replicated. The JAX package's rules (P(None, "model") splits axis 1,
# P("model") and P("model", None) axis 0), the packing read from the modules
DEFAULT_TP_RULES: tuple[tuple[str, tuple[int, int]], ...] = (
    # attention: split the heads on the way in, reduce over them on the way out
    (r"attn/qkv/kernel$", (1, 3)),
    (r"attn/qkv/bias$", (0, 3)),
    (r"attn/out/kernel$", (0, 1)),
    # SwiGLU FFN: split the hidden units; the out projection reduces over them
    (r"ffn\d*/vg_kernel$", (1, 2)),
    (r"ffn\d*/vg_bias$", (0, 2)),
    (r"ffn\d*/out_kernel$", (0, 1)),
)

# replicated leaves of a split module whose gradient is a partial sum over
# the rank's units: the q/k norm gains, summed over the rank's heads by the
# attention backward
PARTIAL_GRAD_RULES: tuple[str, ...] = (r"attn/[qk]_gamma$",)


def tp_grid(n_devices: int, n_model: int) -> int:
    """the JAX ``tp_mesh`` check: the devices form a (data, model) grid with
    ``n_model`` consecutive devices a model group -> the data extent"""
    if n_devices % n_model != 0:
        raise ValueError(f"{n_devices} devices not divisible by n_model={n_model}")
    return n_devices // n_model


def even_split(units: int, size: int, rank: int) -> tuple[int, int]:
    """rank ``rank``'s units [lo, hi) of ``units`` over ``size`` ranks, as
    even as possible (the first ``units % size`` ranks one more)"""
    base, extra = divmod(units, size)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (rank < extra)


@dataclass(frozen=True)
class TPSlice:
    """a module's share of the model group: units [lo, hi) of ``units``"""

    group: Any
    rank: int
    size: int
    units: int
    lo: int
    hi: int

    def __deepcopy__(self, memo):  # an EMA copy shares the group
        return self


@dataclass(frozen=True)
class Split:
    """where a parameter's slice sits in its whole tensor: ``blocks`` packed
    blocks along ``axis`` (v|g, q|k|v), each of ``units`` units of ``unit``
    entries, of which the rank holds [lo, hi) in every block"""

    axis: int
    blocks: int
    unit: int
    units: int
    lo: int
    hi: int

    def _view(self, t: torch.Tensor, units: int) -> torch.Tensor:
        s = t.shape
        return t.reshape(*s[:self.axis], self.blocks, units, self.unit, *s[self.axis + 1:])

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """the slice of a whole tensor"""
        part = self._view(full, self.units).narrow(self.axis + 1, self.lo, self.hi - self.lo)
        s = full.shape
        return part.reshape(*s[:self.axis], -1, *s[self.axis + 1:]).contiguous()

    def put(self, full: torch.Tensor, part: torch.Tensor) -> None:
        """write the slice into a whole tensor"""
        self._view(full, self.units).narrow(self.axis + 1, self.lo, self.hi - self.lo).copy_(
            self._view(part, self.hi - self.lo))

    def full_shape(self, part: torch.Size) -> list[int]:
        shape = list(part)
        shape[self.axis] = self.blocks * self.units * self.unit
        return shape


class TPLayout:
    """a model's slices: which parameters (by name, in ``named_parameters``
    order) are split and how, which replicated ones carry partial
    gradients, and the model group"""

    def __init__(self, names: Sequence[str], splits: dict[str, Split], partial: set[str],
                 group: Any):
        self.names = list(names)
        self.splits, self.partial, self.group = splits, partial, group

    def __deepcopy__(self, memo):  # an EMA copy has the same layout
        return self

    def kinds(self) -> list[str]:
        """per parameter: "sharded", "partial" or "replicated\""""
        return ["sharded" if n in self.splits else "partial" if n in self.partial
                else "replicated" for n in self.names]

    # ---- whole tensors <-> slices ----

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """the whole tensor of parameter ``name`` from the model group's
        slices (a collective: every rank of the group calls it): each rank
        places its slice in zeros and the group sums them, which is exact"""
        split = self.splits.get(name)
        if split is None:
            return t
        full = t.new_zeros(split.full_shape(t.shape))
        split.put(full, t.detach())
        if self.group is not None:
            with comm_timer.span("tp", full.device):
                dist.all_reduce(full, group=self.group)
        return full

    def scatter(self, name: str, full: torch.Tensor) -> torch.Tensor:
        split = self.splits.get(name)
        return full if split is None else split.take(full)

    def _map_state(self, state: dict, fn) -> dict:
        out = dict(state)
        for part in ("params", "ema_params"):
            if out.get(part) is not None:
                out[part] = {k: fn(k, v) for k, v in out[part].items()}
        opt = dict(out["opt"])
        for moment in ("mu", "nu"):
            opt[moment] = [fn(n, v) for n, v in zip(self.names, opt[moment])]
        out["opt"] = opt
        return out

    def gather_state(self, state: dict) -> dict:
        """a ``TrainState.state_dict()`` of slices -> the whole tensors
        (params, EMA, AdamW moments) in the one-process layout (collective)"""
        return self._map_state(state, self.gather)

    def scatter_state(self, state: dict) -> dict:
        """a one-process ``TrainState.state_dict()`` -> this rank's slices"""
        return self._map_state(state, self.scatter)


def _path(name: str) -> str:
    return name.replace(".", "/")


def shard_model(model: nn.Module, group: Any, rank: int, size: int) -> Optional[TPLayout]:
    """replace, in place, the parameters that ``DEFAULT_TP_RULES`` match in
    every module that declares its units (``tp_units() -> (units, entries a
    unit)``) by this rank's slice of them, and give each module whose
    parameters were split its ``tp`` share (a module no rule matched runs
    whole); -> the model's layout (kept as ``model.tp_layout``), None when
    nothing is split"""
    rules = [(re.compile(pat), split) for pat, split in DEFAULT_TP_RULES]
    partial_rules = [re.compile(pat) for pat in PARTIAL_GRAD_RULES]
    splits: dict[str, Split] = {}
    partial: set[str] = set()
    for mod_name, module in model.named_modules():
        if not hasattr(module, "tp_units"):
            continue
        units, unit = module.tp_units()
        if units < size:  # fewer units than ranks: replicated, the JAX fallback
            continue
        lo, hi = even_split(units, size, rank)
        prefix = f"{mod_name}." if mod_name else ""
        ruled = {}
        for p_name, _ in module.named_parameters():
            path = _path(prefix + p_name)
            rule = next((split for pat, split in rules if pat.search(path)), None)
            if rule is not None:
                ruled[p_name] = Split(rule[0], rule[1], unit, units, lo, hi)
        if not ruled:
            continue
        for p_name, param in list(module.named_parameters()):
            split = ruled.get(p_name)
            if split is None:
                if any(r.search(_path(prefix + p_name)) for r in partial_rules):
                    partial.add(prefix + p_name)
                continue
            owner_name, _, leaf = p_name.rpartition(".")
            owner = module.get_submodule(owner_name) if owner_name else module
            setattr(owner, leaf, nn.Parameter(split.take(param.detach()),
                                              requires_grad=param.requires_grad))
            splits[prefix + p_name] = split
        module.tp = TPSlice(group, rank, size, units, lo, hi)
    if not splits:
        return None
    names = [n for n, _ in model.named_parameters()]
    model.tp_layout = TPLayout(names, splits, partial & set(names), group)
    return model.tp_layout


def layout_of(model: nn.Module) -> Optional[TPLayout]:
    """the model's tensor-parallel layout (None: nothing split)"""
    return getattr(model, "tp_layout", None)
