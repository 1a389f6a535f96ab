"""The numbers that decide ``correct``: each a gap between what the timed
path produced and what the reference works out, with the limit the cell's
workload file sets for it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Check(NamedTuple):
    name: str
    value: float
    limit: float | None

    @property
    def ok(self) -> bool:
        return self.limit is not None and bool(np.isfinite(self.value)) and self.value <= self.limit


def checks(readings: dict[str, float], limits: dict[str, float]) -> list[Check]:
    """the readings beside their limits; a reading without a limit fails"""
    return [Check(name, float(value), limits.get(name)) for name, value in readings.items()]


def worst_row_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """the largest over rows (the first axis) of |prog - ref|, over the
    larger of the reference's norm of that row and of the median row, in the
    2-norm over the rest of each row"""
    p = prog.reshape(prog.shape[0], -1).astype(np.float64)
    r = ref.reshape(ref.shape[0], -1).astype(np.float64)
    norms = np.linalg.norm(r, axis=1)
    den = np.maximum(norms, max(float(np.median(norms)), 1e-30))
    return float(np.max(np.linalg.norm(p - r, axis=1) / den))


def leaf_norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gaps(prog: dict[str, torch.Tensor], ref: dict[str, torch.Tensor],
              leaves=None) -> dict[str, float]:
    """each leaf's | |prog| - |ref| |, over the larger of the reference's norm
    of that leaf and of the median leaf"""
    leaves = list(ref) if leaves is None else list(leaves)
    p, r = leaf_norms({k: prog[k] for k in leaves}), leaf_norms({k: ref[k] for k in leaves})
    med = float(np.median(list(r.values())))
    return {k: abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in leaves}


def worst_leaf(gaps: dict[str, float]) -> tuple[float, str]:
    """(the largest gap, its leaf)"""
    return max((g, k) for k, g in gaps.items())


def median_leaf(gaps: dict[str, float]) -> float:
    return float(np.median(list(gaps.values())))


def moved_leaves(ref_grad: dict[str, torch.Tensor], share: float = 1e-3) -> list[str]:
    """the leaves whose reference gradient is at least ``share`` of the
    median leaf's: the others move under Adam by round-off alone"""
    norms = leaf_norms(ref_grad)
    med = float(np.median(list(norms.values())))
    return [k for k, n in norms.items() if n >= share * med]
