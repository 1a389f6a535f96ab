"""The rank layouts of the port's parallel runs.

Counterpart of osu_dreamer_tpu/parallel/mesh.py. The JAX package lays its
devices on a ``jax.sharding.Mesh``; the port runs one process (a rank) per
device, so a layout here is a list of rank groups:
- data parallelism: every rank holds the whole model and its own rows of the
  global batch (``auto_data_parallel`` picks how many ranks, the JAX rule);
- sequence parallelism: a ``(data, sp)`` grid, ``Mesh(devices.reshape(n_data,
  sp))`` in the JAX package, whose sp groups are runs of ``sp`` consecutive
  ranks and whose data groups take one rank from each run;
- tensor parallelism: a ``(data, model)`` grid, the JAX ``tp_mesh``, laid
  out the same way: a model group is a run of ``tp`` consecutive ranks, so
  it stays within one host (each host's ranks are consecutive).
"""

from __future__ import annotations


def auto_data_parallel(batch_size: int, n_devices: int) -> int:
    """the JAX ``auto_data_parallel`` rule: all ``n_devices`` when more than
    one is visible, trimmed to the largest count that divides the batch
    size -> the number of data-parallel ranks (1: one device)"""
    if n_devices <= 1:
        return 1
    n = next(k for k in range(n_devices, 0, -1) if batch_size % k == 0)
    if n == 1:
        print(
            f"[parallel] batch size {batch_size} shares no divisor with "
            f"{n_devices} devices; training single-device"
        )
        return 1
    if n < n_devices:
        print(
            f"[parallel] batch size {batch_size} not divisible by "
            f"{n_devices} devices; using {n}"
        )
    else:
        print(f"[parallel] data-parallel over {n} devices")
    return n


def rank_grid(n_data: int, inner: int) -> tuple[list[list[int]], list[list[int]]]:
    """the ranks of a ``(data, sp)`` or ``(data, model)`` grid -> (its data
    groups, its inner groups): inner group d is ranks ``d * inner .. d *
    inner + inner - 1`` (a row of the JAX mesh), data group s the ranks
    ``s, s + inner, ...`` (a column)"""
    inner_groups = [[d * inner + s for s in range(inner)] for d in range(n_data)]
    data_groups = [[d * inner + s for d in range(n_data)] for s in range(inner)]
    return data_groups, inner_groups
