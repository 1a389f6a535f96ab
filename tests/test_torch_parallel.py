"""The port's ``parallel/`` (osu_dreamer_tpu_torch/parallel/) against the JAX
package's, without starting any rank: the copied ``ParallelArgs``, every
check of ``build_parallelism`` with the JAX messages, the auto rule of
``auto_data_parallel``, the ``(data, sp)`` and ``(data, model)`` rank
layouts, the rows and spans a rank takes, and ``rope``'s offset.

The module imports no jax at the top: tests/test_torch_parallel_dp.py and
tests/test_torch_parallel_sp.py import its helpers, and their rank bodies
run in spawned processes that must not load jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from osu_dreamer_tpu_torch.parallel import ParallelArgs, auto_data_parallel, build_parallelism
from osu_dreamer_tpu_torch.parallel.config import Parallelism
from osu_dreamer_tpu_torch.parallel.distributed import launch
from osu_dreamer_tpu_torch.parallel.mesh import rank_grid

# the tiny models of tests/test_torch_{train,modules,style}.py (copies: those
# modules import jax at the top)
TINY_DIFFUSION = dict(emb_dim=6, a_dim=16, style_dim=8, global_cond_dim=32, backbone_dim=128,
                      u_head_dim=16, backbone=dict(depth=2, expand=2, head_dim=64, n_heads=2,
                                                   radius=2))
TINY_LATENT = dict(emb_dim=4, style_dim=8, n_downs=2, stride=3, h_dim=16,
                   stack=dict(n_layers=1, expand=2, radius=2), style_head_dim=8, style_heads=2)
TINY_STYLE = dict(style_dim=8, label_features=16, h_dim=32, depth=2, expand=2)

# every spawn must finish within this, and every collective within
# COLLECTIVE_S, so a hung rank fails one test instead of the suite
DEADLINE_S = 120.0
COLLECTIVE_S = 60.0


def spawn(fn, *args, ranks: int = 2) -> None:
    """``fn(*args)`` in ``ranks`` spawned gloo ranks on the CPU"""
    launch(fn, args, ["cpu"] * ranks, ranks, timeout_s=COLLECTIVE_S, deadline_s=DEADLINE_S)


def randomize_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """every parameter redrawn from ``seed`` (fan-in scaled normal kernels,
    1 + 0.1 N gains, 0.1 N other vectors): flax's zero-initialised layers
    would hide paths from a comparison"""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = torch.randn(p.shape, generator=gen)
            if p.dim() >= 2:
                draw = draw / float(np.prod(p.shape[:-1])) ** 0.5
            elif name.endswith("gamma"):
                draw = 1.0 + 0.1 * draw
            else:
                draw = 0.1 * draw
            p.copy_(draw)
    return model


# ---------------------------------------------------------------- copies ----


def test_parallel_args_defaults_match_jax():
    from osu_dreamer_tpu.parallel import ParallelArgs as JArgs

    assert dataclasses.asdict(ParallelArgs()) == dataclasses.asdict(JArgs())
    assert [f.name for f in dataclasses.fields(ParallelArgs)] == \
        [f.name for f in dataclasses.fields(JArgs)]


# ------------------------------------------------------ build_parallelism ----

CPU = torch.device("cpu")
MH = dict(coordinator="127.0.0.1:1", num_processes=2, process_id=0)


@pytest.mark.parametrize("args, batch, n_dev, error, match", [
    # the JAX checks in their order (osu_dreamer_tpu/parallel/config.py)
    (dict(**MH), 7, 1, ValueError, "must divide evenly over 2 processes"),
    (dict(tp=2, sp=2), 8, 4, ValueError, r"parallel.tp and parallel.sp cannot be combined"),
    (dict(dp=1, **MH), 8, 2, ValueError, "divergent"),
    (dict(dp=2, **MH), 8, 2, ValueError,
     r"multi-host dp must span every device: parallel.dp=2 but 4 global devices"),
    (dict(**MH), 6, 2, ValueError, r"multi-host: global batch 6 must divide over all 4"),
    (dict(sp=2, **MH), 8, 2, ValueError, r"parallel.sp is single-process for now"),
    (dict(sp=3), 8, 4, ValueError, r"4 devices not divisible by parallel.sp=3"),
    (dict(sp=2), 9, 4, ValueError, r"batch size 9 not divisible by the 2-way data axis"),
    (dict(dp=8), 8, 2, ValueError, r"parallel.dp=8 but only 2 devices"),
    (dict(dp=8), 30, 8, ValueError, r"batch size 30 not divisible by parallel.dp=8"),
    # tensor parallelism: the JAX tp_mesh and data-axis checks
    (dict(tp=3), 8, 8, ValueError, r"8 devices not divisible by n_model=3"),
    (dict(tp=2), 6, 8, ValueError, r"batch size 6 not divisible by the 4-way data axis"),
    (dict(coordinator="127.0.0.1:1"), 8, 1, ValueError, "needs parallel.num_processes"),
    # the port's own: a model group stays within one host
    (dict(tp=4, **MH), 8, 2, ValueError, r"parallel.tp=4 must divide each host's 2 devices"),
])
def test_build_parallelism_refusals(args, batch, n_dev, error, match):
    with pytest.raises(error, match=match):
        build_parallelism(ParallelArgs(**args), batch, [CPU] * n_dev)


def test_build_parallelism_refusals_match_jax(monkeypatch):
    """the JAX ``build_parallelism`` raises the same errors with the same
    messages over the same (faked) device counts"""
    import osu_dreamer_tpu.parallel.config as jcfg

    cases = [(dict(dp=1, **MH), 8, 2), (dict(dp=2, **MH), 8, 2), (dict(**MH), 6, 2),
             (dict(**MH), 7, 1), (dict(tp=2, sp=2), 8, 4), (dict(sp=3), 8, 4),
             (dict(sp=2), 9, 4), (dict(dp=8), 8, 2), (dict(dp=8), 30, 8),
             (dict(sp=2, **MH), 8, 2), (dict(tp=3), 8, 8), (dict(tp=2), 6, 8),
             (dict(tp=2, **MH), 6, 4)]
    for args, batch, n_dev in cases:
        n_proc = args.get("num_processes", 1)
        monkeypatch.setattr(jcfg.jax, "process_count", lambda n=n_proc: n)
        monkeypatch.setattr(jcfg.jax, "process_index", lambda: 0)
        monkeypatch.setattr(jcfg.jax, "devices", lambda n=n_dev * n_proc: [object()] * n)
        monkeypatch.setattr(jcfg, "init_multihost", lambda *a: None)
        with pytest.raises(ValueError) as want:
            jcfg.build_parallelism(jcfg.ParallelArgs(**args), batch)
        with pytest.raises(ValueError) as got:
            build_parallelism(ParallelArgs(**args), batch, [CPU] * n_dev)
        assert str(got.value) == str(want.value), args


@pytest.mark.parametrize("args, batch, n_dev, world, sp, tp", [
    (dict(), 8, 1, 1, 1, 1),           # auto on one device
    (dict(), 8, 4, 4, 1, 1),           # auto: every device
    (dict(), 30, 8, 6, 1, 1),          # auto trims to the largest divisor
    (dict(), 13, 8, 1, 1, 1),          # no divisor: one device
    (dict(dp=1), 8, 4, 1, 1, 1),       # explicit single device
    (dict(dp=2), 8, 4, 2, 1, 1),       # configured: the first two devices
    (dict(sp=2), 8, 4, 4, 2, 1),       # (data=2, sp=2)
    (dict(sp=4), 8, 4, 4, 4, 1),       # (data=1, sp=4)
    (dict(tp=2), 8, 4, 4, 1, 2),       # tensor parallelism: (data=2, model=2)
    (dict(tp=2), 3, 2, 2, 1, 2),       # (data=1, model=2): any batch
    (dict(num_processes=2), 8, 1, 1, 1, 1),  # no coordinator: one process, as in JAX
])
def test_build_parallelism_resolves_the_world(args, batch, n_dev, world, sp, tp):
    par = build_parallelism(ParallelArgs(**args), batch, [CPU] * n_dev)
    assert (par.world_size, par.sp, par.tp, par.n_data) == (world, sp, tp, world // (sp * tp))
    assert par.rank is None and par.needs_launch == (world > 1)
    assert par.sp_axis == ("sp" if sp > 1 else None)
    assert (par.process_count, par.input_shard, par.local_batch_size) == (1, None, batch)


@pytest.mark.parametrize("n_dev, batch, want", [
    (8, 30, 6), (8, 13, 1), (1, 8, 1), (4, 8, 4), (3, 8, 2), (8, 128, 8), (6, 32, 4),
])
def test_auto_data_parallel_matches_jax(monkeypatch, n_dev, batch, want):
    """the JAX rule over (devices, batch), the cases of
    tests/test_parallel.py::test_mesh_edges_trim_and_no_divisor among them"""
    import osu_dreamer_tpu.parallel.mesh as jmesh

    monkeypatch.setattr(jmesh.jax, "devices", lambda: list(range(n_dev)))
    monkeypatch.setattr(jmesh, "data_parallel_mesh", lambda devs: devs)
    jmesh_devs = jmesh.auto_data_parallel(batch)
    assert (1 if jmesh_devs is None else len(jmesh_devs)) == want
    assert auto_data_parallel(batch, n_dev) == want


@pytest.mark.parametrize("n_data, sp", [(2, 4), (4, 2), (1, 4), (3, 1)])
def test_rank_grid_matches_the_jax_mesh(n_data, sp):
    """sp groups are the rows of ``devices.reshape(n_data, sp)``, data groups
    its columns; every rank in exactly one of each"""
    grid = np.arange(n_data * sp).reshape(n_data, sp)
    data_groups, sp_groups = rank_grid(n_data, sp)
    assert sp_groups == grid.tolist() and data_groups == grid.T.tolist()


def _rank(par: Parallelism, rank: int) -> Parallelism:
    return dataclasses.replace(par, rank=rank)


@pytest.mark.parametrize("args, n_dev", [(dict(dp=4), 4), (dict(sp=2), 4), (dict(sp=4), 4),
                                         (dict(tp=2), 4)])
def test_shard_batch_rows_and_spans_tile_the_batch(args, n_dev):
    """the ranks' rows (and spans) tile the host's batch exactly once, in
    rank order within the (data, sp) grid; draws at the global shape slice
    the same way; the ranks of a model group take the same rows"""
    B, L = 8, 12
    par = build_parallelism(ParallelArgs(**args), B, [CPU] * n_dev)
    x = torch.arange(B * L).reshape(B, L, 1)
    s = torch.arange(B)
    seen = torch.zeros(B, L, dtype=torch.int64)
    for r in range(par.world_size):
        pr = _rank(par, r)
        xs, ss = pr.shard_batch((x, s), seq_fields=(0,))
        rows, span = B // pr.n_data, L // pr.sp
        assert xs.shape == (rows, span, 1) and ss.shape == (rows,)
        lo = pr.data_rank * rows
        assert torch.equal(ss, s[lo:lo + rows])
        assert torch.equal(pr.take_span(pr.take_rows(x, rows), span), xs)
        seen[lo:lo + rows, pr.sp_rank * span:(pr.sp_rank + 1) * span] += 1
    assert torch.equal(seen, torch.full_like(seen, par.tp))


def test_multihost_rows_follow_the_host_shard():
    """two hosts of two ranks: each host loads half the global batch, each
    of its ranks a quarter; global rank = host x 2 + local rank"""
    par = Parallelism(input_shard=(2, 1), process_index=1, process_count=2,
                      local_batch_size=4, world_size=4, devices=[CPU, CPU])
    host_batch = (torch.arange(4),)
    got = [_rank(par, r).shard_batch(host_batch)[0].tolist() for r in (2, 3)]
    assert got == [[0, 1], [2, 3]]
    assert [_rank(par, r).data_rank for r in (2, 3)] == [2, 3]


def test_lockstep_stream_and_single_process_context():
    par = build_parallelism(ParallelArgs(), 8)
    assert par.lockstep_steps(100) is None
    assert list(par.lockstep_stream(iter(range(5)), None)) == list(range(5))
    assert list(par.lockstep_stream(iter(range(5)), 3)) == [0, 1, 2]
    assert par.average_gradients([torch.ones(2)])[0].tolist() == [1.0, 1.0]
    from osu_dreamer_tpu_torch.parallel import input_shard

    assert input_shard() == (1, 0)


@pytest.mark.parametrize("offset", [0, 12, 37])
def test_rope_offset_matches_jax(offset):
    """the JAX ``rope(x, offset)``: a shard's positions counted from its
    global start"""
    import jax.numpy as jnp

    from osu_dreamer_tpu.nn.attention import rope as jrope
    from osu_dreamer_tpu_torch.ops.fused_attention import rope

    x = np.random.default_rng(offset).standard_normal((2, 12, 3, 64)).astype(np.float32)
    want = np.asarray(jrope(jnp.asarray(x), offset))
    np.testing.assert_allclose(rope(torch.from_numpy(x), offset).numpy(), want, atol=2e-6)
    if offset:
        whole = rope(torch.from_numpy(np.concatenate([x] * 4, axis=1)))
        np.testing.assert_allclose(rope(torch.from_numpy(x), 12)[:, :].numpy(),
                                   whole[:, 12:24].numpy(), atol=1e-6)
