"""The port's span facility (osu_dreamer_tpu_torch/train/profiling.py
``span``) on the CPU:

- off (no profiler, not enabled): no record, no ``record_function``, one
  shared no-op context a name;
- on through ``enable()``: names, parents and units nest, each thread on
  its own stack, and the store stays whole under many threads;
- under ``torch.profiler``: one ``user_annotation`` range ``odt.<name>`` a
  record in the Chrome trace, nested as the store says;
- a tiny predict batch through ``build_batch_sampler``, a tiny diffusion
  train step and a tiny latent train step record their stages once each
  inside one unit span.
"""

from __future__ import annotations

import json
import sys
import threading

import numpy as np
import pytest
import torch

from osu_dreamer_tpu_torch.train import profiling
from osu_dreamer_tpu_torch.train.profiling import span

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def store():
    """an empty store, spans off, before and after each test"""
    was = profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(was)
    profiling.reset()


def by_name(records):
    out = {}
    for i, r in enumerate(records):
        out.setdefault(r.name, []).append((i, r))
    return out


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened while spans are off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)

    @span("decorated")
    def work(x):
        with span("inner"):
            return x + 1

    assert span("a") is span("a") and span("a") is not span("b")
    with span("a") as got:
        assert got is None
    assert work(1) == 2
    assert profiling.records() == [] and profiling.totals() == {}


def test_enabled_spans_nest_with_a_stack_per_thread():
    profiling.enable()
    opened = threading.Barrier(2, timeout=30)

    def unit(tag):
        with span(f"unit.{tag}"):
            with span("stage"):
                opened.wait()  # both threads hold their stacks open at once
                with span("leaf"):
                    pass
            with span("stage"):
                pass

    threads = [threading.Thread(target=unit, args=(tag,)) for tag in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    recs = profiling.records()
    assert len(recs) == 8 and all(r.end_ns is not None for r in recs)
    names = by_name(recs)
    units = {}
    for tag in ("a", "b"):
        (i, u), = names[f"unit.{tag}"]
        assert u.parent is None and u.unit == i
        units[i] = u.thread
    assert units.keys() == {r.unit for r in recs} and len(set(units.values())) == 2
    for i, r in enumerate(recs):
        if r.parent is None:
            continue
        parent = recs[r.parent]
        assert parent.thread == r.thread and parent.unit == r.unit
        assert units[r.unit] == r.thread
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    for i, leaf in names["leaf"]:
        assert recs[leaf.parent].name == "stage" and recs[recs[leaf.parent].parent].parent is None
    calls = profiling.totals()
    assert {k: n for k, (n, _) in calls.items()} == {"unit.a": 1, "unit.b": 1, "stage": 4,
                                                    "leaf": 2}
    assert all(ns > 0 for _, ns in calls.values())


def test_the_store_stays_whole_under_many_threads():
    """more threads than cores, switching every 10 us: every record finished,
    every child on its parent's thread and unit, the totals complete"""
    profiling.enable()
    n_threads, n_units = 16, 50
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def work():
        for _ in range(n_units):
            with span("unit"):
                with span("inner"):
                    pass

    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(saved)
    recs = profiling.records()
    assert len(recs) == 2 * n_threads * n_units
    for i, r in enumerate(recs):
        assert r.end_ns is not None
        if r.name == "unit":
            assert r.parent is None and r.unit == i
        else:
            assert recs[r.parent].name == "unit" and recs[r.parent].thread == r.thread
            assert r.unit == r.parent
    assert {k: n for k, (n, _) in profiling.totals().items()} == {
        "unit": n_threads * n_units, "inner": n_threads * n_units}


def test_under_the_profiler_each_record_is_one_range(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    @span("outer")
    def work():
        for _ in range(2):
            with span("inner"):
                torch.ones(8).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    work()  # after the profiler stops: off again
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("name", "").startswith("odt.")]
    recs = profiling.records()
    assert sorted(e["name"] for e in events) == sorted(
        profiling.RANGE_PREFIX + r.name for r in recs) == ["odt.inner", "odt.inner", "odt.outer"]
    (outer,) = [e for e in events if e["name"] == "odt.outer"]
    for e in events:
        assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    assert [recs[r.parent].name for r in recs if r.name == "inner"] == ["outer", "outer"]


def test_a_predict_batch_records_its_stages_inside_one_sample():
    from osu_dreamer_tpu_torch.audio.spectrogram import prep_wave_for_model
    from osu_dreamer_tpu_torch.models.inference.model import LDM
    from osu_dreamer_tpu_torch.models.inference.sampler import STAGES, build_batch_sampler
    from test_torch_modules import tiny_args

    model = LDM(tiny_args("torch"), torch.float32).eval()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=g))
    chunk = model.args.latent.chunk_size
    wave = 0.3 * np.sin(np.arange(3 * 22050) * 0.05).astype(np.float32)
    buf, real, n_frames, out_frames = prep_wave_for_model(wave, chunk)
    labels = torch.tensor([[5.0, 9.0, 8.0, 4.0, 6.0], [3.0, 7.0, 6.0, 3.0, 5.0]])
    sample = build_batch_sampler(model)
    args = (torch.from_numpy(buf)[None], torch.tensor([real]), labels,
            torch.Generator().manual_seed(1), n_frames, out_frames, 2, 1.0)
    sample(*args)
    assert profiling.records() == []
    profiling.enable()
    hit, xy, out_labels = sample(*args)
    assert hit.shape[0] == 2 and out_labels.shape == (2, 5)
    recs = profiling.records()
    assert [r.name for r in recs] == ["sample", *STAGES]
    assert recs[0].parent is None and all(r.parent == 0 and r.unit == 0 for r in recs[1:])
    assert all(r.end_ns is not None for r in recs)


def test_a_train_step_records_its_stages_inside_one_step():
    from osu_dreamer_tpu_torch.models.diffusion.train import LatentBatch, init_diffusion_training
    from test_torch_train import _args

    model_args, train_args = _args("torch")
    state, train_step = init_diffusion_training(model_args, train_args, 0, "cpu", torch.float32)
    g = torch.Generator().manual_seed(2)
    B, L = 2, 16
    batch = LatentBatch(torch.rand(B, L, model_args.a_dim, generator=g),
                        torch.randn(B, L, model_args.emb_dim, generator=g),
                        torch.randn(B, model_args.style_dim, generator=g),
                        torch.rand(B, 5, generator=g) * 10)
    profiling.enable()
    train_step(state, batch)
    recs = profiling.records()
    assert [r.name for r in recs] == ["train.step", "train.loss", "train.grad",
                                      "train.optimizer", "train.ema"]
    assert recs[0].parent is None and all(r.parent == 0 and r.unit == 0 for r in recs[1:])
    assert state.step == 1


def test_a_latent_train_step_records_its_stages_inside_one_step():
    from osu_dreamer_tpu_torch.models.latent.train import Batch, init_latent_training
    from test_torch_latent import L_TINY, _args, _batch_np

    model_args, train_args = _args("torch")
    state, train_step = init_latent_training(model_args, train_args, 0, "cpu", torch.float32)
    batch = Batch(*(torch.from_numpy(x) for x in _batch_np()))
    assert batch.chart.shape[1] == L_TINY
    profiling.enable()
    train_step(state, batch)
    recs = profiling.records()
    assert [r.name for r in recs] == ["train.step", "train.loss", "train.grad", "train.optimizer"]
    assert recs[0].parent is None and all(r.parent == 0 and r.unit == 0 for r in recs[1:])
    assert all(r.end_ns is not None for r in recs)
    assert state.step == 1
