"""The port's dataset build against the JAX package on the CPU:
``make_spec`` (the float-wave featurizer of generate-data), ``write_spec``,
``data/synth.py``'s library generator, ``build_dataset`` over a local
library and over recorded HF rows, ``normalize_hf_sample``, and the
``generate-data`` command.

Tolerances: ``make_spec`` within 1e-5 absolute of the JAX one. Both run the
same resonator recurrence in f32 (the port's plain doubling scan here, the
JAX associative scan there), then ``1 + log10(p / p_max) / 4``: a relative
error e in a bin's power moves its value by about 0.11 e, and the scans'
f32 errors stay below 1e-4 relative in the quietest bins that survive the
60 dB floor. After ``write_spec``'s uint8 rounding a value within 1e-5 of
a rounding edge may land one step away, so quantized specs are held to one
step. Everything else (texts, map files, the output tree, the synthetic
wave) is the same numpy code on both sides: equal, the wave within 1e-6.
"""

from __future__ import annotations

import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_hf_ingest import fixture_page
from test_local_ingest import make_library

torch.set_num_threads(1)

SPEC_ATOL = 1e-5


def _wave(case: str) -> np.ndarray:
    from osu_dreamer_tpu_torch.audio.constants import HOP_LEN, SR
    from osu_dreamer_tpu_torch.audio.spectrogram import WAVE_BUCKET

    rng = np.random.default_rng(7)
    if case == "silence":
        return np.zeros(SR, np.float32)
    if case == "one_sample":
        return np.array([0.5], np.float32)
    if case == "tone":
        t = np.arange(3 * SR) / SR
        return (0.4 * np.sin(2 * np.pi * 440.0 * t) + 0.01 * rng.normal(size=t.size)).astype(
            np.float32)
    n = {"bucket": WAVE_BUCKET, "bucket_plus_one": WAVE_BUCKET + 1,
         "ragged_hop": 5 * HOP_LEN + 17}[case]
    return (0.3 * rng.normal(size=n)).astype(np.float32)


@pytest.mark.parametrize("case", ["silence", "one_sample", "tone", "bucket", "bucket_plus_one",
                                  "ragged_hop"])
def test_make_spec_matches_jax(case):
    from osu_dreamer_tpu.audio.io import write_spec as jwrite
    from osu_dreamer_tpu.audio.spectrogram import make_spec as jmake
    from osu_dreamer_tpu_torch.audio.io import write_spec
    from osu_dreamer_tpu_torch.audio.spectrogram import make_spec

    wave = _wave(case)
    want = np.asarray(jmake(wave))
    got = make_spec(wave, "cpu")
    assert got.shape == want.shape == (72, max(1, -(-len(wave) // 98))) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=SPEC_ATOL, rtol=0)
    quantized = []
    for write, spec in ((write_spec, got), (jwrite, want)):
        buf = io.BytesIO()
        write(buf, spec)
        quantized.append(np.load(io.BytesIO(buf.getvalue())))
    assert quantized[0].dtype == np.uint8
    assert np.abs(quantized[0].astype(int) - quantized[1].astype(int)).max() <= 1


def test_write_spec_clips_and_rounds_as_jax():
    from osu_dreamer_tpu.audio.io import read_spec as jread
    from osu_dreamer_tpu.audio.io import write_spec as jwrite
    from osu_dreamer_tpu_torch.audio.io import read_spec, write_spec

    spec = np.random.default_rng(3).uniform(-0.2, 1.2, (72, 50)).astype(np.float32)
    files = []
    for write in (write_spec, jwrite):
        buf = io.BytesIO()
        write(buf, spec)
        files.append(buf.getvalue())
    assert files[0] == files[1]
    np.testing.assert_array_equal(read_spec(io.BytesIO(files[0])), jread(io.BytesIO(files[1])))


def test_make_spec_defaults_to_the_card():
    from osu_dreamer_tpu_torch.audio.spectrogram import make_spec

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_spec(np.zeros(100, np.float32))


@pytest.mark.parametrize("tempo_change", [False, True])
def test_make_mapset_matches_jax(tempo_change):
    from osu_dreamer_tpu.data.synth import make_mapset as jmake
    from osu_dreamer_tpu_torch.data.synth import make_mapset

    texts, wave, onsets = make_mapset(np.random.default_rng(5), seconds=15.0,
                                      tempo_change=tempo_change)
    jtexts, jwave, jonsets = jmake(np.random.default_rng(5), seconds=15.0,
                                   tempo_change=tempo_change)
    assert texts == jtexts
    np.testing.assert_allclose(wave, jwave, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(onsets, jonsets)


def test_build_library_matches_jax(tmp_path):
    """the same seed writes the same tree: .osu texts and WAV files equal"""
    from osu_dreamer_tpu.data.synth import DIFFS_PER_MAPSET as JDIFFS
    from osu_dreamer_tpu.data.synth import build_library as jbuild
    from osu_dreamer_tpu_torch.data.synth import DIFFS_PER_MAPSET, build_library

    assert DIFFS_PER_MAPSET == JDIFFS
    onsets = build_library(tmp_path / "port", 4, seconds=8.0, seed=2)
    jonsets = jbuild(tmp_path / "jax", 4, seconds=8.0, seed=2)
    assert sorted(onsets) == sorted(jonsets)
    for name in onsets:
        np.testing.assert_array_equal(onsets[name], jonsets[name])
    files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                           if p.is_file())
    assert len(files) == 4 * (DIFFS_PER_MAPSET + 1)
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def _tree(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _same_dataset(port: Path, jax: Path) -> None:
    """the same files; .map.npy arrays equal, spec.npy within one step"""
    assert _tree(port) == _tree(jax)
    for rel in _tree(port):
        if rel.endswith("spec.npy"):
            a, b = np.load(port / rel), np.load(jax / rel)
            assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape, rel
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, rel
        else:
            with np.load(port / rel) as a, np.load(jax / rel) as b:
                assert sorted(a.files) == sorted(b.files), rel
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{rel}:{k}")


@pytest.fixture
def numpy_paths(monkeypatch):
    from osu_dreamer_tpu import native as jnative
    from osu_dreamer_tpu_torch import native as tnative

    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def test_iter_local_samples_matches_jax(tmp_path):
    from osu_dreamer_tpu.data.ingest import iter_local_samples as jiter
    from osu_dreamer_tpu_torch.data.ingest import iter_local_samples

    songs = make_library(tmp_path)
    got, want = list(iter_local_samples(songs)), list(jiter(songs))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a == b


def test_build_dataset_local_matches_jax(tmp_path, numpy_paths):
    """tests/test_local_ingest.py's library (an .osz, a folder, a bad zip, a
    set whose audio is missing) -> the same dataset tree"""
    from osu_dreamer_tpu.data.ingest import build_dataset as jbuild
    from osu_dreamer_tpu_torch.data.ingest import build_dataset

    songs = make_library(tmp_path)
    assert sum(build_dataset(tmp_path / "port", 2, songs_dir=songs, device="cpu")) == 3
    assert sum(jbuild(tmp_path / "jax", 2, songs_dir=songs)) == 3
    _same_dataset(tmp_path / "port", tmp_path / "jax")
    assert len(_tree(tmp_path / "port")) == 5  # 2 spec.npy + 3 maps


def test_build_dataset_hf_rows_match_jax(tmp_path, numpy_paths):
    """tests/test_hf_ingest.py's recorded rows: a ranked set, a filtered
    set, a set with an unparseable map"""
    from osu_dreamer_tpu.data.ingest import build_dataset as jbuild
    from osu_dreamer_tpu.data.ingest import normalize_hf_sample as jnorm
    from osu_dreamer_tpu_torch.data.ingest import build_dataset, normalize_hf_sample

    for row in fixture_page():
        got, want = normalize_hf_sample(row), jnorm(row)
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(got.pop("wave"), want.pop("wave"))
        assert got == want
    rows = (normalize_hf_sample(r) for r in fixture_page())
    assert sum(build_dataset(tmp_path / "port", samples=rows, device="cpu")) == 3
    assert sum(jbuild(tmp_path / "jax", samples=(jnorm(r) for r in fixture_page()))) == 3
    _same_dataset(tmp_path / "port", tmp_path / "jax")
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "deadbeefcafe0001", "deadbeefcafe0003"]


def test_untrusted_hashes_stay_inside_data_dir(tmp_path):
    from osu_dreamer_tpu_torch.data.ingest import build_dataset, normalize_hf_sample

    rows = fixture_page()[:1]
    for bad in ("../escape", "..", "a/b"):
        rows[0]["json"]["audio_hash"] = bad
        written = sum(build_dataset(tmp_path / "data", force=True, device="cpu",
                                    samples=(normalize_hf_sample(r) for r in rows)))
        assert written == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["data"]


def test_build_dataset_idempotent_and_force(tmp_path):
    from osu_dreamer_tpu_torch.data.ingest import build_dataset

    songs, out = make_library(tmp_path), tmp_path / "data"
    assert sum(build_dataset(out, songs_dir=songs, device="cpu")) == 3
    mtimes = {p: p.stat().st_mtime_ns for p in out.rglob("*.npy")}
    assert sum(build_dataset(out, songs_dir=songs, device="cpu")) == 0
    assert {p: p.stat().st_mtime_ns for p in out.rglob("*.npy")} == mtimes
    assert sum(build_dataset(out, songs_dir=songs, force=True, device="cpu")) == 3


def test_iter_hf_samples_needs_datasets(monkeypatch):
    from osu_dreamer_tpu_torch.data.ingest import iter_hf_samples

    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(RuntimeError, match="--songs-dir"):
        next(iter_hf_samples())


def test_generate_data_cli(tmp_path, capsys):
    """--device cpu builds the dataset and prints the count; a second run
    writes nothing; a --songs-dir that is a file is refused; without a card
    the default device raises"""
    from osu_dreamer_tpu_torch.cli import main

    songs, out = make_library(tmp_path), tmp_path / "cli_data"
    main(["generate-data", "--data-dir", str(out), "--songs-dir", str(songs), "--num-workers",
          "3", "--device", "cpu"])
    assert "wrote 3 maps" in capsys.readouterr().out
    assert len(list(out.rglob("*.map.npy"))) == 3
    main(["generate-data", "--data-dir", str(out), "--songs-dir", str(songs), "--device", "cpu"])
    assert "wrote 0 maps" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["generate-data", "--data-dir", str(out), "--songs-dir",
              str(next(out.rglob("spec.npy"))), "--device", "cpu"])
    assert "is not a directory" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["generate-data", "--data-dir", str(out), "--songs-dir", str(songs), "--force"])
