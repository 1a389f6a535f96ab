"""The port's ``predict`` on the CPU (``--device cpu``), on the tiny ``.odt``
of tests/test_torch_artifact.py and short 44 100 Hz stereo WAVs, as
tests/test_end_to_end.py drives the JAX command:

- one song with ``--snap-divisor 4``: one .osz holding the WAV and one .osu
  with its sections;
- bulk with ``--batch-songs 2 --serialize-workers 2``: one .osz a song, D
  entries each, each entry's text equal to ``decode_osu_entry`` run here on
  the quantized chart ``run_predict`` fetched, a seeded rerun writing the
  same texts, and the two ``OSU_DREAMER_TIMING`` lines;
- without ``--device`` and without a card, ``predict`` raises;
- the device part held to the JAX package: the JAX ``build_batch_sampler``
  on the same .odt and the port's with the JAX draws injected as ``s0``/``x0``
  agree within tests/test_torch_slice.py's tolerance (charts +-1 step on the
  quantized grid, labels 1e-3), and the port's serializer on the JAX
  sampler's quantized chart gives JAX ``decode_osu_entry``'s text.
"""

from __future__ import annotations

import re
import wave
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_artifact import _tiny_odt

torch.set_num_threads(1)

SECTIONS = ("[General]", "[Metadata]", "[Difficulty]", "[TimingPoints]", "[HitObjects]")
DIFFS = [(5.0, 9.0, 8.0, 4.0, 6.0), (3.0, 7.0, 6.0, 3.0, 5.0)]


@pytest.fixture(scope="module")
def odt(tmp_path_factory):
    """the tiny artifact, made once: flax's eager init of it takes most of
    this file's time"""
    return _tiny_odt(tmp_path_factory.mktemp("odt"))


def write_song(path: Path, seconds: float, freq: float, seed: int) -> Path:
    """a 44 100 Hz stereo 16-bit WAV: a tone with clicks"""
    rate = 44100
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    x = 0.4 * np.sin(2 * np.pi * freq * t)
    for onset in np.arange(0.3, seconds - 0.1, 0.35):
        i = int(onset * rate)
        x[i : i + 300] += rng.normal(0, 0.3, len(x[i : i + 300]))
    pcm = np.round(np.clip(np.stack([x, 0.8 * x], axis=1), -1, 1) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return path


def _entries(osz: Path) -> dict[str, str]:
    with zipfile.ZipFile(osz) as z:
        return {n: z.read(n).decode() for n in z.namelist() if n.endswith(".osu")}


def test_predict_single_song_snapped(tmp_path, monkeypatch, odt):
    from osu_dreamer_tpu_torch.cli import main

    song = write_song(tmp_path / "song.wav", 4.0, 220.0, 0)
    out = tmp_path / "out"
    out.mkdir()
    monkeypatch.chdir(out)
    main(["predict", "--model-path", str(odt), "--audio-file", str(song),
          "--diff", "5", "9", "8", "4", "6", "--sample-steps", "2", "--title", "Synth",
          "--artist", "Test", "--seed", "0", "--snap-divisor", "4", "--device", "cpu"])
    mapsets = list(out.glob("*.osz"))
    assert len(mapsets) == 1 and mapsets[0].name.endswith(" Test - Synth.osz")
    with zipfile.ZipFile(mapsets[0]) as z:
        names = z.namelist()
        assert "song.wav" in names
        assert z.read("song.wav") == song.read_bytes()
    (name, text), = _entries(mapsets[0]).items()
    assert name == "Test - Synth (osu!dreamer-tpu) [version 0].osu"
    for section in SECTIONS:
        assert section in text
    assert "AudioFilename: song.wav" in text and "Title: Synth" in text


def test_predict_bulk_batched(tmp_path, monkeypatch, capsys, odt):
    """two songs of one bucket in one batch, two difficulty rows, decoded by
    two spawned workers"""
    from osu_dreamer_tpu_torch.cli import run_predict
    from osu_dreamer_tpu_torch.models.inference.artifact import load_inference
    from osu_dreamer_tpu_torch.models.inference.sampler import dequantize_chart
    from osu_dreamer_tpu_torch.signal.serialize import decode_osu_entry

    model = load_inference(odt, "cpu")
    songs = [write_song(tmp_path / "a.wav", 4.0, 220.0, 1),
             write_song(tmp_path / "b.wav", 3.0, 330.0, 2)]
    monkeypatch.setenv("OSU_DREAMER_TIMING", "1")
    runs = []
    for run in ("first", "again"):
        out = tmp_path / run
        out.mkdir()
        monkeypatch.chdir(out)
        runs.append(run_predict(model, songs, DIFFS, 2, seed=1, serialize_workers=2,
                                batch_songs=2, device="cpu"))
        assert len(list(out.glob("*.osz"))) == 2
    printed = capsys.readouterr().out
    assert printed.count("sampling 2 song(s) x 2 difficulties") == 2
    timing = re.findall(r"^\[timing\] host-phase totals: (.*)$", printed, re.M)
    assert len(timing) == 2
    for phase in ("load_wave", "prep", "upload_dispatch", "fetch"):
        assert re.search(rf"\b{phase}=\d+ms", timing[0]), timing[0]
    stages = re.findall(r"^\[timing\] sampler host issue: (.*)$", printed, re.M)
    assert len(stages) == 2
    for stage in ("featurize", "latent.encode", "style.sample", "diffusion.sample",
                  "latent.decode"):
        assert re.search(rf"(^| ){re.escape(stage)}=\d+ms", stages[1]), stages[1]

    texts = []
    for done, song in zip(runs[0], songs):
        assert done.audio_file == song and done.title == song.stem
        assert done.artist == "Unknown Artist"
        assert done.hit_u8.shape[0] == done.xy_i16.shape[0] == done.labels.shape[0] == 2
        entries = _entries(done.osz)
        assert len(entries) == 2
        signals = dequantize_chart(done.hit_u8, done.xy_i16)[:, : done.frames].transpose(0, 2, 1)
        for i, (row, sig) in enumerate(zip(done.labels, signals)):
            name, text = decode_osu_entry(done.title, done.artist, song.name, i, row, sig)
            assert entries[name] == text
            for section in SECTIONS:
                assert section in text
        texts.append(entries)
    assert [_entries(done.osz) for done in runs[1]] == texts


def test_predict_needs_the_card_unless_asked(tmp_path, odt):
    from osu_dreamer_tpu_torch.cli import main, run_predict
    from osu_dreamer_tpu_torch.models.inference.artifact import load_inference

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: predict runs on it")
    song = write_song(tmp_path / "song.wav", 1.0, 220.0, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["predict", "--model-path", str(odt), "--audio-file", str(song)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_predict(load_inference(odt, "cpu"), [song])
    with pytest.raises(ValueError, match="only apply to a single audio file"):
        run_predict(load_inference(odt, "cpu"), [song, song], title="x", device="cpu")


def test_device_part_and_serializer_match_jax(tmp_path, monkeypatch, odt):
    import jax
    import jax.numpy as jnp

    from osu_dreamer_tpu import native as jnative
    from osu_dreamer_tpu.models.inference.artifact import load_inference as jload
    from osu_dreamer_tpu.models.inference.sampler import build_batch_sampler as jbuild
    from osu_dreamer_tpu.models.inference.sampler import dequantize_chart
    from osu_dreamer_tpu.signal.serialize import decode_osu_entry as jentry
    from osu_dreamer_tpu_torch import native as tnative
    from osu_dreamer_tpu_torch.audio.decode import load_wave
    from osu_dreamer_tpu_torch.audio.spectrogram import prep_wave_for_model
    from osu_dreamer_tpu_torch.models.inference.artifact import load_inference as tload
    from osu_dreamer_tpu_torch.models.inference.sampler import build_batch_sampler as tbuild
    from osu_dreamer_tpu_torch.signal.serialize import decode_osu_entry as tentry

    jm, jparams = jload(odt)
    tm = tload(odt, "cpu")
    chunk = tm.args.latent.chunk_size
    songs = [write_song(tmp_path / f"{i}.wav", 3.0 + i, 220.0 * (i + 1), i) for i in range(2)]
    preps = [prep_wave_for_model(load_wave(s), chunk) for s in songs]
    assert len({p[2:] for p in preps}) == 1
    waves = np.stack([p[0] for p in preps])
    real = np.array([p[1] for p in preps], np.int32)
    n_frames, out_frames = preps[0][2], preps[0][3]
    labels = np.asarray(DIFFS, np.float32)
    B, steps = len(songs) * len(DIFFS), 2

    key = jax.random.PRNGKey(7)
    rng_style, rng_z = jax.random.split(key)
    s0 = np.asarray(jax.random.normal(rng_style, (B, jm.args.style.style_dim), jnp.float32))
    x0 = np.asarray(jax.random.normal(
        rng_z, (B, out_frames // chunk, jm.args.diffusion.emb_dim), jnp.float32))
    hit_j, xy_j, lab_j = (np.asarray(a) for a in jbuild(jm)(
        jparams, waves, real, labels, key, n_frames, out_frames, steps, 1.0))
    with torch.inference_mode():
        hit_t, xy_t, lab_t = tbuild(tm)(
            torch.from_numpy(waves), torch.from_numpy(real), torch.from_numpy(labels), None,
            n_frames, out_frames, steps, 1.0, s0=torch.from_numpy(s0), x0=torch.from_numpy(x0))
    assert hit_t.shape == hit_j.shape and xy_t.shape == xy_j.shape
    assert np.abs(hit_t.numpy().astype(int) - hit_j.astype(int)).max() <= 1
    assert np.abs(xy_t.numpy().astype(int) - xy_j.astype(int)).max() <= 1
    np.testing.assert_allclose(lab_t.float().numpy(), lab_j, atol=1e-3)

    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    chart = dequantize_chart(hit_j, xy_j)
    frames = -(-len(load_wave(songs[0])) // 98)
    for row in range(len(DIFFS)):
        sig = chart[row, :frames].T
        for infer_tempo, snap in ((False, 0), (True, 0), (False, 4)):
            args = ("Synth", "Test", "0.wav", row, lab_j[row], sig, infer_tempo, snap)
            assert tentry(*args) == jentry(*args)
