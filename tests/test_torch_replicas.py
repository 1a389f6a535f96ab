"""Songs sharded over model replicas (parallel/replicas.py and
models/inference/sampler.py ``build_sharded_sampler``) on the CPU, where one
device listed twice stands for two cards:

- ``song_shards`` splits a batch's songs in order, as evenly as they go,
  never into an empty shard; ``replicate`` copies the weights to each
  device listed;
- a seeded batch sampled over two or three replicas equals the one-device
  sampler's at the same seed within one quantization step (the noise is
  drawn at the batch's shape and split; the step size is calibrated over
  the whole batch), for shared and per-song labels and with guidance;
- ``run_predict`` follows the JAX rule (``n_dev = min(devices,
  batch_songs)``, ``batch_songs`` rounded down to a multiple, the same
  ``[parallel]`` line) and its sharded charts equal its one-device charts
  within one quantization step.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_predict import DIFFS, odt, write_song  # noqa: F401  (odt: a fixture)

torch.set_num_threads(1)


@pytest.mark.parametrize("songs,replicas,want", [
    (1, 2, [(0, 1)]),
    (2, 2, [(0, 1), (1, 2)]),
    (3, 2, [(0, 2), (2, 3)]),
    (4, 2, [(0, 2), (2, 4)]),
    (5, 3, [(0, 2), (2, 4), (4, 5)]),
    (2, 8, [(0, 1), (1, 2)]),
    (7, 1, [(0, 7)]),
])
def test_song_shards(songs, replicas, want):
    from osu_dreamer_tpu_torch.parallel.replicas import song_shards

    assert [(s.start, s.stop) for s in song_shards(songs, replicas)] == want


def test_replicate_copies_the_weights(odt):  # noqa: F811
    from osu_dreamer_tpu_torch.models.inference.artifact import load_inference
    from osu_dreamer_tpu_torch.parallel.replicas import replicate

    model = load_inference(odt, "cpu")
    reps = replicate(model, ["cpu", "cpu", "cpu"])
    assert reps[0] is model and len({id(m) for m in reps}) == 3
    for replica in reps[1:]:
        for (name, a), (_, b) in zip(model.named_parameters(), replica.named_parameters()):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), name


def test_replica_devices_needs_the_cards():
    from osu_dreamer_tpu_torch.parallel.replicas import replica_devices

    with pytest.raises(ValueError, match="cards visible"):
        replica_devices(torch.cuda.device_count() + 1)


def _batch(model, n_songs: int, seconds: float, seed: int):
    """n_songs waves of one bucket, as prep_wave_for_model gives them"""
    from osu_dreamer_tpu_torch.audio.constants import SR
    from osu_dreamer_tpu_torch.audio.spectrogram import prep_wave_for_model

    rng = np.random.default_rng(seed)
    chunk = model.args.latent.chunk_size
    waves, real = [], []
    for i in range(n_songs):
        wave = (0.3 * rng.standard_normal(int(SR * (seconds - 0.1 * i)))).astype(np.float32)
        buf, real_frames, n_frames, out_frames = prep_wave_for_model(wave, chunk)
        waves.append(torch.from_numpy(buf))
        real.append(real_frames)
    return torch.stack(waves), torch.tensor(real), n_frames, out_frames


def _within_one_step(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("n_songs,n_replicas,per_song,guidance", [
    (2, 2, False, 1.0),
    (3, 2, True, 1.0),
    (3, 3, False, 2.0),
    (4, 2, True, 1.5),
])
def test_sharded_sampler_equals_one_device(odt, n_songs, n_replicas, per_song,  # noqa: F811
                                           guidance):
    from osu_dreamer_tpu_torch.models.inference.artifact import load_inference
    from osu_dreamer_tpu_torch.models.inference.sampler import (
        build_batch_sampler, build_sharded_sampler, gather_shards,
    )
    from osu_dreamer_tpu_torch.parallel.replicas import replicate

    model = load_inference(odt, "cpu")
    waves, real, n_frames, out_frames = _batch(model, n_songs, 2.0, n_songs)
    labels = torch.tensor(DIFFS, dtype=torch.float32)
    if per_song:
        labels = labels[None].repeat(n_songs, 1, 1) + torch.arange(n_songs)[:, None, None] * 0.5
    seed, steps = 7, 2
    one = build_batch_sampler(model)(waves, real, labels, torch.Generator("cpu").manual_seed(seed),
                                     n_frames, out_frames, steps, guidance)
    sample = build_sharded_sampler(replicate(model, ["cpu"] * n_replicas))
    try:
        shards = sample(waves, real, labels, seed, n_frames, out_frames, steps, guidance)
    finally:
        sample.close()
    assert len(shards) == min(n_songs, n_replicas)
    assert shards[-1].rows.stop == n_songs * len(DIFFS)
    hit, xy, pred = gather_shards(shards)
    _within_one_step((hit, xy), (one[0].numpy(), one[1].numpy()))
    np.testing.assert_allclose(pred, one[2].float().numpy(), atol=1e-3)


def test_sharded_sampler_failure_reaches_the_caller(odt):  # noqa: F811
    """a shard that raises aborts the others' wait at the batch mean"""
    from osu_dreamer_tpu_torch.models.inference.artifact import load_inference
    from osu_dreamer_tpu_torch.models.inference.sampler import build_sharded_sampler
    from osu_dreamer_tpu_torch.parallel.replicas import replicate

    model = load_inference(odt, "cpu")
    waves, real, n_frames, out_frames = _batch(model, 2, 1.5, 0)
    reps = replicate(model, ["cpu", "cpu"])

    def broken(*args, **kwargs):
        raise RuntimeError("replica lost")

    reps[1].style.sample = broken
    sample = build_sharded_sampler(reps)
    try:
        with pytest.raises(RuntimeError, match="replica lost"):
            sample(waves, real, torch.tensor(DIFFS), 0, n_frames, out_frames, 2, 1.0)
    finally:
        sample.close()


@pytest.mark.parametrize("n_devices,batch_songs,n_songs,line", [
    (2, 3, 3, "[parallel] sharding 2-song batches over 2 of 2 devices"),
    (3, 2, 3, "[parallel] sharding 2-song batches over 2 of 3 devices"),
    (2, 4, 3, "[parallel] sharding 2-song batches over 2 of 2 devices"),
    (2, 1, 2, None),
    (1, 2, 2, None),
])
def test_predict_shards_by_the_jax_rule(tmp_path, monkeypatch, capsys, odt, n_devices,  # noqa: F811
                                        batch_songs, n_songs, line):
    """``run_predict`` over ``n_devices`` CPU replicas: the JAX rule's line
    (or none), batches of the rounded size, and each song's chart within one
    quantization step of the one-device run at the same seed and batches"""
    from osu_dreamer_tpu_torch.cli import run_predict
    from osu_dreamer_tpu_torch.models.inference.artifact import load_inference

    model = load_inference(odt, "cpu")
    songs = [write_song(tmp_path / f"s{i}.wav", 2.0, 220.0 + 110 * i, i)
             for i in range(n_songs)]
    runs = {}
    for name, devices in (("sharded", ["cpu"] * n_devices), ("one", None)):
        out = tmp_path / name
        out.mkdir()
        monkeypatch.chdir(out)
        capsys.readouterr()
        rounded = min(batch_songs, n_songs)
        if line is not None:
            rounded -= rounded % min(n_devices, rounded)
        runs[name] = run_predict(model, songs, DIFFS, 2, seed=3, serialize_workers=1,
                                 batch_songs=batch_songs if devices else rounded,
                                 device="cpu", devices=devices)
        printed = capsys.readouterr().out
        if name == "sharded":
            parallel = [ln for ln in printed.splitlines() if ln.startswith("[parallel]")]
            assert parallel == ([line] if line else []), printed
            sizes = [int(ln.split()[1]) for ln in printed.splitlines()
                     if ln.strip().startswith("sampling")]
            assert sizes and max(sizes) == rounded and sum(sizes) == n_songs, sizes
    for a, b in zip(runs["sharded"], runs["one"]):
        assert a.audio_file == b.audio_file and a.frames == b.frames
        _within_one_step((a.hit_u8, a.xy_i16), (b.hit_u8, b.xy_i16))
        np.testing.assert_allclose(a.labels, b.labels, atol=1e-3)
