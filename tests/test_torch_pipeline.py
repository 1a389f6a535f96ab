"""The port's whole training pipeline on the CPU, from audio to a .osz, as
tests/test_end_to_end.py drives the JAX package (its ``TINY_*_CFG``):

``build_library`` -> ``generate-data --songs-dir`` -> ``fit-latent`` ->
``encode-latents`` -> ``fit-denoiser`` -> ``fit-style`` ->
``export-inference`` -> ``predict``, every command through the port's CLI
with ``--device cpu``. Models are tiny and runs a few steps: structure is
asserted, not quality. The denoiser runs the JAX tiny config as it is: its
2 x 8 heads (H D 16) are outside the fused attention's gate, so it trains
through the long attention, as the JAX package does. The .osz must hold the
WAV and one .osu a row,
each carrying the .osu sections and parsing with the port's ``Beatmap``,
or failing only as tests/test_end_to_end.py allows: a hold of barely
trained weights can span the next onset, which the strict parser refuses
(the reference serializer has the same property).
"""

from __future__ import annotations

import json
import os
import zipfile
from pathlib import Path

import numpy as np
import torch

from test_end_to_end import TINY_DIFFUSION_CFG, TINY_LATENT_CFG, TINY_STYLE_CFG

torch.set_num_threads(1)

N_MAPSETS = 4
SECONDS = 12.0


def _config(tmp: Path, name: str, cfg: dict, data_dir: Path, run_dir: Path) -> Path:
    """``cfg`` with its data and run directories, as a JSON file (JSON is
    YAML)"""
    cfg = {**cfg, "data": {**cfg["data"], "data_dir": str(data_dir)},
           "fit": {**cfg["fit"], "run_dir": str(run_dir), "save_last_every_s": 0.0}}
    path = tmp / f"{name}.yml"
    path.write_text(json.dumps(cfg))
    return path


def test_pipeline_from_audio_to_osz(tmp_path, capsys):
    from osu_dreamer_tpu_torch.cli import main
    from osu_dreamer_tpu_torch.data.synth import DIFFS_PER_MAPSET, build_library
    from osu_dreamer_tpu_torch.osu import Beatmap, BeatmapParseError

    songs, data, runs = tmp_path / "Songs", tmp_path / "data", tmp_path / "runs"
    build_library(songs, N_MAPSETS, seconds=SECONDS, seed=0)

    main(["generate-data", "--data-dir", str(data), "--songs-dir", str(songs),
          "--device", "cpu"])
    assert f"wrote {N_MAPSETS * DIFFS_PER_MAPSET} maps" in capsys.readouterr().out
    assert len(list(data.glob("*/spec.npy"))) == N_MAPSETS

    main(["fit-latent", "-c", str(_config(tmp_path, "latent", TINY_LATENT_CFG, data,
                                          runs / "latent")), "--device", "cpu"])
    main(["encode-latents", "--latent-ckpt-path", str(runs / "latent" / "best"),
          "--data-dir", str(data), "--device", "cpu"])
    assert len(list(data.rglob("*.latent.npz"))) == N_MAPSETS * DIFFS_PER_MAPSET
    main(["fit-denoiser", "-c", str(_config(tmp_path, "diff", TINY_DIFFUSION_CFG, data,
                                            runs / "denoiser")), "--device", "cpu"])
    main(["fit-style", "-c", str(_config(tmp_path, "style", TINY_STYLE_CFG, data,
                                         runs / "style")), "--device", "cpu"])
    out = capsys.readouterr().out
    for stage, cfg in (("latent", TINY_LATENT_CFG), ("denoiser", TINY_DIFFUSION_CFG),
                       ("style", TINY_STYLE_CFG)):
        assert f"[{stage}] epoch 0" in out and f"{cfg['fit']['monitor']}=" in out, stage
        for ckpt in ("best", "last"):
            assert (runs / stage / ckpt / "state.pt").exists(), (stage, ckpt)

    artifact = tmp_path / "inference.odt"
    main(["export-inference", "--latent-ckpt-path", str(runs / "latent" / "best"),
          "--denoiser-ckpt-path", str(runs / "denoiser" / "best"),
          "--style-ckpt-path", str(runs / "style" / "best"), "--output-path", str(artifact),
          "--device", "cpu"])
    assert artifact.exists()

    song = sorted(songs.iterdir())[0] / "audio.wav"
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        main(["predict", "--model-path", str(artifact), "--audio-file", str(song),
              "--diff", "5", "9", "8", "4", "6", "--diff", "3", "7", "6", "3", "5",
              "--sample-steps", "2", "--seed", "0", "--serialize-workers", "1",
              "--device", "cpu"])
    finally:
        os.chdir(cwd)
    (osz,) = tmp_path.glob("*.osz")
    with zipfile.ZipFile(osz) as z:
        names = z.namelist()
        texts = [z.read(n).decode() for n in names if n.endswith(".osu")]
    assert "audio.wav" in names and len(texts) == 2
    for text in texts:
        for section in ("[General]", "[Metadata]", "[Difficulty]", "[TimingPoints]",
                        "[HitObjects]"):
            assert section in text
        try:
            bm = Beatmap(text)
        except BeatmapParseError as e:
            assert "starts before previous hit object ends" in str(e), e
        else:
            assert np.isfinite([bm.ar, bm.od, bm.cs, bm.hp]).all()
