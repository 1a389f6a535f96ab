"""The port's command line (``python -m osu_dreamer_tpu_torch <command>``).

Counterpart of osu_dreamer_tpu/cli/commands.py for the commands ported so
far: ``generate-data``, ``fit-latent``, ``encode-latents``, ``fit-denoiser``,
``fit-style``, ``export-inference`` and ``predict``. argparse keeps the port
free of click; ``generate-data`` prints a count of the maps written where the
JAX package shows a tqdm bar.
"""

from __future__ import annotations

import argparse
import os
import random
from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np

# predict's --diff when none is given: (sr, ar, od, cs, hp)
DEFAULT_DIFF = ((5.0, 9.0, 8.0, 4.0, 6.0),)


def _existing(path: str) -> Path:
    p = Path(path)
    if not p.exists():
        raise argparse.ArgumentTypeError(f"{path} does not exist")
    return p


def _existing_file(path: str) -> Path:
    p = _existing(path)
    if not p.is_file():
        raise argparse.ArgumentTypeError(f"{path} is not a file")
    return p


def _existing_dir(path: str) -> Path:
    p = _existing(path)
    if not p.is_dir():
        raise argparse.ArgumentTypeError(f"{path} is not a directory")
    return p


def _at_least(low: int):
    def parse(text: str) -> int:
        value = int(text)
        if value < low:
            raise argparse.ArgumentTypeError(f"{value} is less than {low}")
        return value

    return parse


class PredictedSong(NamedTuple):
    """one song's mapset and the quantized chart its .osu files were decoded
    from: rows (D, out_frames, ...) song-major as the sampler returns them,
    of which the first ``frames`` are the song's"""

    osz: Path
    audio_file: Path
    title: str
    artist: str
    frames: int
    hit_u8: np.ndarray  # (D, out_frames, 7) uint8
    xy_i16: np.ndarray  # (D, out_frames, 2) int16
    labels: np.ndarray  # (D, 5) float32


def run_predict(
    model,
    audio_files: Sequence[str | Path],
    diff: Sequence[Sequence[float]] = DEFAULT_DIFF,
    sample_steps: int = 8,
    style_guidance: float = 1.0,
    title: str | None = None,
    artist: str | None = None,
    seed: int | None = None,
    infer_tempo: bool = False,
    snap_divisor: int = 0,
    serialize_workers: int | None = None,
    batch_songs: int = 1,
    device="cuda",
    devices=None,
) -> list[PredictedSong]:
    """generate osu!std beatmaps from audio with ``model`` (an ``LDM`` on
    ``device``) -> one .osz mapset per song, written to the working
    directory, in the order of ``audio_files``.

    Songs of one (n_frames, out_frames) bucket are sampled ``batch_songs``
    at a time, each batch from ``torch.Generator(device)`` seeded with
    ``seed + batch index`` (``seed`` drawn at random when None). A partial
    batch runs as it is: nothing is compiled per batch size here, so padding
    it as the JAX version does would only waste rows. The device never waits
    on the host: each wave is uploaded from pinned memory as it is prepared,
    the quantized chart's copies to pinned host buffers start as soon as its
    batch is dispatched, and the host waits on that batch's CUDA event only
    when it has dispatched the next.

    With more than one replica device and ``batch_songs`` > 1, each batch's
    songs are sharded over model replicas by the JAX rule: ``n_dev =
    min(devices, batch_songs)``, ``batch_songs`` rounded down to a multiple
    of it, and a ``[parallel]`` line says so
    (models/inference/sampler.py ``build_sharded_sampler``: a seeded shard
    gives the one-device chart of its rows). ``devices`` lists the replicas' devices:
    by default every visible card on the card and none besides ``device``
    off it; a list may repeat a device, so that one card or the CPU runs
    the sharded path. The .osu decoding (peak picking, the
    MAP slider fit, text) fans out over ``serialize_workers`` spawned
    processes (default up to 4; 1 decodes in this process). With
    ``OSU_DREAMER_TIMING`` set, turns the spans of train/profiling.py on
    and prints two lines from their host totals: the predict phases
    (``[timing] host-phase totals:``) and the sampler's stages (``[timing]
    sampler host issue:``, the host's enqueue; the card runs behind it)."""
    from collections import deque
    from contextlib import nullcontext

    import torch

    from . import native
    from .audio.constants import HOP_LEN
    from .audio.decode import load_wave
    from .audio.spectrogram import prep_wave_for_model
    from .models.inference.sampler import (
        STAGES, build_batch_sampler, build_sharded_sampler, dequantize_chart, gather_shards,
    )
    from .parallel.replicas import replica_devices, replicate
    from .signal.serialize import decode_osu_entry
    from .train import profiling
    from .train.profiling import span
    from .utils.device import resolve_device
    from .utils.procpool import spawn_serialize_pool

    device = resolve_device(device, "predict")
    model_device = next(model.parameters()).device
    if model_device.type != device.type:
        raise ValueError(f"the model is on {model_device}, not {device}")
    audio_files = [Path(f) for f in audio_files]
    if len(audio_files) > 1 and (title or artist):
        raise ValueError("--title/--artist only apply to a single audio file")
    cuda = device.type == "cuda"
    chunk = model.args.latent.chunk_size
    labels = torch.tensor(diff, dtype=torch.float32, device=device)
    D = labels.shape[0]
    base_seed = seed if seed is not None else random.randrange(2**31)

    n_osus = len(audio_files) * D
    if serialize_workers is None:
        serialize_workers = min(4, os.cpu_count() or 1, n_osus)
    # build the fitter's library now, before the workers look for it
    native.available()
    pool = None
    if n_osus > 1 and serialize_workers > 1:
        pool = spawn_serialize_pool(serialize_workers)
    batch_songs = min(batch_songs, len(audio_files))
    if devices is None:
        devices = replica_devices(torch.cuda.device_count()) if cuda else [device]
    sample, sharded = build_batch_sampler(model), None
    if len(devices) > 1 and batch_songs > 1:
        # the JAX rule: at most batch_songs devices, the batch rounded down
        # to a multiple of the devices used
        n_dev = min(len(devices), batch_songs)
        batch_songs -= batch_songs % n_dev
        sharded = build_sharded_sampler(replicate(model, devices[:n_dev]))
        print(f"[parallel] sharding {batch_songs}-song batches over {n_dev} "
              f"of {len(devices)} devices")

    done: list[PredictedSong] = []
    queued: deque = deque()  # (PredictedSong without its .osz, [async results])

    def write(song: PredictedSong, entries) -> None:
        done.append(song._replace(osz=_write_mapset(song.audio_file, song.title, song.artist,
                                                    entries)))

    def enqueue(song: PredictedSong, chart: np.ndarray) -> None:
        signals = chart[:, : song.frames].transpose(0, 2, 1)
        jobs = [
            (song.title, song.artist, song.audio_file.name, i, row, sig, infer_tempo,
             snap_divisor)
            for i, (row, sig) in enumerate(zip(song.labels, signals))
        ]
        if pool is None:
            with span("predict.decode"):
                entries = [decode_osu_entry(*j) for j in jobs]
            with span("predict.zip"):
                write(song, entries)
        else:
            queued.append((song, [pool.apply_async(decode_osu_entry, j) for j in jobs]))

    def flush(block: bool) -> None:
        while queued and (block or all(r.ready() for r in queued[0][1])):
            song, results = queued.popleft()
            write(song, [r.get() for r in results])

    def dispatch(batch: list, batch_i: int):
        """batch: (audio_file, title, artist, frames, wave, real_frames,
        n_frames, out_frames) entries of one bucket, their wave and
        real_frames already on the device (on the host when sharded) -> the
        batch, the quantized chart and labels (on the host once ``ready``
        has happened), ``ready``; sharded: the batch, its shards, None"""
        n_frames, out_frames = batch[0][6], batch[0][7]
        waves = torch.stack([e[4] for e in batch])
        real = torch.cat([e[5] for e in batch])
        if sharded is not None:
            return batch, sharded(waves, real, labels.cpu(), base_seed + batch_i, n_frames,
                                  out_frames, sample_steps, style_guidance), None
        generator = torch.Generator(device).manual_seed(base_seed + batch_i)
        out = sample(waves, real, labels, generator, n_frames, out_frames, sample_steps,
                     style_guidance)
        if not cuda:
            return batch, out, None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
            t, non_blocking=True) for t in out)
        ready = torch.cuda.Event()
        ready.record()
        return batch, host, ready

    def enqueue_batch(batch: list, out, ready) -> None:
        with span("predict.fetch"):
            if sharded is not None:
                hit_u8, xy_i16, pred = gather_shards(out)
            else:
                if ready is not None:
                    ready.synchronize()
                hit_u8, xy_i16, pred = out[0].numpy(), out[1].numpy(), out[2].float().numpy()
            chart = dequantize_chart(hit_u8, xy_i16)
        for s, (audio_file, s_title, s_artist, frames, *_rest) in enumerate(batch):
            rows = slice(s * D, (s + 1) * D)
            enqueue(PredictedSong(None, audio_file, s_title, s_artist, frames, hit_u8[rows],
                                  xy_i16[rows], pred[rows]), chart[rows])

    def sample_batch(batch: list, batch_i: int, pending):
        print(f"  sampling {len(batch)} song(s) x {D} difficulties at {sample_steps} steps...")
        with span("predict.upload_dispatch"):
            out = dispatch(batch, batch_i)
        if pending is not None:
            enqueue_batch(*pending)  # overlaps the device's work on this batch
            flush(block=False)
        return out

    timing = bool(os.environ.get("OSU_DREAMER_TIMING"))
    spans_were_on = profiling.enable() if timing else False
    before = profiling.totals()
    try:
        with pool or nullcontext():
            pending = None
            batch: list = []
            batch_i = 0
            for i, audio_file in enumerate(audio_files):
                song_title, song_artist = _resolve_metadata(audio_file, title, artist)
                print(f"[{i + 1}/{len(audio_files)}] {audio_file.name}: featurizing...")
                with span("predict.load_wave"):
                    wave = load_wave(audio_file)
                frames = max(1, -(-len(wave) // HOP_LEN))
                with span("predict.prep"):
                    buf, real_frames, n_frames, out_frames = prep_wave_for_model(wave, chunk)
                    wave_t, real_t = torch.from_numpy(buf), torch.tensor([real_frames])
                    if cuda and sharded is None:
                        # the transfers run while the host decodes the last batch
                        wave_t = wave_t.pin_memory().to(device, non_blocking=True)
                        real_t = real_t.pin_memory().to(device, non_blocking=True)
                entry = (audio_file, song_title, song_artist, frames, wave_t, real_t, n_frames,
                         out_frames)
                # a bucket change or a full batch sends the current one
                if batch and (len(batch) == batch_songs
                              or (batch[0][6], batch[0][7]) != (n_frames, out_frames)):
                    pending = sample_batch(batch, batch_i, pending)
                    batch_i += 1
                    batch = []
                batch.append(entry)
            if batch:
                pending = sample_batch(batch, batch_i, pending)
            if pending is not None:
                enqueue_batch(*pending)
            flush(block=True)
    finally:
        profiling.enable(spans_were_on)
    if sharded is not None:
        sharded.close()
    if timing:
        spent = {k: (n - before.get(k, (0, 0))[0], ns - before.get(k, (0, 0))[1])
                 for k, (n, ns) in profiling.totals().items()}
        phases = {k.removeprefix("predict."): ns / 1e6 for k, (n, ns) in sorted(spent.items())
                  if n and k.startswith("predict.")}
        parts = " ".join(f"{k}={v:.0f}ms" for k, v in phases.items())
        print(f"[timing] host-phase totals: {parts} (sum {sum(phases.values()):.0f}ms;"
              " device compute overlaps upload_dispatch/fetch waits)")
        stages = " ".join(f"{k}={spent[k][1] / 1e6:.0f}ms" for k in STAGES
                          if spent.get(k, (0, 0))[0])
        print(f"[timing] sampler host issue: {stages} (enqueue time; the card runs behind it)")
    return done


def _write_mapset(audio_file: Path, title: str, artist: str, entries) -> Path:
    from zipfile import ZipFile

    hex_chars = "0123456789abcdef"
    while True:
        tag = "".join(random.choice(hex_chars) for _ in range(7))
        mapset = Path(f"_{tag} {artist} - {title}.osz")
        if not mapset.exists():
            break

    with ZipFile(mapset, "x") as archive:
        archive.write(audio_file, audio_file.name)
        for name, text in entries:
            archive.writestr(name, text)
    print(f"  wrote {mapset}")
    return mapset.resolve()


def _resolve_metadata(audio_file: Path, title: str | None, artist: str | None):
    """fill a missing title or artist from the audio's container tags: the
    libav shim (ID3/Vorbis/MP4 via native/audiodecode_av.cpp) first, tinytag
    if importable, then the file name and "Unknown Artist\""""
    if title is None or artist is None:
        from . import native

        if native.av_available():
            t, a = native.av_tags(audio_file)
            title = title or (t or None)
            artist = artist or (a or None)
    if title is None or artist is None:
        try:
            from tinytag import TinyTag

            tags = TinyTag.get(audio_file)
            title = title or tags.title
            artist = artist or tags.artist
        except ImportError:
            pass
    if not title:
        title = audio_file.stem
    if not artist:
        artist = "Unknown Artist"
    return title, artist


def generate_data(data_dir: Path, num_workers: int = 2, force: bool = False,
                  songs_dir: Path | None = None, device="cuda") -> int:
    """build the training dataset from a local library (``songs_dir``) or
    the HF stream, printing a running count -> maps written"""
    from .data.ingest import build_dataset

    n = 0
    for n, _ in enumerate(build_dataset(data_dir, num_workers, force, songs_dir, device=device),
                          start=1):
        if n % 100 == 0:
            print(f"  {n} maps written", flush=True)
    print(f"wrote {n} maps to {data_dir}")
    return n


def main(argv: list[str] | None = None) -> None:
    from .models.diffusion.fit import CONFIG as DENOISER_CONFIG
    from .models.latent.fit import CONFIG as LATENT_CONFIG
    from .models.style.fit import CONFIG as STYLE_CONFIG

    parser = argparse.ArgumentParser(prog="osu_dreamer_tpu_torch")
    commands = parser.add_subparsers(dest="command", required=True)
    device_help = "torch device (default cuda; the CPU only when asked for)"
    gen = commands.add_parser(
        "generate-data", help="build the training dataset (a local mapset library with "
                              "--songs-dir, else the HF beatmap corpus stream)")
    gen.add_argument("--data-dir", type=Path, default=Path("./data"),
                     help="output directory for pre-processed training samples")
    gen.add_argument("--num-workers", type=_at_least(1), default=2,
                     help="host worker threads for beatmap parsing/encoding")
    gen.add_argument("--force", action="store_true", help="overwrite existing pre-processed maps")
    gen.add_argument("--songs-dir", type=_existing_dir, default=None,
                     help="ingest a local library (.osz archives / osu! Songs folders) instead "
                          "of streaming the HF corpus")
    gen.add_argument("--device", default="cuda", help=device_help)
    for name, config, text in (("fit-latent", LATENT_CONFIG, "train the stage-1 chart autoencoder"),
                               ("fit-denoiser", DENOISER_CONFIG,
                                "train the stage-2 latent denoiser"),
                               ("fit-style", STYLE_CONFIG, "train the stage-3 style prior")):
        cmd = commands.add_parser(name, help=text)
        cmd.add_argument("-c", "--config", type=_existing, default=config,
                         help="training config file")
        cmd.add_argument("--ckpt-path", type=_existing, default=None,
                         help="checkpoint to resume from")
        cmd.add_argument("--device", default="cuda", help=device_help)
    encode = commands.add_parser(
        "encode-latents", help="cache the latent encodings (h, z, s, labels) for stages 2 and 3")
    encode.add_argument("--latent-ckpt-path", type=_existing, default=Path("runs/latent/best"),
                        help="fit-latent checkpoint directory")
    encode.add_argument("--data-dir", type=_existing, default=Path("./data"),
                        help="pre-processed dataset directory")
    encode.add_argument("--force", action="store_true", help="overwrite existing cached latents")
    encode.add_argument("--device", default="cuda", help=device_help)

    export = commands.add_parser(
        "export-inference", help="merge the three training checkpoints into one inference "
                                 "artifact")
    for stage in ("latent", "denoiser", "style"):
        export.add_argument(f"--{stage}-ckpt-path", type=_existing,
                            default=Path(f"runs/{stage}/best"), help=f"{stage} checkpoint")
    export.add_argument("--output-path", type=Path, default=Path("inference.odt"),
                        help="artifact output path")
    export.add_argument("--half", action="store_true",
                        help="store bf16 weights (half the size; the card computes in bf16)")
    export.add_argument("--device", default="cuda", help=device_help)

    predict = commands.add_parser(
        "predict", help="generate osu!std beatmaps from audio: one .osz mapset per song")
    predict.add_argument("--model-path", type=_existing_file, required=True,
                         help="inference artifact (.odt)")
    predict.add_argument("--audio-file", dest="audio_files", type=_existing_file,
                         action="append", required=True,
                         help="audio file to map; repeatable for bulk generation")
    predict.add_argument("--diff", type=float, nargs=5, action="append",
                         metavar=("SR", "AR", "OD", "CS", "HP"),
                         help="difficulty conditioning; repeatable (default 5 9 8 4 6)")
    predict.add_argument("--sample-steps", type=int, default=8, help="number of diffusion steps")
    predict.add_argument("--style-guidance", type=float, default=1.0,
                         help="classifier-free guidance over the style prior's null labels; "
                              "1.0 is plain conditional sampling")
    predict.add_argument("--title", help="song title (read from audio tags when omitted; "
                                         "single audio file only)")
    predict.add_argument("--artist", help="song artist (read from audio tags when omitted; "
                                          "single audio file only)")
    predict.add_argument("--seed", type=int, default=None,
                         help="sampling seed (default: random)")
    predict.add_argument("--infer-tempo", action="store_true",
                         help="estimate BPM and offset from the predicted onsets")
    predict.add_argument("--snap-divisor", type=_at_least(0), default=0,
                         help="snap hit times to 1/N of the inferred beat; implies "
                              "--infer-tempo. 0 = off")
    predict.add_argument("--serialize-workers", type=_at_least(1), default=None,
                         help="processes decoding .osu files (default: up to 4; "
                              "1 = in-process)")
    predict.add_argument("--batch-songs", type=_at_least(1), default=1,
                         help="songs of one length class sampled together; sharded over "
                              "the visible cards, one model replica each")
    predict.add_argument("--device", default="cuda", help=device_help)

    serve = commands.add_parser(
        "serve", help="run a resident map-generation HTTP service (POST /generate)")
    serve.add_argument("--model-path", type=_existing_file, required=True,
                       help="trained inference artifact (export-inference output)")
    serve.add_argument("--host", default="127.0.0.1", help="bind address")
    serve.add_argument("--port", type=int, default=8787, help="bind port")
    serve.add_argument("--max-batch", type=_at_least(1), default=4,
                       help="max concurrent songs batched into one device dispatch")
    serve.add_argument("--batch-window-ms", type=float, default=25.0,
                       help="how long the dispatcher waits to widen a batch")
    serve.add_argument("--infer-tempo", action="store_true",
                       help="infer real timing points from the predicted onset envelope")
    serve.add_argument("--snap-divisor", type=_at_least(0), default=0,
                       help="snap hit times to 1/N of the inferred beat; implies "
                            "--infer-tempo. 0 = off")
    serve.add_argument("--devices", type=_at_least(1), default=None,
                       help="cards to spread request batches over (default: all)")
    serve.add_argument("--serialize-workers", type=_at_least(1), default=None,
                       help=".osu-decode worker processes (default: one per core, up to "
                            "4; 1 disables the pool)")
    serve.add_argument("--device", default="cuda", help=device_help)
    args = parser.parse_args(argv)

    if args.command == "serve":
        from .serve import GeneratorService, MapServer

        service = GeneratorService(
            args.model_path, max_batch=args.max_batch, batch_window_ms=args.batch_window_ms,
            infer_tempo=args.infer_tempo, snap_divisor=args.snap_divisor, devices=args.devices,
            serialize_workers=args.serialize_workers, device=args.device)
        server = MapServer(service, host=args.host, port=args.port)
        bound_host, bound_port = server.address
        print(f"serving on http://{bound_host}:{bound_port} (POST /generate, GET /healthz /stats)",
              flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            print("shutting down")
        finally:
            server.close()
        return

    if args.command == "predict":
        from .models.inference.artifact import load_inference

        run_predict(load_inference(args.model_path, args.device), args.audio_files,
                    args.diff or DEFAULT_DIFF, args.sample_steps, args.style_guidance,
                    args.title, args.artist, args.seed, args.infer_tempo, args.snap_divisor,
                    args.serialize_workers, args.batch_songs, args.device)
        return
    if args.command == "encode-latents":
        from .models.latent.encode import encode_latents

        n = encode_latents(args.latent_ckpt_path, args.data_dir, args.force, args.device)
        print(f"encoded {n} maps")
        return
    if args.command == "generate-data":
        generate_data(args.data_dir, args.num_workers, args.force, args.songs_dir, args.device)
        return
    if args.command == "export-inference":
        from .models.inference.artifact import save_inference

        save_inference(args.latent_ckpt_path, args.denoiser_ckpt_path, args.style_ckpt_path,
                       args.output_path, half=args.half, device=args.device)
        print(f"wrote {args.output_path}")
        return
    if args.command == "fit-latent":
        from .models.latent.fit import run
    elif args.command == "fit-denoiser":
        from .models.diffusion.fit import run
    else:
        from .models.style.fit import run
    run(args.config, str(args.ckpt_path) if args.ckpt_path else None, args.device)
