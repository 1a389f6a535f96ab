"""The port's serving subsystem on the CPU (``device="cpu"``): the resident
``GeneratorService`` and its HTTP front end, against the JAX package's.

With a tiny artifact (the LDMArgs of tests/test_torch_import_guard.py,
seeded random weights from the port's ``init_random``, written by the JAX
``build_artifact_bytes``), 1.5-2 s sine WAVs and 2 sampling steps — structure,
not quality:

- the cases of tests/test_serve.py on the port: one blocking generate, a
  seeded request reproducible byte for byte, concurrent same-signature
  requests sharing a dispatch (``batches < requests``) while other
  difficulty counts never ride along, several difficulties, bad diffs and
  unbounded work refused, close() failing stranded requests, and the HTTP
  surface over a real socket (healthz, stats, generate, snap divisor,
  hostile names, bad requests), the decode pool equal to inline decode;
- the host code copied from the JAX service pinned to it: the name
  sanitisers over the same hostile inputs, the bounds, and every bad request
  answered with the JAX server's status code;
- the whole host path held to the JAX service: each service's ``_sample``
  replaced by one returning the same quantized chart, the same request gives
  the same .osz filename, entry names and .osu texts from both (the numpy
  fitter and WAV parser on both sides);
- the device rule: the default device raises without a card, and the CLI
  ``serve`` passes every option through;
- several cards: the JAX service's clamp (every visible card by default,
  at most ``max_batch``, ``max_batch`` rounded up to a multiple), and the
  service on two CPU replicas (one device listed twice): ``/healthz``
  reports them, a dispatch's songs split over them, and a seeded request
  gives the one-device service's .osu texts.
"""

from __future__ import annotations

import concurrent.futures as cf
import io
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import wave
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

STEPS = 2
TINY = {
    "latent": {"emb_dim": 4, "style_dim": 8, "n_downs": 2, "h_dim": 16,
               "stack": {"n_layers": 1, "expand": 2, "radius": 1}},
    "style": {"style_dim": 8, "label_features": 16, "h_dim": 16, "depth": 1, "expand": 2},
    "diffusion": {"emb_dim": 4, "a_dim": 16, "style_dim": 8, "global_cond_dim": 16,
                  "backbone_dim": 16, "u_head_dim": 8,
                  "backbone": {"depth": 1, "expand": 2, "head_dim": 8, "n_heads": 2,
                               "radius": 1}},
}


@pytest.fixture(scope="module")
def odt(tmp_path_factory) -> Path:
    """the tiny artifact: the port's seeded random weights as a flax tree of
    numpy leaves, written by the JAX ``build_artifact_bytes`` (flax's own
    init of the model would take most of this file's time)"""
    from osu_dreamer_tpu.models.inference.artifact import build_artifact_bytes
    from osu_dreamer_tpu.models.inference.model import LDMArgs as JArgs
    from osu_dreamer_tpu.utils import dataclass_from_dict as jfrom_dict
    from osu_dreamer_tpu_torch.models.inference.artifact import init_random, to_flax_params
    from osu_dreamer_tpu_torch.models.inference.model import LDMArgs
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict

    model = init_random(dataclass_from_dict(LDMArgs, TINY), torch.Generator().manual_seed(0),
                        "cpu")

    def numpy_tree(node):
        if isinstance(node, dict):
            return {k: numpy_tree(v) for k, v in node.items()}
        return node.numpy()

    path = tmp_path_factory.mktemp("artifact") / "inference.odt"
    path.write_bytes(build_artifact_bytes(jfrom_dict(JArgs, TINY),
                                          numpy_tree(to_flax_params(model))))
    return path


def _wav_bytes(tmp_path: Path, seconds: float, freq: float = 220.0) -> bytes:
    """a mono 16-bit WAV of a sine at the model's rate"""
    from osu_dreamer_tpu_torch.audio.constants import SR

    t = np.arange(int(SR * seconds)) / SR
    path = tmp_path / f"w{freq:.0f}_{seconds:.2f}.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(np.round(np.sin(2 * np.pi * freq * t) * 0.5 * 32767).astype("<i2")
                      .tobytes())
    return path.read_bytes()


def _check_osz(name: str, data: bytes, n_osu: int, audio_name: str = "audio.wav") -> str:
    assert name.endswith(".osz")
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        names = z.namelist()
        assert audio_name in names
        osu = [n for n in names if n.endswith(".osu")]
        assert len(osu) == n_osu
        text = z.read(osu[0]).decode()
    for section in ("[General]", "[Metadata]", "[TimingPoints]", "[HitObjects]"):
        assert section in text
    return text


def _entries(data: bytes) -> dict[str, bytes]:
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        return {n: z.read(n) for n in z.namelist()}


def _wait_for(condition, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not condition():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.005)


def _service(odt, **kw):
    from osu_dreamer_tpu_torch.serve import GeneratorService

    return GeneratorService(odt, **{"device": "cpu", "serialize_workers": 1, **kw})


@pytest.fixture(scope="module")
def service(odt):
    svc = _service(odt, max_batch=4, batch_window_ms=150.0)
    yield svc
    svc.close()


# ------------------------------------------------------------- service ----


def test_single_generate(service, tmp_path):
    audio = _wav_bytes(tmp_path, 2.0)
    name, osz = service.generate(audio, sample_steps=STEPS, title="T", artist="A", seed=7)
    assert name == "A - T.osz"
    text = _check_osz(name, osz, 1)
    assert "Title:T" in text.replace(" ", "")
    stats = service.snapshot_stats()
    assert stats["requests"] >= 1 and stats["errors"] == 0 and stats["padded_rows"] == 0


def test_seeded_reproducible(service, tmp_path):
    audio = _wav_bytes(tmp_path, 2.0)
    kw = dict(sample_steps=STEPS, title="T", artist="A", seed=123)
    _, a = service.generate(audio, **kw)
    _, b = service.generate(audio, **kw)
    # identical byte-for-byte entries (zip metadata may differ)
    assert _entries(a) == _entries(b)


def test_concurrent_requests_batch(service, tmp_path):
    """same wave bucket + #diffs + steps -> one device dispatch; different
    diff VALUES per request still co-batch (per-song labels), a request with
    another number of rows never rides along"""
    audio = _wav_bytes(tmp_path, 2.0)
    before = service.snapshot_stats()
    diffs = [[(2.0, 5.0, 5.0, 3.0, 4.0)], [(5.0, 9.0, 8.0, 4.0, 6.0)],
             [(7.0, 10.0, 9.0, 4.5, 6.0)], [(5.0, 9.0, 8.0, 4.0, 6.0), (3.0, 7, 6, 3, 5)]]
    start = threading.Barrier(len(diffs))
    shapes = []  # (songs, rows) of each dispatch
    sample = service._sample

    def recorded(waves, real, labels, *rest):
        shapes.append(tuple(labels.shape[:2]))
        return sample(waves, real, labels, *rest)

    def go(d):
        start.wait()
        return service.generate(audio, diffs=d, sample_steps=STEPS)

    service._sample = recorded
    try:
        with cf.ThreadPoolExecutor(len(diffs)) as ex:
            results = list(ex.map(go, diffs))
    finally:
        service._sample = sample
    for (name, osz), d in zip(results, diffs):
        _check_osz(name, osz, len(d))
    after = service.snapshot_stats()
    assert after["requests"] - before["requests"] == 4
    assert after["batches"] - before["batches"] == len(shapes)
    assert after["batched_rows"] - before["batched_rows"] == 4 and after["padded_rows"] == 0
    one_row = [S for S, D in shapes if D == 1]
    assert sum(one_row) == 3 and (1, 2) in shapes and len(shapes) == len(one_row) + 1, shapes
    assert len(one_row) < 3, "concurrent same-signature requests did not co-batch"


def test_multi_diff(service, tmp_path):
    audio = _wav_bytes(tmp_path, 1.5)
    diffs = [(3.0, 7.0, 6.0, 3.0, 5.0), (6.0, 9.5, 8.5, 4.0, 6.0)]
    name, osz = service.generate(audio, diffs=diffs, sample_steps=STEPS, seed=1)
    _check_osz(name, osz, 2)


@pytest.mark.parametrize("diffs", [[(1.0, 2.0)], [(1.0, 2, 3, 4, 5)] * 17,
                                   [(1.0, float("nan"), 3, 4, 5)], [[[1.0] * 5]]],
                         ids=["short_row", "too_many", "nan", "rank3"])
def test_bad_diff_rejected(service, diffs):
    with pytest.raises(ValueError):
        service.generate(b"\0" * 64, diffs=diffs)


@pytest.mark.parametrize("kw", [
    {"sample_steps": 10**9}, {"sample_steps": 0}, {"style_guidance": float("nan")},
    {"style_guidance": float("inf")}, {"style_guidance": -1.0}, {"style_guidance": 51.0},
    {"snap_divisor": -1},
], ids=["steps_huge", "steps_zero", "guidance_nan", "guidance_inf", "guidance_neg",
        "guidance_big", "snap_negative"])
def test_work_bounds_rejected(service, kw):
    with pytest.raises(ValueError):
        service.generate(b"\0" * 64, **kw)


def test_close_fails_stranded_requests(odt):
    """a request enqueued around close() gets an error, not a 600 s hang
    (enqueue re-checks closed under the lock; close drains)"""
    svc = _service(odt, max_batch=2, batch_window_ms=10.0)
    svc.close()
    assert not svc._dispatcher.is_alive()
    with pytest.raises(RuntimeError):
        svc.generate(b"\0" * 64, sample_steps=STEPS, timeout=5.0)
    assert svc.health()["ok"] is False


def test_close_fails_queued_request(odt, tmp_path):
    """a request still queued when close() runs is failed by close itself"""
    svc = _service(odt, max_batch=1, batch_window_ms=1.0)
    gate = threading.Event()
    sample = svc._sample

    def held(*args):
        gate.wait(timeout=30)
        return sample(*args)

    svc._sample = held
    audio = _wav_bytes(tmp_path, 1.5)
    with cf.ThreadPoolExecutor(2) as ex:
        first = ex.submit(svc.generate, audio, sample_steps=STEPS)
        # the first request is enqueued, then taken into the held dispatch
        _wait_for(lambda: svc.snapshot_stats()["requests"] == 1
                  and svc.snapshot_stats()["queued"] == 0)
        second = ex.submit(svc.generate, audio, sample_steps=STEPS)
        _wait_for(lambda: svc.snapshot_stats()["queued"] == 1)
        closer = threading.Thread(target=svc.close)
        closer.start()
        with pytest.raises(RuntimeError, match="generation failed"):
            second.result(timeout=30)
        gate.set()
        _check_osz(*first.result(timeout=30), 1)
        closer.join(timeout=30)
        assert not closer.is_alive()


def test_device_failure_reported(odt, tmp_path):
    """a failing dispatch fails its waiters with RuntimeError and counts an
    error; the dispatcher keeps serving"""
    svc = _service(odt, max_batch=1)
    try:
        sample = svc._sample
        svc._sample = lambda *a: (_ for _ in ()).throw(RuntimeError("launch failed"))
        audio = _wav_bytes(tmp_path, 1.5)
        with pytest.raises(RuntimeError, match="generation failed") as e:
            svc.generate(audio, sample_steps=STEPS)
        assert "launch failed" in str(e.value.__cause__)
        assert svc.snapshot_stats()["errors"] == 1
        svc._sample = sample
        _check_osz(*svc.generate(audio, sample_steps=STEPS), 1)
    finally:
        svc.close()


def test_health_on_the_cpu(service):
    h = service.health()
    assert h["ok"] and h["backend"] == "cpu"
    assert h["devices"] == 1 and h["devices_visible"] == 1
    assert h["max_batch"] == 4 and h["serialize_workers"] == 1
    assert h["chunk"] == service.model.args.latent.chunk_size


# -------------------------------------------------------- device rule -----


def test_default_device_needs_a_card(odt):
    from osu_dreamer_tpu_torch.serve import GeneratorService

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device: pass device='cpu' to serve"):
        GeneratorService(odt)


def test_devices_clamped_on_one_device(odt):
    """any ``devices`` gives one device where one is visible, as the JAX
    clamp does"""
    svc = _service(odt, devices=8)
    try:
        assert svc.n_devices == 1 and svc.health()["devices"] == 1
    finally:
        svc.close()


def test_several_cards_refused(odt, monkeypatch):
    """several cards are no longer refused: with two cards visible
    (monkeypatched ``device_count``), ``devices`` unset or 2 serves on both,
    as the JAX service does, and nothing raises NotImplementedError"""
    from osu_dreamer_tpu_torch.serve import service as svc_mod

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    visible = torch.cuda.device_count()
    assert svc_mod.clamp_devices(None, visible, 4) == (2, 4)
    assert svc_mod.clamp_devices(2, visible, 4) == (2, 4)
    assert svc_mod.clamp_devices(2, visible, 3) == (2, 4)
    assert "NotImplementedError" not in Path(svc_mod.__file__).read_text()


@pytest.mark.parametrize("visible,devices,max_batch,want", [
    (8, None, 8, (8, 8)),   # tests/test_serve.py:206: every device of eight
    (8, None, 4, (4, 4)),   # clamped to max_batch
    (8, 3, 4, (3, 6)),      # max_batch rounded up to a multiple of the count
    (8, 3, 8, (3, 9)),
    (2, 8, 4, (2, 4)),      # at most the visible devices
    (2, None, 1, (1, 1)),   # max_batch 1: one device
    (1, None, 4, (1, 4)),   # one device: nothing changes
    (1, 4, 5, (1, 5)),
])
def test_devices_clamp_pins_the_jax_service(visible, devices, max_batch, want, monkeypatch):
    """the JAX ``GeneratorService``'s device clamp, copied: with
    ``device_count`` monkeypatched to ``visible`` cards"""
    from osu_dreamer_tpu_torch.serve.service import clamp_devices

    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    assert clamp_devices(devices, torch.cuda.device_count(), max_batch) == want


@pytest.fixture(scope="module")
def replica_service(odt):
    """the service on two CPU replicas, max_batch 3 (rounded up to 4)"""
    svc = _service(odt, max_batch=3, batch_window_ms=300.0, replica_devices=["cpu", "cpu"])
    yield svc
    svc.close()


def test_replicas_health(replica_service):
    h = replica_service.health()
    assert h["devices"] == 2 and h["devices_visible"] == 2 and h["max_batch"] == 4
    assert replica_service._sharded is not None and len(replica_service._sharded.devices) == 2


def test_replicas_healthz_over_http(replica_service):
    from osu_dreamer_tpu_torch.serve import MapServer

    server = MapServer(replica_service, host="127.0.0.1", port=0)
    server.start_background()
    try:
        host, port = server.address
        with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=10) as r:
            h = json.load(r)
        assert h["ok"] and h["devices"] == 2 and h["max_batch"] == 4
    finally:  # the module's service stays open
        server.httpd.shutdown()
        server.httpd.server_close()


def test_replicas_split_a_dispatch(replica_service, tmp_path):
    """concurrent same-signature requests share a dispatch whose songs are
    split over both replicas; each request gets its own rows back"""
    audio = _wav_bytes(tmp_path, 2.0)
    shards = []
    sharded = replica_service._sharded

    def recorded(*args):
        out = sharded(*args)
        shards.append([(s.songs.start, s.songs.stop) for s in out])
        return out

    recorded.devices, recorded.close = sharded.devices, sharded.close
    start = threading.Barrier(3)

    def go(i):
        start.wait()
        return replica_service.generate(audio, sample_steps=STEPS, title=f"t{i}")

    replica_service._sharded = recorded
    try:
        with cf.ThreadPoolExecutor(3) as ex:
            results = list(ex.map(go, range(3)))
    finally:
        replica_service._sharded = sharded
    for name, osz in results:
        _check_osz(name, osz, 1)
    assert sum(b - a for split in shards for a, b in split) == 3
    assert any(len(split) == 2 for split in shards), shards


def test_replicas_seeded_request_equals_one_device(odt, replica_service, tmp_path):
    """a seeded request (run solo) on the replicas gives the one-device
    service's .osu texts"""
    audio = _wav_bytes(tmp_path, 2.0, freq=330.0)
    kw = dict(sample_steps=STEPS, title="T", artist="A", seed=11,
              diffs=[(5.0, 9.0, 8.0, 4.0, 6.0), (3.0, 7.0, 6.0, 3.0, 5.0)])
    one = _service(odt, max_batch=3)
    try:
        _, want = one.generate(audio, **kw)
    finally:
        one.close()
    _, got = replica_service.generate(audio, **kw)
    assert _entries(got) == _entries(want)


# --------------------------------------------------------- pinned copies --


HOSTILE_NAMES = [
    "../../../../etc/passwd.wav", "..\\..\\windows\\evil.mp3", "song.WAV", 'we:ird"na me.ogg',
    "no_suffix", "", None, "..", ".", "a\x00b\r\n.flac", "track.exe", "/abs/path/x.opus",
    ".hidden.m4a", "名前.mp3",
]


@pytest.mark.parametrize("name", HOSTILE_NAMES)
def test_safe_entry_name_matches_jax(name):
    from osu_dreamer_tpu.serve.service import _safe_entry_name as jsafe
    from osu_dreamer_tpu_torch.serve.service import _safe_entry_name as tsafe

    out = tsafe(name)
    assert out == jsafe(name)
    assert "/" not in out and "\\" not in out and Path(out).stem not in ("", ".", "..")


HEADER_VALUES = ['A - x"\r\nSet-Cookie: pwn=1.osz', "Artist - Title.osz", "", '\\"', "  pad  ",
                 "\x07bell\x1b.osz", "名前 - 曲.osz"]


@pytest.mark.parametrize("value", HEADER_VALUES)
def test_header_safe_matches_jax(value):
    from osu_dreamer_tpu.serve.http import _header_safe as jsafe
    from osu_dreamer_tpu_torch.serve.http import _header_safe as tsafe

    out = tsafe(value)
    assert out == jsafe(value)
    assert '"' not in out and "\r" not in out and "\n" not in out


@pytest.mark.parametrize("module, name", [
    ("service", "DEFAULT_DIFF"), ("service", "MAX_SAMPLE_STEPS"), ("service", "MAX_DIFFS"),
    ("service", "_AUDIO_SUFFIXES"), ("http", "MAX_AUDIO_BYTES"),
])
def test_copied_bounds_match_jax(module, name):
    import importlib

    jax_mod = importlib.import_module(f"osu_dreamer_tpu.serve.{module}")
    port_mod = importlib.import_module(f"osu_dreamer_tpu_torch.serve.{module}")
    assert getattr(port_mod, name) == getattr(jax_mod, name)


# ----------------------------------------------------- host-path parity ---


def _fixed_chart(rows: int, frames: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """a seeded quantized chart: smooth hit channels with peaks past the
    decoder's thresholds, a wandering cursor, labels in range"""
    rng = np.random.default_rng(5)
    kernel = np.exp(-0.5 * (np.arange(-6, 7) / 2.0) ** 2)
    hit = np.stack([[np.convolve(rng.random(frames) ** 6, kernel / kernel.max(), "same")
                     for _ in range(7)] for _ in range(rows)]).transpose(0, 2, 1)
    hit_u8 = np.round(np.clip(hit, 0, 1) * 255).astype(np.uint8)
    xy = np.cumsum(rng.normal(0, 0.02, (rows, frames, 2)), axis=1)
    xy_i16 = np.round(np.clip(xy, -4, 4) * 8191).astype(np.int16)
    labels = rng.uniform(2, 8, (rows, 5)).astype(np.float32)
    return hit_u8, xy_i16, labels


@pytest.mark.parametrize("case", ["one_row", "two_rows_snapped"])
def test_host_path_matches_jax_service(odt, tmp_path, monkeypatch, case):
    """the JAX service and the port's on one artifact, each ``_sample``
    returning the same quantized chart: the same request gives the same
    .osz filename, entry names and entry bytes"""
    from osu_dreamer_tpu import native as jnative
    from osu_dreamer_tpu.serve import GeneratorService as JService
    from osu_dreamer_tpu_torch import native as tnative

    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    audio = _wav_bytes(tmp_path, 1.5, freq=330.0)
    kw = dict(sample_steps=STEPS, name="My Song.wav", title=None, artist="Mapper")
    if case == "two_rows_snapped":
        kw.update(diffs=[(3.0, 7.0, 6.0, 3.0, 5.0), (6.0, 9.5, 8.5, 4.0, 6.0)], snap_divisor=4)
    seen = {}

    def fake(make, jax_call):
        def sample(*args):
            # the JAX service passes its params first
            waves, _, labels, _, n_frames, out_frames, _, _ = args[1:] if jax_call else args
            rows = waves.shape[0] * labels.shape[1]
            seen[jax_call] = (rows, n_frames, out_frames)
            return tuple(make(a) for a in _fixed_chart(rows, out_frames))
        return sample

    jsvc = JService(odt, max_batch=2, batch_window_ms=5.0, serialize_workers=1)
    tsvc = _service(odt, max_batch=2, batch_window_ms=5.0)
    try:
        jsvc._sample = fake(np.asarray, True)
        tsvc._sample = fake(torch.from_numpy, False)
        name = kw.pop("name")
        jname, josz = jsvc.generate(audio, audio_name=name, **kw)
        tname, tosz = tsvc.generate(audio, audio_name=name, **kw)
    finally:
        jsvc.close()
        tsvc.close()
    assert seen[True] == seen[False]
    assert tname == jname == "Mapper - My Song.osz"
    t_entries, j_entries = _entries(tosz), _entries(josz)
    assert list(t_entries) == list(j_entries)
    assert sum(n.endswith(".osu") for n in t_entries) == len(kw.get("diffs", [0]))
    for n in j_entries:
        assert t_entries[n] == j_entries[n], n
        if n.endswith(".osu"):  # not vacuous: the chart decodes to hit objects
            assert t_entries[n].decode().split("[HitObjects]")[1].strip(), n


# ----------------------------------------------------------------- HTTP ---


@pytest.fixture(scope="module")
def server(odt):
    # its own service: MapServer.close() closes it
    from osu_dreamer_tpu_torch.serve import MapServer

    with MapServer(_service(odt, max_batch=2, batch_window_ms=10.0), port=0) as s:
        yield s


@pytest.fixture(scope="module")
def jax_server(odt):
    """the JAX package's server on the same artifact, for status codes only
    (no request below reaches its device)"""
    from osu_dreamer_tpu.serve import GeneratorService, MapServer

    with MapServer(GeneratorService(odt, max_batch=2, batch_window_ms=10.0,
                                    serialize_workers=1), port=0) as s:
        yield s


def _url(server, path: str) -> str:
    host, port = server.address
    return f"http://{host}:{port}{path}"


def _status(server, path: str, data: bytes | None) -> tuple[int, dict]:
    req = urllib.request.Request(_url(server, path), data=data,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, {}
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_healthz_and_stats(server):
    with urllib.request.urlopen(_url(server, "/healthz"), timeout=10) as r:
        h = json.load(r)
    assert h["ok"] and h["devices"] == 1 and h["backend"] == "cpu"
    with urllib.request.urlopen(_url(server, "/stats"), timeout=10) as r:
        s = json.load(r)
    assert {"requests", "batches", "batched_rows", "padded_rows", "errors",
            "compiled_signatures", "started_at", "queued"} <= set(s)


def test_generate_roundtrip(server, tmp_path):
    audio = _wav_bytes(tmp_path, 1.5, freq=330.0)
    url = _url(server, "/generate?sample_steps=2&seed=5&title=Net&artist=Srv"
                       "&diff=4,8,7,4,5&name=song.wav")
    req = urllib.request.Request(url, data=audio, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.status == 200
        disp = r.headers["Content-Disposition"]
        osz = r.read()
    assert 'filename="Srv - Net.osz"' in disp
    text = _check_osz("x.osz", osz, 1, audio_name="song.wav")
    assert "Title:Net" in text.replace(" ", "")


def test_generate_snap_divisor(server, tmp_path):
    """per-request ?snap_divisor=4 (service default off): every emitted hit
    time lands on the inferred timing point's quarter-beat grid"""
    audio = _wav_bytes(tmp_path, 2.0, freq=261.0)
    req = urllib.request.Request(
        _url(server, "/generate?sample_steps=2&seed=9&snap_divisor=4&name=s.wav"),
        data=audio, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        osz = r.read()
    text = _check_osz("x.osz", osz, 1, audio_name="s.wav")

    tp0 = text.split("[TimingPoints]")[1].strip().splitlines()[0]
    offset, beat_len = (float(v) for v in tp0.split(",")[:2])
    tick = beat_len / 4.0
    times = [int(line.split(",")[2])
             for line in text.split("[HitObjects]")[1].strip().splitlines() if line]
    for t in times:
        k = round((t - offset) / tick)
        assert abs(t - (offset + k * tick)) <= 1.0, (t, offset, tick)
    assert all(b > a for a, b in zip(times, times[1:])), times


BAD_REQUESTS = {
    "get_unknown_path": ("/nope", None, 404, "unknown path"),
    "post_unknown_path": ("/nope", b"x" * 64, 404, "unknown path"),
    "short_diff": ("/generate?diff=1,2", b"x" * 64, 400, "diff"),
    "empty_body": ("/generate", b"", 400, "Content-Length"),
    "negative_snap": ("/generate?snap_divisor=-1", b"x" * 64, 400, "snap_divisor"),
    "huge_steps": ("/generate?sample_steps=100000000", b"x" * 64, 400, "sample_steps"),
    "inf_guidance": ("/generate?style_guidance=inf", b"x" * 64, 400, "style_guidance"),
    "too_many_diffs": ("/generate?diff=" + "&diff=".join(["1,2,3,4,5"] * 17), b"x" * 64, 400,
                       "diff rows"),
    "steps_not_int": ("/generate?sample_steps=abc", b"x" * 64, 400, "abc"),
    "seed_not_int": ("/generate?seed=abc", b"x" * 64, 400, "abc"),
    "undecodable_audio": ("/generate?name=clip.mp3", b"x" * 64, 400, ""),
}


@pytest.mark.parametrize("case", list(BAD_REQUESTS))
def test_bad_requests_match_jax(server, jax_server, case):
    """each bad request gets its status code from both servers, the JAX
    package's and the port's: 404 for an unknown path, 400 for bad
    parameters or bytes (an undecodable upload: AudioDecodeError)"""
    path, body, code, needle = BAD_REQUESTS[case]
    got, payload = _status(server, path, body)
    assert got == code and needle in payload["error"], payload
    assert _status(jax_server, path, body)[0] == got


def test_hostile_names_sanitized(server, tmp_path):
    """zip-slip audio names and CRLF titles must not reach the zip entries
    or the response headers"""
    audio = _wav_bytes(tmp_path, 1.0, freq=440.0)
    name = urllib.parse.quote("../../../../etc/passwd.wav")
    title = urllib.parse.quote('x"\r\nSet-Cookie: pwn=1')
    url = _url(server, f"/generate?sample_steps=2&seed=3&name={name}&title={title}&artist=a")
    req = urllib.request.Request(url, data=audio, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        disp = r.headers["Content-Disposition"]
        osz = r.read()
    assert "\r" not in disp and "\n" not in disp
    assert disp.count('"') == 2
    with zipfile.ZipFile(io.BytesIO(osz)) as z:
        for n in z.namelist():
            assert ".." not in n and not n.startswith("/"), n


# ------------------------------------------------------- decode pool ------


def test_pool_decode_matches_inline(odt, tmp_path):
    """the .osu-decode worker pool (serialize_workers >= 2) gives the same
    entries as inline decode (seeded request, byte equality)"""
    audio = _wav_bytes(tmp_path, 2.0)
    kw = dict(sample_steps=STEPS, title="T", artist="A", seed=99)
    inline = _service(odt, max_batch=1, batch_window_ms=5.0)
    try:
        _, a = inline.generate(audio, **kw)
        assert inline.serialize_workers == 1
    finally:
        inline.close()
    pooled = _service(odt, max_batch=1, batch_window_ms=5.0, serialize_workers=2)
    try:
        assert pooled.serialize_workers == 2
        assert pooled.health()["serialize_workers"] == 2
        _, b = pooled.generate(audio, **kw)
    finally:
        pooled.close()
    assert _entries(a) == _entries(b)


# ------------------------------------------------------------------ CLI ---


def test_cli_serve_passes_every_option(odt, monkeypatch, capsys):
    """``serve`` builds the service with every option passed through, binds,
    prints its start line, answers, and closes the service when serving
    ends"""
    from osu_dreamer_tpu_torch import serve
    from osu_dreamer_tpu_torch.cli import main

    built = []

    class Recording(serve.GeneratorService):
        def __init__(self, *args, **kwargs):
            built.append((args, kwargs, self))
            super().__init__(*args, **kwargs)

    health = []

    def serve_forever(self):
        """return at once, the HTTP loop left running on a thread for close()
        to stop, after one /healthz through it"""
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        with urllib.request.urlopen(_url(self, "/healthz"), timeout=10) as r:
            health.append(json.load(r))

    monkeypatch.setattr(serve, "GeneratorService", Recording)
    monkeypatch.setattr(serve.MapServer, "serve_forever", serve_forever)
    main(["serve", "--model-path", str(odt), "--host", "127.0.0.1", "--port", "0",
          "--max-batch", "3", "--batch-window-ms", "7.5", "--infer-tempo",
          "--snap-divisor", "4", "--devices", "1", "--serialize-workers", "1",
          "--device", "cpu"])
    ((args, kwargs, svc),) = built
    assert args == (odt,)
    assert kwargs == dict(max_batch=3, batch_window_ms=7.5, infer_tempo=True, snap_divisor=4,
                          devices=1, serialize_workers=1, device="cpu")
    assert (svc.max_batch, svc.batch_window, svc.infer_tempo, svc.snap_divisor) == \
        (3, 0.0075, True, 4)
    assert svc.device.type == "cpu" and svc.serialize_workers == 1
    assert health[0]["ok"] and health[0]["max_batch"] == 3 and health[0]["backend"] == "cpu"
    assert svc._closed and not svc._dispatcher.is_alive()
    assert "serving on http://127.0.0.1:" in capsys.readouterr().out


def test_cli_serve_needs_a_card_by_default(odt, monkeypatch):
    from osu_dreamer_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["serve", "--model-path", str(odt), "--port", "0"])
