"""engine=auto accelerator probe + host hot-map auto-enable.

The device-first execution model is the DEFAULT: engine=auto promotes
itself to the device path when a one-shot cached link probe says the
accelerator is co-located, and probe segmentation engages when idle
cores could run extra scan segments. These tests pin the decision
logic without touching a device.
"""

import io
import json

import numpy as np
import pytest

from stringsext_tpu import run as R
from stringsext_tpu.cli import parse_args


def test_probe_verdict_thresholds():
    # co-located: multi-GB/s link, sub-ms dispatch
    assert R._probe_verdict(10e9, 0.001)
    assert R._probe_verdict(R._PROBE_BW_MIN, R._PROBE_LAT_MAX)
    # remote: slow link or high latency fails either gate
    assert not R._probe_verdict(100e6, 0.001)
    assert not R._probe_verdict(10e9, 1.5)
    assert not R._probe_verdict(50e6, 2.0)


def test_auto_engine_disabled_by_env(monkeypatch, tmp_path):
    monkeypatch.setenv("STRINGSEXT_DEVICE_PROBE", "0")
    monkeypatch.setattr(R, "_measure_device_link",
                        lambda: pytest.fail("must not measure"))
    assert R._auto_engine() == "auto"


def test_auto_engine_honors_cached_verdict(monkeypatch, tmp_path):
    cache = tmp_path / "probe.json"
    monkeypatch.setenv("STRINGSEXT_PROBE_CACHE", str(cache))
    monkeypatch.delenv("STRINGSEXT_DEVICE_PROBE", raising=False)
    monkeypatch.setattr(R, "_measure_device_link",
                        lambda: pytest.fail("cached verdict must win"))
    cache.write_text(json.dumps({"verdict": "device"}))
    assert R._auto_engine() == "device"
    # a verdict cached under the engine's old name still promotes
    cache.write_text(json.dumps({"verdict": "tpu"}))
    assert R._auto_engine() == "device"
    cache.write_text(json.dumps({"verdict": "auto"}))
    assert R._auto_engine() == "auto"


def test_auto_engine_cached_tpu_needs_importable_jax(monkeypatch, tmp_path):
    """The verdict cache is per-machine but jax is per-interpreter: a
    cached "device" verdict from a jax-equipped venv must degrade to the
    host path (not crash later at `import jax`) when this interpreter
    has no jax - e.g. the .deb install, which depends only on numpy."""
    import importlib.util

    cache = tmp_path / "probe.json"
    monkeypatch.setenv("STRINGSEXT_PROBE_CACHE", str(cache))
    monkeypatch.delenv("STRINGSEXT_DEVICE_PROBE", raising=False)
    monkeypatch.setattr(R, "_measure_device_link",
                        lambda: pytest.fail("cached verdict must win"))
    cache.write_text(json.dumps({"verdict": "device"}))
    real_find_spec = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name == "jax"
        else real_find_spec(name, *a),
    )
    assert R._auto_engine() == "auto"


def test_accel_plausible_gpu_device_nodes(monkeypatch):
    """engine=auto's cheap presence check must fire for NVIDIA/AMD GPU
    device nodes too - the probe itself accepts gpu/cuda/rocm
    platforms, so the plausibility gate must not filter them out."""
    import glob as glob_mod

    for k in ("JAX_PLATFORMS", "JAX_PLATFORM_NAME"):
        monkeypatch.delenv(k, raising=False)

    import os.path as osp

    real_exists = osp.exists

    def fake_glob(pat):
        return ["/dev/nvidia0"] if pat == "/dev/nvidia[0-9]*" else []

    monkeypatch.setattr(glob_mod, "glob", fake_glob)
    assert R._accel_plausible()

    monkeypatch.setattr(glob_mod, "glob", lambda pat: [])
    assert not R._accel_plausible()  # negative control

    monkeypatch.setattr(
        osp, "exists",
        lambda p: True if p == "/dev/kfd" else real_exists(p))
    assert R._accel_plausible()


def test_auto_engine_skips_probe_without_accel_signals(monkeypatch, tmp_path):
    monkeypatch.setenv("STRINGSEXT_PROBE_CACHE",
                       str(tmp_path / "none.json"))
    monkeypatch.delenv("STRINGSEXT_DEVICE_PROBE", raising=False)
    monkeypatch.setattr(R, "_accel_plausible", lambda: False)
    monkeypatch.setattr(R, "_measure_device_link",
                        lambda: pytest.fail("no signals -> no probe"))
    assert R._auto_engine() == "auto"
    # and no cache entry is written for the skipped probe
    assert not (tmp_path / "none.json").exists()


def test_auto_engine_probe_and_cache_roundtrip(monkeypatch, tmp_path):
    cache = tmp_path / "probe.json"
    monkeypatch.setenv("STRINGSEXT_PROBE_CACHE", str(cache))
    calls = []

    def fake_measure():
        calls.append(1)
        return {"bw_bytes_s": 12e9, "rt_lat_s": 0.0004, "device": "FakeGPU"}

    monkeypatch.setattr(R, "_measure_device_link", fake_measure)
    monkeypatch.setenv("STRINGSEXT_DEVICE_PROBE", "1")  # force measure
    assert R._auto_engine() == "device"
    assert len(calls) == 1
    doc = json.loads(cache.read_text())
    assert doc["verdict"] == "device" and doc["device"] == "FakeGPU"
    # second call: cached, no re-measure
    monkeypatch.delenv("STRINGSEXT_DEVICE_PROBE")
    assert R._auto_engine() == "device"
    assert len(calls) == 1


def test_auto_engine_probe_error_caches_host_verdict(monkeypatch, tmp_path,
                                                    capsys):
    """A failed probe picks the host engine and says so on stderr; the
    failure is cached with a short TTL only (see the TTL test below).
    A probe that finds no accelerator at all is a measured host verdict
    and is cached for good, silently."""
    cache = tmp_path / "probe.json"
    monkeypatch.setenv("STRINGSEXT_PROBE_CACHE", str(cache))
    monkeypatch.setenv("STRINGSEXT_DEVICE_PROBE", "1")
    monkeypatch.setattr(
        R, "_measure_device_link",
        lambda: {"error": "probe timed out after 30s"})
    assert R._auto_engine() == "auto"
    assert "probe timed out after 30s" in capsys.readouterr().err
    doc = json.loads(cache.read_text())
    assert doc["verdict"] == "auto" and "timed out" in doc["error"]
    monkeypatch.setattr(R, "_measure_device_link",
                        lambda: {"platform": "cpu"})
    assert R._auto_engine() == "auto"
    assert json.loads(cache.read_text())["verdict"] == "auto"
    assert capsys.readouterr().err == ""


def test_auto_engine_probe_error_ttl(monkeypatch, tmp_path, capsys):
    """Within the TTL a cached probe failure is reused without probing
    again - a card that keeps failing must not cost every run the probe
    timeout - and each run that reuses it prints the warning. After the
    TTL the next run probes again."""
    import time

    cache = tmp_path / "probe.json"
    monkeypatch.setenv("STRINGSEXT_PROBE_CACHE", str(cache))
    monkeypatch.delenv("STRINGSEXT_DEVICE_PROBE", raising=False)
    monkeypatch.setattr(R, "_accel_plausible", lambda: True)
    calls = []

    def failing():
        calls.append(1)
        return {"error": "CUDA_ERROR_NO_DEVICE"}

    monkeypatch.setattr(R, "_measure_device_link", failing)
    assert R._auto_engine() == "auto"
    assert len(calls) == 1
    assert "CUDA_ERROR_NO_DEVICE" in capsys.readouterr().err
    for _ in range(2):  # reused: no new probe, the warning every time
        assert R._auto_engine() == "auto"
        assert "CUDA_ERROR_NO_DEVICE" in capsys.readouterr().err
    assert len(calls) == 1
    doc = json.loads(cache.read_text())
    doc["time"] = time.time() - R._PROBE_ERROR_TTL - 1
    cache.write_text(json.dumps(doc))
    monkeypatch.setattr(
        R, "_measure_device_link",
        lambda: {"bw_bytes_s": 12e9, "rt_lat_s": 0.0004, "device": "G"})
    assert R._auto_engine() == "device"  # expired: measured again
    assert json.loads(cache.read_text())["verdict"] == "device"
    assert capsys.readouterr().err == ""


def _probe_corpus(n=6 << 20, seed=9):
    """Random binary with zero gaps near the balance points + plants."""
    rng = np.random.default_rng(seed)
    blob = bytearray(rng.integers(0, 256, n, np.uint8).tobytes())
    for frac in (0.25, 0.5, 0.75):
        c = int(n * frac)
        blob[c - 40_000 : c + 40_000] = b"\x00" * 80_000
    plants = [
        (100_000, "first cluster déjà €uro".encode()),
        (int(n * 0.5) + 40_100, "post-gap +finding".encode()),
        (int(n * 0.6) & ~1, "wide Кириллица".encode("utf-16-le")),
        (n - 2_000, "tail finding at stream end".encode()),
    ]
    for off, m in plants:
        blob[off : off + len(m)] = m
    return bytes(blob)


def test_probe_segmentation_identity(monkeypatch, tmp_path):
    """Default probe-split segmentation (no hot maps) must be invisible
    in the output and actually engage (splits found near targets)."""
    blob = _probe_corpus()
    p = tmp_path / "probe.bin"
    p.write_bytes(blob)
    argv = ["-t", "x", "-e", "UTF-8", "-e", "utf-16le", str(p)]
    monkeypatch.setenv("STRINGSEXT_DEVICE_PROBE", "0")
    monkeypatch.delenv("STRINGSEXT_HOST_HOTMAP", raising=False)

    outs = {}
    for tag, seg, probe in (("ref", 1, "0"), ("off", 8, "0"),
                            ("probe", 8, "1")):
        monkeypatch.setattr(R, "_SEGMENT_MAX", seg)
        monkeypatch.setenv("STRINGSEXT_SEGMENT_PROBE", probe)
        buf = io.BytesIO()
        assert R.run(parse_args(argv), out=buf, engine="auto") == 0
        outs[tag] = buf.getvalue()
    assert outs["probe"] == outs["off"] == outs["ref"]
    assert b"+finding" in outs["probe"]
    assert "Кириллица".encode() in outs["probe"]

    # engagement check: the splitter finds cold rows near the targets
    from stringsext_tpu.input import LoadedStream, slice_table
    from stringsext_tpu.mission import Missions

    data = np.frombuffer(blob, np.uint8)
    sl = slice_table(LoadedStream(data, [(None, 0, len(data))]))
    ms = Missions.new(flag_encoding=["UTF-8"])
    rows = R._probe_segment_rows(data, sl, ms.v[0], "utf8", 128, 4)
    assert len(rows) == 3
    for r, frac in zip(rows, (0.25, 0.5, 0.75)):
        assert abs(int(sl[0][r]) - len(blob) * frac) < 60_000


def test_probe_segmentation_dense_finds_nothing(monkeypatch):
    """On a gap-free random stream the bounded probe gives up without
    touching the whole input - no splits, no behavior change."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 5 << 20, dtype=np.uint8)
    from stringsext_tpu.input import LoadedStream, slice_table
    from stringsext_tpu.mission import Missions

    sl = slice_table(LoadedStream(data, [(None, 0, len(data))]))
    ms = Missions.new(flag_encoding=["UTF-8"])
    assert R._probe_segment_rows(data, sl, ms.v[0], "utf8", 128, 4) == []


def test_probe_segmentation_cjk_and_utf16_guards(monkeypatch, tmp_path):
    """Probe splits for the non-self-synchronizing kinds keep the
    alignment proofs: identity for shift_jis + utf-16be missions with
    seam-adjacent plants."""
    rng = np.random.default_rng(11)
    n = 5 << 20
    blob = bytearray(rng.integers(0, 256, n, np.uint8).tobytes())
    for frac in (1 / 3, 2 / 3):
        c = int(n * frac)
        blob[c - 30_000 : c + 30_000] = b"\x00" * 60_000
    for off, m in (
        # \x00 ground byte: a preceding random SJIS lead byte must not
        # pair with the plant's first byte and shift the decode
        (int(n / 3) + 30_100, b"\x00" + "シフトJIS 文字列".encode("shift_jis")),
        ((int(n * 2 / 3) + 30_000) & ~1, "ΒΕ δεκαέξι".encode("utf-16-be")),
        (n - 3_000, b"\x00" + "tail 終わり".encode("shift_jis")),
    ):
        blob[off : off + len(m)] = m
    p = tmp_path / "cjk.bin"
    p.write_bytes(bytes(blob))
    # NB: "-u All" prefix-resolves to All-Asian (reference list order,
    # mission.rs:170-175) - Asian is the one that keeps kana/kanji.
    argv = ["-t", "d", "-u", "Asian", "-e", "shift_jis", "-e", "utf-16be",
            str(p)]
    monkeypatch.setenv("STRINGSEXT_DEVICE_PROBE", "0")

    outs = {}
    # 2 missions share the split budget: _SEGMENT_MAX=6 -> 3 segments
    # per mission
    for tag, seg in (("ref", 1), ("seg", 6)):
        monkeypatch.setattr(R, "_SEGMENT_MAX", seg)
        buf = io.BytesIO()
        assert R.run(parse_args(argv), out=buf, engine="auto") == 0
        outs[tag] = buf.getvalue()
    assert outs["seg"] == outs["ref"]
    assert "文字列".encode() in outs["seg"]


def test_run_resolves_auto_via_probe(monkeypatch, tmp_path):
    """run(engine='auto') consults _auto_engine; a cached 'device'
    verdict routes the scan through the device path (on the CPU test
    backend XLA compiles the same passes for the CPU - output must
    stay identical)."""
    cache = tmp_path / "probe.json"
    cache.write_text(json.dumps({"verdict": "device"}))
    monkeypatch.setenv("STRINGSEXT_PROBE_CACHE", str(cache))
    monkeypatch.delenv("STRINGSEXT_DEVICE_PROBE", raising=False)

    blob = bytearray(np.random.default_rng(4).integers(
        0, 256, 100_000, np.uint8).tobytes())
    blob[30_000:30_030] = b"probe routing finding here \xe2\x82\xac"
    p = tmp_path / "in.bin"
    p.write_bytes(bytes(blob))
    argv = ["-t", "x", "-e", "UTF-8", str(p)]

    seen = []
    orig = R._scan_arrays

    def spy(stream, missions, engine, **kw):
        seen.append(engine)
        return orig(stream, missions, engine, **kw)

    monkeypatch.setattr(R, "_scan_arrays", spy)
    buf = io.BytesIO()
    assert R.run(parse_args(argv), out=buf, engine="auto") == 0
    assert seen == ["device"]
    want = buf.getvalue()

    # with the device path pinned off, output is byte-identical
    monkeypatch.setenv("STRINGSEXT_DEVICE_PROBE", "0")
    buf2 = io.BytesIO()
    assert R.run(parse_args(argv), out=buf2, engine="auto") == 0
    assert buf2.getvalue() == want


def test_probe_vs_forced_hotmap_identity(monkeypatch, tmp_path):
    """Probe segmentation (default) and the forced full-prepass hot
    maps must agree byte-for-byte on a sparse stream."""
    rng = np.random.default_rng(9)
    blob = bytearray(rng.integers(0, 256, 6 << 20, np.uint8).tobytes())
    blob[1_000_000:5_000_000] = b"\x00" * 4_000_000
    blob[2_000_000:2_000_024] = b"sparse hot cluster here!"
    p = tmp_path / "auto.bin"
    p.write_bytes(bytes(blob))
    argv = ["-t", "x", "-e", "ascii", str(p)]

    monkeypatch.setattr(R, "_SEGMENT_MAX", 4)
    monkeypatch.setenv("STRINGSEXT_DEVICE_PROBE", "0")
    outs = {}
    for hm in ("", "0", "1"):
        if hm:
            monkeypatch.setenv("STRINGSEXT_HOST_HOTMAP", hm)
        else:
            monkeypatch.delenv("STRINGSEXT_HOST_HOTMAP", raising=False)
        buf = io.BytesIO()
        assert R.run(parse_args(argv), out=buf, engine="auto") == 0
        outs[hm] = buf.getvalue()
    assert outs[""] == outs["0"] == outs["1"]
    assert b"sparse hot cluster here!" in outs[""]


def test_measure_device_link_subprocess(monkeypatch):
    """The REAL probe subprocess (no mock): either the child finds no
    accelerator (CPU-only environments) or it returns a well-formed
    measurement."""
    monkeypatch.setenv("STRINGSEXT_PROBE_TIMEOUT", "180")
    m = R._measure_device_link()
    assert isinstance(m, dict), m
    if "error" in m:
        assert m["error"]  # no usable device / timeout: host path
    elif m.get("platform") == "cpu":
        assert "bw_bytes_s" not in m
    else:
        assert m["bw_bytes_s"] > 0 and m["rt_lat_s"] > 0 and m["device"]


def test_measure_device_link_in_process_with_live_backend(monkeypatch):
    """A process that already holds an accelerator backend decides
    in-process: no probe child may try to reserve the card again."""
    import subprocess

    monkeypatch.setattr(R, "_live_accelerator_backend", lambda: True)
    monkeypatch.setattr(
        subprocess, "run",
        lambda *a, **k: pytest.fail("must not spawn a probe process"))
    m = R._measure_device_link()
    # the test backend is the CPU: the in-process measurement says so
    assert m == {"platform": "cpu"}


def test_live_accelerator_backend_false_on_cpu():
    """The CPU test backend is not an accelerator backend."""
    import jax

    jax.devices()  # make sure a backend is live
    assert not R._live_accelerator_backend()


def test_probe_child_runs_without_preallocation(monkeypatch):
    """The probe child must not reserve most of the card's memory, and
    must find the package wherever the caller's cwd is."""
    import os
    import pathlib
    import subprocess
    import types

    import stringsext_tpu

    seen = {}

    def fake_run(cmd, **kw):
        seen.update(kw)
        return types.SimpleNamespace(
            stdout='{"platform": "cpu"}\n', stderr="", returncode=0)

    monkeypatch.setattr(R, "_live_accelerator_backend", lambda: False)
    monkeypatch.setattr(subprocess, "run", fake_run)
    assert R._measure_device_link() == {"platform": "cpu"}
    env = seen["env"]
    assert env["XLA_PYTHON_CLIENT_PREALLOCATE"] == "false"
    pkg_parent = str(pathlib.Path(stringsext_tpu.__file__).parent.parent)
    assert pkg_parent in env["PYTHONPATH"].split(os.pathsep)


def test_probe_segmentation_multifile_identity(monkeypatch, tmp_path):
    """Probe splits across a MULTI-file stream: file letters,
    boundary continuation and the split machinery must be invisible -
    byte-identity vs the unsegmented scan and the Python oracle."""
    rng = np.random.default_rng(15)
    n = 5 << 20
    blob = bytearray(rng.integers(0, 256, n, np.uint8).tobytes())
    for frac in (0.3, 0.6):
        c = int(n * frac)
        blob[c - 30_000 : c + 30_000] = b"\x00" * 60_000
    blob[int(n * 0.3) + 31_000 : int(n * 0.3) + 31_022] =\
        b"cross-file finding :-)"
    # split into two files NEAR a plant so the file seam sits inside
    # text (the concatenated stream must keep finding it)
    cut = int(n * 0.3) + 31_010
    p1 = tmp_path / "a.bin"
    p2 = tmp_path / "b.bin"
    p1.write_bytes(bytes(blob[:cut]))
    p2.write_bytes(bytes(blob[cut:]))
    argv = ["-t", "x", "-e", "UTF-8", str(p1), str(p2)]
    monkeypatch.setenv("STRINGSEXT_DEVICE_PROBE", "0")

    outs = {}
    for tag, eng, seg in (("oracle", "python", 1), ("un", "auto", 1),
                          ("seg", "auto", 4)):
        monkeypatch.setattr(R, "_SEGMENT_MAX", seg)
        buf = io.BytesIO()
        assert R.run(parse_args(argv), out=buf, engine=eng) == 0
        outs[tag] = buf.getvalue()
    assert outs["seg"] == outs["un"] == outs["oracle"]
    assert b"cross-file finding" in outs["seg"]


def _streaming_out(blob, argv, chunk, monkeypatch, max_seg, probe="1",
                   ck=None):
    from stringsext_tpu.mission import Missions
    from stringsext_tpu.run import _run_streaming_stdin

    monkeypatch.setattr(R, "_SEGMENT_MAX", max_seg)
    monkeypatch.setenv("STRINGSEXT_SEGMENT_PROBE", probe)
    args = parse_args(argv + ["-"])
    ms = Missions.from_args(args)
    buf = io.BytesIO()
    _run_streaming_stdin(args, ms, buf, src=io.BytesIO(blob),
                         chunk_bytes=chunk, engine="auto",
                         checkpoint_path=ck)
    return buf.getvalue()


def test_streaming_probe_segmentation_identity(monkeypatch, tmp_path):
    """Probe-split segmentation WITHIN streaming chunks: a huge
    single-mission stream uses every idle core, byte-identically -
    across multiple chunks (carried state flows through the LAST
    segment), for UTF-8 + Shift_JIS + ISO-2022-JP missions with
    seam-adjacent plants in every chunk."""
    rng = np.random.default_rng(23)
    chunk = 8 << 20
    n = 20 << 20  # 3 chunks (last short)
    blob = bytearray(rng.integers(0, 256, n, np.uint8).tobytes())
    for c in range(1 << 20, n - (1 << 20), 2 << 20):
        blob[c : c + 300_000] = b"\x00" * 300_000
    plants = [
        "stream déjà €uro".encode(),
        b"\x00" + "ストリーム分割".encode("shift_jis"),
        b"\x1b$B" + "漢字".encode("iso-2022-jp")[3:-3] + b"\x1b(Bok",
    ]
    for k, off in enumerate(range(1 << 20, n - 4096, 1 << 20)):
        t = plants[k % len(plants)]
        blob[off + 300_100 : off + 300_100 + len(t)] = t
    # a plant RIGHT AT each chunk boundary (carry interplay)
    for b in (chunk, 2 * chunk):
        t = b"\x00boundary +carry finding\x00"
        blob[b - 11 : b - 11 + len(t)] = t
    blob = bytes(blob)
    monkeypatch.setenv("STRINGSEXT_DEVICE_PROBE", "0")
    argv = ["-t", "x", "-u", "Asian", "-e", "UTF-8", "-e", "shift_jis",
            "-e", "ISO-2022-JP"]

    # 3 missions share the split budget: 12 -> 4 segments/mission
    un = _streaming_out(blob, argv, chunk, monkeypatch, 1)
    found = []
    orig_probe = R._probe_segment_rows

    def spy(*a, **k):
        r = orig_probe(*a, **k)
        found.append(len(r))
        return r

    monkeypatch.setattr(R, "_probe_segment_rows", spy)
    seg = _streaming_out(blob, argv, chunk, monkeypatch, 12)
    monkeypatch.setattr(R, "_probe_segment_rows", orig_probe)
    assert found and max(found) > 0  # segmentation actually engaged
    off = _streaming_out(blob, argv, chunk, monkeypatch, 12, probe="0")
    assert seg == un == off
    assert b"boundary +carry finding" in seg
    assert "ストリーム分割".encode() in seg

    # buffered path agrees too (the streaming-vs-buffered invariant)
    from stringsext_tpu.run import run

    p = tmp_path / "s.bin"
    p.write_bytes(blob)
    monkeypatch.setattr(R, "_SEGMENT_MAX", 12)
    buf = io.BytesIO()
    assert run(parse_args(argv + [str(p)]), out=buf, engine="auto") == 0
    assert buf.getvalue() == seg


def test_streaming_probe_segmentation_checkpoint(monkeypatch, tmp_path):
    """Segmented streaming composes with --checkpoint: the carried
    state written after each chunk is the LAST segment's exit state,
    so a full checkpointed run matches the plain one."""
    rng = np.random.default_rng(29)
    chunk = 8 << 20
    n = 12 << 20
    blob = bytearray(rng.integers(0, 256, n, np.uint8).tobytes())
    blob[3 << 20 : (3 << 20) + 400_000] = b"\x00" * 400_000
    blob[(3 << 20) + 100 : (3 << 20) + 120] = b"ckpt finding here 1!"
    blob = bytes(blob)
    monkeypatch.setenv("STRINGSEXT_DEVICE_PROBE", "0")
    argv = ["-t", "x", "-e", "UTF-8"]
    want = _streaming_out(blob, argv, chunk, monkeypatch, 4)
    ck = tmp_path / "ck.json"
    got = _streaming_out(blob, argv, chunk, monkeypatch, 4,
                         ck=str(ck))
    assert got == want
    assert not ck.exists()  # removed on success


def test_streaming_iso_escape_in_carry_tail(monkeypatch, tmp_path):
    """An ISO-2022-JP escape TRUNCATED at a chunk boundary rides the
    carry tail; the next chunk's segment entry modes must compose from
    the mission's CURSOR (which sits on the carried ESC), not from the
    first slice row - otherwise a post-split segment decodes LEAD-mode
    pairs as ASCII."""
    chunk = 16384
    blob = bytearray(chunk + 16384)
    # chunk 1: a plain finding, then a truncated escape at the edge
    blob[100:116] = b"ascii finding 1!"
    blob[chunk - 2 : chunk] = b"\x1b$"
    # chunk 2: "B" completes ESC $ B (-> LEAD); kanji pairs; a cold
    # zero slice; more pairs after the probe split; NUL terminator
    blob[chunk] = 0x42
    blob[chunk + 1 : chunk + 41] = b"\x34\x41" * 20  # 漢 x20
    # bytes [chunk+41, chunk+8194) stay zero -> slice row 1 cold
    blob[chunk + 8194 : chunk + 8234] = b"\x34\x41" * 20
    blob[chunk + 8234] = 0x00
    blob = bytes(blob)

    monkeypatch.setenv("STRINGSEXT_DEVICE_PROBE", "0")
    monkeypatch.setattr(R, "_SEGMENT_PROBE_MIN", 1)
    argv = ["-t", "x", "-u", "Asian", "-e", "ISO-2022-JP"]

    from stringsext_tpu.run import run

    p = tmp_path / "iso.bin"
    p.write_bytes(blob)
    buf = io.BytesIO()
    assert run(parse_args(argv + [str(p)]), out=buf,
               engine="python") == 0
    oracle = buf.getvalue()
    assert "漢漢漢".encode() in oracle
    # the post-gap pairs must decode as kanji, never as ASCII "4A4A"
    assert oracle.count("漢".encode()) >= 40
    assert b"4A4A" not in oracle

    un = _streaming_out(blob, argv, chunk, monkeypatch, 1)
    seg = _streaming_out(blob, argv, chunk, monkeypatch, 4)
    assert un == oracle
    assert seg == oracle
