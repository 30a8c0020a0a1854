"""The XLA SWAR counts pass against the plain jnp reference, and the
wrapper code around it: launch grouping, chunk padding, the sharded
mesh pass and the compile-cache location."""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stringsext_tpu import run as R
from stringsext_tpu.encodings import encoding_kind
from stringsext_tpu.mission import Missions
from stringsext_tpu.ops import classify
from stringsext_tpu.ops.runs import accept_mask, filter_words
from stringsext_tpu.ops.specs import swar_mission_spec
from stringsext_tpu.ops.swar import swar_counts

MISSION_SETS = {
    "flagship": ["UTF-8", "utf-16le", "utf-16be"],
    "single-byte": ["KOI8-R", "windows-1252", "x-user-defined"],
    "mixed": ["UTF-8", "utf-16be", "ISO-8859-7"],
}

_TEXT = [
    "plain text? déjà vu €uro".encode(),
    "wide ? Кириллица".encode("utf-16-le"),
    "big ? Ωμέγα".encode("utf-16-be"),
    "русский?".encode("koi8_r"),
    "Ελληνικά?".encode("iso-8859-7"),
]


def _corpus(rows, seed, edge):
    """rows*512 bytes of noise with planted text; `edge` "text" puts
    accepted chars at the very first and last bytes."""
    r = np.random.default_rng(seed)
    raw = r.integers(0, 256, rows * 512, dtype=np.uint8)
    for k, off in enumerate(range(300, len(raw) - 64, 1500)):
        t = _TEXT[k % len(_TEXT)]
        raw[off:off + len(t)] = np.frombuffer(t, np.uint8)
    if edge == "text":
        raw[:8] = np.frombuffer(b"AB?DEFGH", np.uint8)
        raw[-8:] = np.frombuffer(b"stuvw?yz", np.uint8)
    else:
        raw[:64] = 0
        raw[-64:] = 0
    return raw


def _reference_block_counts(raw, m):
    """(run_start | run_end<<10 | accept<<20, grep) per 512-byte block
    from the jnp lanes - the plain reference of the counts pass."""
    n = len(raw)
    b = jnp.asarray(raw)
    kind = encoding_kind(m.encoding_name)
    if kind == "utf8":
        lanes = classify.utf8_lanes(b, n)
    elif kind in ("utf16le", "utf16be"):
        lanes = classify.utf16_lanes(b, kind == "utf16be", n)
    else:
        lanes = classify.single_byte_lanes(b, m.encoding_name, n)
    af_w, ubf_w = filter_words(m)
    acc = np.asarray(accept_mask(lanes, jnp.asarray(af_w), jnp.asarray(ubf_w)))
    length = np.asarray(lanes.length)
    g = -1 if m.filter.grep_char is None else m.filter.grep_char
    grep = acc & (np.asarray(lanes.cp) == g)
    cont_prev = np.zeros(n, bool)
    joins_next = np.zeros(n, bool)
    for L in (1, 2, 3, 4):
        e = acc & (length == L)
        cont_prev[L:] |= e[:-L]
        joins_next[:-L] |= (length == L)[:-L] & acc[L:]
    rs = acc & ~cont_prev
    re = acc & ~joins_next

    def blk(x):
        return x.reshape(-1, 512).sum(axis=1).astype(np.int64)

    return blk(rs) | (blk(re) << 10) | (blk(acc) << 20), blk(grep)


@pytest.mark.parametrize("pad_rows", [0, 3])
@pytest.mark.parametrize("edge", ["zero", "text"])
@pytest.mark.parametrize("mset", list(MISSION_SETS))
def test_counts_match_jnp_lanes(mset, edge, pad_rows):
    """Every field of the per-block counts equals the jnp-lanes
    reference, for text or zeros at the stream edges, with and without
    zero chunk padding behind the stream."""
    ms = Missions.new(flag_encoding=MISSION_SETS[mset], flag_grep_char="63")
    specs = tuple(swar_mission_spec(m) for m in ms.v)
    assert all(sp is not None for sp in specs)
    raw = _corpus(12, seed=len(mset) + 3 * pad_rows, edge=edge)
    buf = np.concatenate([raw, np.zeros(pad_rows * 512, np.uint8)])
    words = jnp.asarray(buf.view(np.int32).reshape(-1, 128))
    got = np.asarray(swar_counts(words, specs))
    assert got.shape == (2 * len(specs), len(buf) // 512)
    for j, m in enumerate(ms.v):
        enc, grep = _reference_block_counts(buf, m)
        np.testing.assert_array_equal(got[2 * j], enc, m.encoding_name)
        np.testing.assert_array_equal(got[2 * j + 1], grep, m.encoding_name)
        assert (got[2 * j] >> 20).sum() > 0


@pytest.mark.parametrize("mset", list(MISSION_SETS))
def test_hot_only_counts_match_jnp_lanes(mset):
    """hot_only keeps the accept and grep counts and zeroes the
    run-boundary fields."""
    ms = Missions.new(flag_encoding=MISSION_SETS[mset], flag_grep_char="63")
    specs = tuple(swar_mission_spec(m) for m in ms.v)
    raw = _corpus(8, seed=7, edge="text")
    words = jnp.asarray(raw.view(np.int32).reshape(-1, 128))
    got = np.asarray(swar_counts(words, specs, hot_only=True))
    for j, m in enumerate(ms.v):
        enc, grep = _reference_block_counts(raw, m)
        np.testing.assert_array_equal(got[2 * j], (enc >> 20) << 20)
        np.testing.assert_array_equal(got[2 * j + 1], grep)


@pytest.mark.parametrize("cap", [None, "1", "2", "24"])
def test_hot_groups(monkeypatch, cap):
    """--hot-group bounds missions per launch; the default is
    _HOT_GROUP_DEFAULT."""
    jobs = [(i, ("sbyte", ((65, 90),), ())) for i in range(41)]
    if cap is None:
        monkeypatch.delenv("STRINGSEXT_HOT_GROUP", raising=False)
    else:
        monkeypatch.setenv("STRINGSEXT_HOT_GROUP", cap)
    groups = R._hot_groups(jobs)
    assert [j for g in groups for j in g] == jobs  # order preserved
    size = R._HOT_GROUP_DEFAULT if cap is None else int(cap)
    assert all(len(g) <= size for g in groups)
    assert len(groups) == -(-len(jobs) // size)


def test_hot_ranges_chunk_padding_shapes(monkeypatch):
    """Chunks pad to a power-of-two count of 512-byte blocks (at least
    8), capped at the chunk, so few shapes compile; the hot ranges
    cover every planted string."""
    from stringsext_tpu.input import LoadedStream
    from stringsext_tpu.ops import swar

    shapes = []
    real = swar.swar_counts

    def spy(w2, specs, **kw):
        shapes.append(w2.shape)
        return real(w2, specs, **kw)

    monkeypatch.setattr(swar, "swar_counts", spy)
    data = np.zeros(150_000, np.uint8)
    plants = (1_000, 70_000, 149_000)
    for off in plants:
        data[off:off + 12] = np.frombuffer(b"hot string!!", np.uint8)
    ms = Missions.new(flag_encoding=["UTF-8"])
    jobs = [(0, swar_mission_spec(ms.v[0]))]
    out = R._device_hot_ranges_swar(
        LoadedStream(data, [(None, 0, len(data))]), jobs, chunk=64 * 1024)
    assert shapes == [(128, 128), (128, 128), (64, 128)]
    s, e = out[0]
    for off in plants:
        assert any(lo <= off and off + 12 <= hi for lo, hi in zip(s, e))
    shapes.clear()
    R._device_hot_ranges_swar(
        LoadedStream(data[:3000], [(None, 0, 3000)]), jobs, chunk=64 * 1024)
    assert shapes == [(8, 128)]


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("rows", [64, 37])
def test_mesh_counts_match_single_device(rows):
    """_mesh_counts pads the panel to 8 equal shards and splices the
    per-shard counts back: equal to the single-device pass, also when
    the rows do not divide evenly."""
    ms = Missions.new(flag_encoding=["UTF-8", "utf-16le", "Shift_JIS"])
    from stringsext_tpu.ops.specs import cjk_hot_spec

    specs = tuple(swar_mission_spec(m) or cjk_hot_spec(m) for m in ms.v)
    raw = _corpus(rows, seed=rows, edge="text")
    # strings across every shard seam
    for k in range(1, 8):
        off = k * (-(-rows // 8)) * 512 - 5
        if off + 16 < len(raw):
            raw[off:off + 16] = np.frombuffer(b"seam string here", np.uint8)
    w2 = jnp.asarray(raw.view(np.int32).reshape(rows, 128))
    got = np.asarray(R._mesh_counts(w2, specs, 8))
    want = np.asarray(swar_counts(w2, specs, hot_only=True))
    np.testing.assert_array_equal(got, want)


def test_compilation_cache_dir_default(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache is `.jax_cache/` at
    the root of the checkout."""
    import stringsext_tpu

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(stringsext_tpu.__file__))
    assert R._compilation_cache_dir() == os.path.join(root, ".jax_cache")


def test_compilation_cache_dir_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins, and is what JAX is pointed at."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert R._compilation_cache_dir() == str(tmp_path / "cc")
    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    R._enable_compilation_cache()
    assert seen["jax_compilation_cache_dir"] == str(tmp_path / "cc")
    assert (tmp_path / "cc").is_dir()


def test_compilation_cache_failure_is_reported(monkeypatch, tmp_path,
                                               capsys):
    """A cache that cannot be set up is reported on stderr, and the
    scan goes on."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(blocker / "cc"))
    R._WARNED.clear()
    R._enable_compilation_cache()
    err = capsys.readouterr().err
    assert "compilation cache disabled" in err and str(blocker) in err


def test_engine_tpu_alias_runs_device_path(monkeypatch, tmp_path):
    """engine "tpu" is the old name of "device": both reach the device
    passes and print the same bytes as the host engine."""
    from stringsext_tpu.cli import parse_args

    blob = bytearray(np.random.default_rng(2).integers(
        0, 256, 50_000, np.uint8).tobytes())
    blob[20_000:20_024] = b"alias routing finding ok"
    p = tmp_path / "in.bin"
    p.write_bytes(bytes(blob))
    argv = ["-t", "x", "-e", "UTF-8", "-e", "utf-16le", str(p)]
    from stringsext_tpu.ops import device_events

    seen = []
    orig = device_events._runtable_feed_device

    def spy(*a, **k):
        seen.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(device_events, "_runtable_feed_device", spy)
    outs = {}
    for eng in ("device", "tpu", "auto"):
        buf = io.BytesIO()
        assert R.run(parse_args(argv), out=buf, engine=eng) == 0
        outs[eng] = buf.getvalue()
    assert len(seen) == 4  # 2 missions, device and tpu; not the host
    assert outs["device"] == outs["tpu"] == outs["auto"]
    assert b"alias routing finding ok" in outs["auto"]


@pytest.mark.chip
def test_counts_on_gpu_match_cpu():
    """On a machine with a GPU: the counts pass compiled for the card
    equals the same pass on the CPU backend, at a real chunk width."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    ms = Missions.new(flag_encoding=["UTF-8", "utf-16le", "utf-16be"])
    specs = tuple(swar_mission_spec(m) for m in ms.v)
    raw = _corpus(65536, seed=5, edge="text")  # 32 MiB
    words = raw.view(np.int32).reshape(-1, 128)
    got = swar_counts(jax.device_put(words, gpus[0]), specs)
    want = swar_counts(jax.device_put(words, jax.devices("cpu")[0]), specs)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
