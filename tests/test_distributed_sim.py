"""In-process simulation of the distributed data plane: the boundary
search, shard scans, entry-mode composition and rank-0 holdback merge
are pure functions (no collectives), so N ranks can be simulated in one
process and compared byte-for-byte against the single-process scan.
Covers shapes the TRUE process-level tests (test_distributed_2proc.py)
keep small: multi-file inputs with odd sizes (file letters, odd slice
bases), 4- and 5-way splits, dense no-split stretches (forward-
collapsing boundaries / empty shards), and ISO-2022-JP entry modes.
"""

import io

import numpy as np
import pytest

from stringsext_tpu import native
from stringsext_tpu.cli import parse_args
from stringsext_tpu.mission import Missions
from stringsext_tpu.parallel import distributed as D
from stringsext_tpu.run import run

pytestmark = pytest.mark.skipif(
    native.get_lib() is None, reason="no native toolchain"
)

rng = np.random.default_rng(33)


def _simulate(argv, paths, nprocs):
    """Exactly distributed_run's rank logic, all ranks in-process
    (distributed.simulate_ranks - shared with the randomized
    distributed fuzz in scripts/fuzz.py)."""
    args = parse_args(argv + paths)
    out, stats = D.simulate_ranks(args, paths, nprocs)
    return out, stats["bounds"], stats["n_rows"]


def _expected(argv, paths):
    buf = io.BytesIO()
    assert run(parse_args(argv + paths), out=buf, engine="auto") == 0
    return buf.getvalue()


def _write_sparse(path, n, seed, plant_step=3000):
    r = np.random.default_rng(seed)
    blob = bytearray(n)
    msgs = [
        b"multi-file ascii artifact",
        "wide ЖЖ utf16 string".encode("utf-16-le"),
        "déjà vu € utf8".encode(),
    ]
    k = 0
    for off in range(512, n - 64, plant_step):
        if (off % (48 * 1024)) > 32 * 1024:
            continue  # cold gaps
        m = msgs[k % len(msgs)]
        blob[off : off + len(m)] = m
        k += 1
    path.write_bytes(bytes(blob))


@pytest.mark.parametrize("nprocs", [2, 4, 5])
def test_multifile_odd_sizes(tmp_path, nprocs):
    """Three input files with ODD sizes: file-letter metadata, odd
    slice bases at the later files, splits possibly at file switches -
    all byte-identical to the single-process scan."""
    paths = []
    for k, n in enumerate((160 * 1024 + 1, 96 * 1024 + 3, 200 * 1024 + 7)):
        p = tmp_path / f"f{k}.bin"
        _write_sparse(p, n, seed=40 + k)
        paths.append(str(p))
    argv = ["-t", "x", "-e", "UTF-8", "-e", "utf-16le", "-n", "5"]
    got, bounds, n_rows = _simulate(argv, paths, nprocs)
    assert got == _expected(argv, paths)
    assert bounds[0] == 0 and bounds[-1] == n_rows
    assert bounds[1] > 0, "no real split on the sparse corpus"


def test_dense_stretch_collapses_forward(tmp_path):
    """A dense middle third (no quiescent rows) must collapse that
    boundary forward: the left neighbor absorbs it, LATER boundaries
    still split, and output stays byte-identical."""
    n = 384 * 1024
    blob = bytearray(n)
    r = np.random.default_rng(50)
    third = n // 3
    blob[third : 2 * third] = r.integers(
        0x20, 0x7F, third, np.uint8
    ).tobytes()  # dense accepted text, no cold slice anywhere
    for off in range(512, third - 64, 3000):
        if (off % (48 * 1024)) > 32 * 1024:
            continue
        blob[off : off + 20] = b"left cluster string!"
    for off in range(2 * third + 512, n - 64, 3000):
        if (off % (48 * 1024)) > 32 * 1024:
            continue
        blob[off : off + 21] = b"right cluster string!"
    p = tmp_path / "densemid.bin"
    p.write_bytes(bytes(blob))
    argv = ["-t", "x", "-e", "UTF-8", "-n", "6"]
    got, bounds, n_rows = _simulate(argv, [str(p)], 3)
    assert got == _expected(argv, [str(p)])


def test_iso_modes_across_shards(tmp_path):
    """ISO-2022-JP with several mode switches and a jis mode left open
    across multiple shard boundaries: entry modes must compose."""
    n = 512 * 1024
    blob = bytearray(n)
    jis = "日本語のテキストです".encode("iso-2022-jp")
    k = 0
    for off in range(800, n - 256, 2600):
        if (off % (64 * 1024)) > 40 * 1024:
            continue
        m = jis if k % 2 else b"plain ascii string here"
        blob[off : off + len(m)] = m
        k += 1
    # leave jis open twice, in different quarters
    for q in (n // 4, 5 * n // 8):
        frag = b"\x1b$B" + "漢字".encode("iso-2022-jp")[3:-3]
        blob[q : q + len(frag)] = frag
    p = tmp_path / "isomix.bin"
    p.write_bytes(bytes(blob))
    argv = ["-t", "x", "-e", "ISO-2022-JP", "-e", "Shift_JIS", "-n", "4"]
    for nprocs in (2, 4):
        got, bounds, _n = _simulate(argv, [str(p)], nprocs)
        assert got == _expected(argv, [str(p)]), f"nprocs={nprocs}"
        assert bounds[1] > 0


def test_macintosh_overflow_spec_allows_split(tmp_path):
    """macintosh's exact sbyte spec overflows the SWAR interval cap;
    the conservative cjk_hot_spec fallback (accepted-byte superset)
    must keep the whole mission SET shardable - one spec-less mission
    used to force rank-0-scans-all for every encoding."""
    from stringsext_tpu.encodings import full_byte_table
    from stringsext_tpu.ops.swar import (
        cjk_hot_spec,
        swar_mission_spec,
    )

    ms = Missions.from_args(parse_args(
        ["-e", "macintosh", "-e", "UTF-8", "/dev/null"]))
    m = ms.v[0]
    assert swar_mission_spec(m) is None  # the overflow that bit us
    spec = cjk_hot_spec(m)
    assert spec is not None and spec[0] == "sbyte"
    # superset property: every filter-accepted byte value is covered
    tbl = full_byte_table(m.encoding_name)
    f = m.filter
    iv = spec[1]
    for b in range(256):
        cp = int(tbl[b])
        if cp < 0:
            continue
        if cp < 0x80:
            ok = bool((f.af >> cp) & 1)
        else:
            lead = 0xC0 | (cp >> 6) if cp < 0x800 else 0xE0 | (cp >> 12)
            ok = bool((f.ubf >> (lead & 0x3F)) & 1)
        if ok:
            assert any(lo <= b <= hi for lo, hi in iv), hex(b)
    assert D._mission_jobs(ms) is not None

    # and the simulated multi-rank scan still splits + matches
    p = tmp_path / "mac.bin"
    _write_sparse(p, 256 * 1024, seed=77)
    argv = ["-t", "x", "-e", "macintosh", "-e", "UTF-8", "-n", "5"]
    got, bounds, n_rows = _simulate(argv, [str(p)], 2)
    assert got == _expected(argv, [str(p)])
    assert 0 < bounds[1] < n_rows, bounds


def test_randomized_distributed_differential(tmp_path):
    """Bounded-trial randomized distributed fuzz (the pytest wiring of
    scripts/fuzz.py's --dist branch): random corpora x random mission
    sets x nprocs in 2..5, in-process N-rank simulation byte-identical
    to the single-process scan, and shard reads partitioning the input
    exactly whenever a real split happened."""
    import random
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent.parent / "scripts"))
    import fuzz as fuzz_mod

    rng = random.Random(77)
    nprng = np.random.default_rng(77)
    splits_seen = 0
    for t in range(12):
        argv = fuzz_mod.random_config(rng)
        blob = fuzz_mod.random_corpus(rng, nprng)
        nfiles = rng.randint(1, 3)
        paths = []
        for k in range(nfiles):
            p = tmp_path / f"t{t}_{k}.bin"
            p.write_bytes(blob[k::nfiles] if nfiles > 1 else blob)
            paths.append(str(p))
        expected = _expected(argv, paths)
        nprocs = 2 + t % 4
        args = parse_args(argv + paths)
        sim_out, st = D.simulate_ranks(args, paths, nprocs)
        assert sim_out == expected, (t, argv, nprocs, st["bounds"])
        total = sum(len(open(p, "rb").read()) for p in paths)
        if len(set(st["bounds"])) > 2:
            splits_seen += 1
            assert sum(st["shard_read"]) == total, (t, st)
    assert splits_seen >= 1  # at least one trial really split


def test_distributed_runtable_feed(tmp_path, monkeypatch):
    """Per-shard run-table feed (engine=device + STRINGSEXT_RUNTABLE_FEED):
    the shard base is a true event start for every mission, so the
    cursor-grounded feed builder applies with cursor 0; ISO-2022-JP
    engages only on ground-entry shards (mode switches planted so some
    shards enter mid-mode and must fall back). Byte-identical to the
    single-process scan at 2 and 4 ranks."""
    r = np.random.default_rng(17)
    paths = []
    for fi in range(2):
        n = 300 * 1024 + fi * 7777
        data = bytearray(r.integers(0, 256, n, np.uint8).tobytes())
        texts = [
            ("в лесу ёлочка " * 30).encode("koi8_r"),
            ("Привет мир! " * 30).encode("utf-8"),
            ("hello 世界 " * 30).encode("utf-16-le"),
            ("こんにちは世界。テスト" * 30).encode("shift_jis"),
            b"\x1b$B"
            + ("国際化テストです。".encode("iso2022_jp")[3:-3]) * 12
            + b"\x1b(B",
        ]
        for off in range(2048, n - 4096, 12288):
            t = texts[(off // 12288) % len(texts)]
            data[off:off + len(t)] = t
        for off in range(5000, n - 16, 23456):
            data[off:off + 3] = b"\x1b$B"
        p = tmp_path / f"f{fi}.bin"
        p.write_bytes(bytes(data))
        paths.append(str(p))
    for argv in (["-t", "x", "-e", "UTF-8", "-e", "KOI8-R", "-n", "4"],
                 ["-t", "x", "-e", "ISO-2022-JP", "-e", "Shift_JIS",
                  "-n", "4"]):
        expected = _expected(argv, paths)
        monkeypatch.setenv("STRINGSEXT_RUNTABLE_FEED", "1")
        for nprocs in (2, 4):
            got, _stats = D.simulate_ranks(
                parse_args(argv + paths), paths, nprocs, engine="device")
            assert got == expected, (argv, nprocs)
        monkeypatch.delenv("STRINGSEXT_RUNTABLE_FEED")
        assert expected.count(b"\n") > 100
