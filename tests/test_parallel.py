"""Mesh-sharded scan must agree with single-device scanning.

Runs on the virtual 8-device CPU mesh (conftest). Run tables from the
sharded scan, after stitching contiguous cross-shard runs, must equal
the single-chunk reference runs for every mission.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stringsext_tpu.mission import Missions
from stringsext_tpu.ops import classify
from stringsext_tpu.ops.device_events import compute_lanes
from stringsext_tpu.ops.runs import extract_runs, filter_words
from stringsext_tpu.parallel.mesh import build_sharded_scan, make_mesh

rng = np.random.default_rng(7)


def _single_runs(data, mission, capacity=1024):
    from stringsext_tpu.encodings import encoding_kind
    from stringsext_tpu.ops.classify_cjk import CJK_KINDS, cjk_lanes
    from stringsext_tpu.ops.classify_iso2022 import iso2022_lanes

    kind = encoding_kind(mission.encoding_name)
    if kind in CJK_KINDS:
        lanes, _multi = cjk_lanes(jnp.asarray(data), kind, len(data))
    elif kind == "iso-2022-jp":
        lanes, _hot = iso2022_lanes(jnp.asarray(data), len(data))
    else:
        lanes = compute_lanes(data, mission.encoding_name)
    af_w, ubf_w = filter_words(mission)
    g = -1 if mission.filter.grep_char is None else mission.filter.grep_char
    rt = extract_runs(lanes, jnp.asarray(af_w), jnp.asarray(ubf_w), jnp.int32(g),
                      capacity=capacity)
    cnt = int(rt.count)
    s, e, c, gh = (np.asarray(x) for x in (rt.start, rt.end, rt.chars, rt.grep_hits))
    return [(int(s[k]), int(e[k]), int(c[k]), int(gh[k])) for k in range(cnt)]


def _stitch(rows):
    """Merge runs that are contiguous across shard boundaries."""
    out = []
    for r in sorted(rows):
        if out and out[-1][1] == r[0]:
            p = out[-1]
            out[-1] = (p[0], r[1], p[2] + r[2], p[3] + r[3])
        else:
            out.append(r)
    return out


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_scan_matches_single_device():
    ms = Missions.new(flag_encoding=["ascii", "UTF-8", "utf-16le", "utf-16be"])
    mesh = make_mesh(2, 4)
    shard_len = 512
    scan = build_sharded_scan(ms.v, mesh, shard_len=shard_len, capacity=256)

    for trial in range(4):
        data = rng.integers(0, 256, size=2 * shard_len, dtype=np.uint8)
        # plant strings crossing the shard boundary
        text = b"boundary crossing ascii string here"
        data[shard_len - 17 : shard_len - 17 + len(text)] = np.frombuffer(
            text, np.uint8
        )
        u16 = "UTF16 boundary Жж str".encode("utf-16-le")
        p = shard_len - 20 - (trial % 2)  # exercise both unit parities
        data[p : p + len(u16)] = np.frombuffer(u16, np.uint8)

        rt = scan(jnp.asarray(data))
        cnt = np.asarray(rt.count)
        st, en, ch, gh = (np.asarray(x) for x in (rt.start, rt.end, rt.chars, rt.grep_hits))
        for mi, m in enumerate(ms.v):
            rows = []
            for d in range(2):
                rows.extend(
                    (int(st[d, mi, k]), int(en[d, mi, k]), int(ch[d, mi, k]),
                     int(gh[d, mi, k]))
                    for k in range(int(cnt[d, mi]))
                )
            got = _stitch(rows)
            want = _stitch(_single_runs(data, m))
            assert got == want, f"trial {trial} mission {mi} ({m.encoding_name})"


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_scan_all_kinds_matches_single_device():
    """EVERY encoding kind rides the device mesh (VERDICT r4 task 1):
    the non-self-synchronizing CJK kinds and modal ISO-2022-JP shard
    over the data axis via cross-shard phase/state composition, and the
    stitched run tables must equal the single-device scan. Seams are
    attacked directly: multi-byte chars (incl. gb18030 4-byte forms and
    EUC-JP 0x8F triples) split at every offset, ISO escapes split at
    every offset, LEAD mode spanning whole shards, and the
    redundant-escape flag carried across a seam."""
    ms = Missions.new(
        flag_encoding=["shift_jis", "gb18030", "euc-jp", "ISO-2022-JP"]
    )
    mesh = make_mesh(2, 4)
    shard_len = 512
    scan = build_sharded_scan(ms.v, mesh, shard_len=shard_len, capacity=256)

    def check(data, tag):
        rt = scan(jnp.asarray(data))
        cnt = np.asarray(rt.count)
        st, en, ch, gh = (
            np.asarray(x) for x in (rt.start, rt.end, rt.chars, rt.grep_hits)
        )
        for mi, m in enumerate(ms.v):
            rows = []
            for d in range(2):
                rows.extend(
                    (int(st[d, mi, k]), int(en[d, mi, k]), int(ch[d, mi, k]),
                     int(gh[d, mi, k]))
                    for k in range(int(cnt[d, mi]))
                )
            got = _stitch(rows)
            want = _stitch(_single_runs(data, m))
            assert got == want, f"{tag} mission {mi} ({m.encoding_name})"

    n = 2 * shard_len
    for split in (1, 2, 3):  # bytes of the straddler left of the seam
        data = rng.integers(0, 256, n, np.uint8)
        sj = "シフトJIS 境界テスト".encode("shift_jis")
        data[shard_len - split : shard_len - split + len(sj)] = (
            np.frombuffer(sj, np.uint8))
        gb = "国标 abc".encode("gb18030") + b"\x90\x30\x81\x30\x81\x30\x81\x30"
        data[200 : 200 + len(gb)] = np.frombuffer(bytearray(gb), np.uint8)
        check(data, f"sj-straddle-{split}")

        data = rng.integers(0, 256, n, np.uint8)
        gb4 = b"ok " + "\U0001F600\U0001F601".encode("gb18030") + b" done"
        data[shard_len - split : shard_len - split + len(gb4)] = (
            np.frombuffer(bytearray(gb4), np.uint8))
        ej = b"\x8f\xa2\xaf\x8f\xa2\xaf" + "日本語".encode("euc_jp")
        data[shard_len - 300 - split : shard_len - 300 - split + len(ej)] = (
            np.frombuffer(bytearray(ej), np.uint8))
        check(data, f"gb4-straddle-{split}")

        # ISO-2022-JP: escape split at the seam; LEAD pair split at the
        # seam; mode set in shard 0 consumed in shard 1.
        data = rng.integers(0, 256, n, np.uint8)
        iso = (b"\x1b$B" + "漢字テスト".encode("iso-2022-jp")[3:-3]
               + b"\x1b(B ascii")
        data[shard_len - split : shard_len - split + len(iso)] = (
            np.frombuffer(bytearray(iso), np.uint8))
        check(data, f"iso-straddle-{split}")

    # LEAD mode spanning the whole second shard (no escape after seam).
    data = rng.integers(0, 256, n, np.uint8)
    body = ("漢" * 300).encode("iso-2022-jp")[3:-3]  # jis0208 pairs only
    data[shard_len - 100 : shard_len - 100 + len(body)] = np.frombuffer(
        bytearray(body), np.uint8)
    data[shard_len - 103 : shard_len - 100] = np.frombuffer(
        b"\x1b$B", np.uint8)
    check(data, "iso-lead-spans-shard")

    # Redundant-escape flag across the seam: valid escape ends shard 0,
    # the very next bytes (shard 1) are another valid escape -> the
    # redundant-escape error event in shard 1 depends on shard 0 state.
    data = rng.integers(0, 256, n, np.uint8)
    data[shard_len - 20 : shard_len - 20 + 14] = np.frombuffer(
        b"txt\x1b(J\x1b(Bmore\x1b", np.uint8)
    data[shard_len - 3 : shard_len + 3] = np.frombuffer(
        b"\x1b(J\x1b(B", np.uint8)
    check(data, "iso-redundant-across-seam")

    # Dense ASCII-ish corpus: entry deltas stay 0 but every shard is
    # full of runs (count-path stress).
    data = np.frombuffer(
        (b"dense ascii with \x82\xa0 kana " * 64)[:n], np.uint8
    ).copy()
    check(data, "dense")


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("seed", [21, 22])
def test_sharded_scan_all_kinds_random(seed):
    """Property form over an 8-wide data axis: random mission sets
    drawn from ALL kinds, random corpora with seam-straddling plants on
    every seam; stitched mesh runs == single-device runs."""
    r = np.random.default_rng(seed)
    pool = ["big5", "euc-kr", "gb18030", "shift_jis", "euc-jp",
            "ISO-2022-JP", "UTF-8", "koi8-r"]
    encs = list(r.choice(pool, size=2, replace=False))
    ms = Missions.new(flag_encoding=encs)
    n_data, shard_len = 4, 256
    mesh = make_mesh(n_data, 2)
    scan = build_sharded_scan(ms.v, mesh, shard_len=shard_len, capacity=256)

    n = n_data * shard_len
    plants = [
        "香港繁體字測試".encode("big5"),
        "한국어 테스트".encode("euc-kr"),
        "\U0001F600四字节 OK".encode("gb18030"),
        "カタカナ試験".encode("shift_jis"),
        b"\x8f\xa2\xaf" + "日本".encode("euc_jp"),
        b"\x1b$B" + "漢字".encode("iso-2022-jp")[3:-3] + b"\x1b(B!",
        "déjà vu €".encode(),
    ]
    for trial in range(3):
        data = r.integers(0, 256, n, np.uint8)
        for d in range(1, n_data):
            t = plants[(d + trial + seed) % len(plants)]
            off = d * shard_len - int(r.integers(1, len(t)))
            data[off : off + len(t)] = np.frombuffer(bytearray(t), np.uint8)
        rt = scan(jnp.asarray(data))
        cnt = np.asarray(rt.count)
        st, en, ch, gh = (
            np.asarray(x) for x in (rt.start, rt.end, rt.chars, rt.grep_hits)
        )
        for mi, m in enumerate(ms.v):
            rows = []
            for d in range(n_data):
                rows.extend(
                    (int(st[d, mi, k]), int(en[d, mi, k]), int(ch[d, mi, k]),
                     int(gh[d, mi, k]))
                    for k in range(int(cnt[d, mi]))
                )
            got = _stitch(rows)
            want = _stitch(_single_runs(data, m))
            assert got == want, (
                f"seed {seed} trial {trial} mission {mi} ({m.encoding_name})")


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_swar_counts_match_single_device():
    """The fused flagship SWAR counts pass sharded over the data axis
    (ppermute halos, zero-filled at the stream edges) must be BIT-exact
    vs one single-device pass over the whole stream."""
    from stringsext_tpu.ops.swar import swar_mission_spec, swar_counts
    from stringsext_tpu.parallel.mesh import build_sharded_counts

    ms = Missions.new(flag_encoding=["UTF-8", "utf-16le", "utf-16be"])
    specs = tuple(swar_mission_spec(m) for m in ms.v)
    n_data, shard_rows = 8, 48
    mesh = make_mesh(n_data, 1)
    fn = build_sharded_counts(specs, mesh, shard_rows)

    rows = n_data * shard_rows
    for trial in range(3):
        raw = rng.integers(0, 256, size=rows * 512, dtype=np.uint8)
        # plant strings across shard boundaries
        t = "shard boundary déjà €".encode("utf-8")
        off = (trial + 1) * shard_rows * 512 - 9
        raw[off : off + len(t)] = np.frombuffer(t, np.uint8)
        w = jnp.asarray(raw.view(np.int32).reshape(rows, 128))

        got = np.asarray(fn(w))  # [n_data, R, shard_rows]
        want = np.asarray(swar_counts(w, specs))  # [R, rows]
        got_flat = np.concatenate([got[d] for d in range(n_data)], axis=1)
        assert (got_flat == want).all(), f"trial {trial}"


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_sharded_swar_counts_random_missions(seed):
    """Property form of the sharded-counts bit-exactness: RANDOM
    mission sets (UTF-8 / UTF-16 / single-byte, random filters/greps)
    over random sparse corpora with strings planted AT the shard
    seams."""
    from stringsext_tpu.ops.swar import swar_mission_spec, swar_counts
    from stringsext_tpu.parallel.mesh import build_sharded_counts

    r = np.random.default_rng(seed)
    pool = ["UTF-8", "utf-16le", "utf-16be", "koi8-r", "windows-1252",
            "ibm866"]
    encs = list(r.choice(pool, size=r.integers(1, 4), replace=False))
    kw = {}
    if r.random() < 0.5:
        kw["flag_grep_char"] = str(int(r.integers(33, 127)))
    if r.random() < 0.4:
        kw["flag_unicode_block_filter"] = r.choice(
            ["Cyrillic", "Common", "All", "Latin"]
        )
    ms = Missions.new(flag_encoding=encs, **kw)
    specs = tuple(swar_mission_spec(m) for m in ms.v)
    if any(s is None for s in specs):
        pytest.skip("filter decomposed into too many intervals")
    lens = {"utf8": 4, "utf16": 2, "sbyte": 1}
    if sum(lens[s[0]] for s in specs) > 8:
        pytest.skip("mission set exceeds the 8-bit length-class budget")

    n_data, shard_rows = 4, 32
    mesh = make_mesh(n_data, 1)
    fn = build_sharded_counts(specs, mesh, shard_rows)

    rows = n_data * shard_rows
    raw = np.zeros(rows * 512, np.uint8)
    noise = r.integers(0, 256, size=rows * 64, dtype=np.uint8)
    raw[:: 8] = noise[: len(raw[::8])]
    plants = [
        "seam déjà Кк test?".encode(),
        "seam УТФ шестнадцать?".encode("utf-16-le"),
        "seam ΑΒΓ sixteen?".encode("utf-16-be"),
        bytes(r.integers(0xC0, 0x100, 24, np.uint8).tolist()),  # sbyte food
    ]
    for d in range(1, n_data):
        t = plants[(d - 1 + seed) % len(plants)]  # seed-rotated: all 4
        # plants appear across the seed matrix (3 seams per seed)
        off = d * shard_rows * 512 - int(r.integers(1, len(t)))
        raw[off : off + len(t)] = np.frombuffer(t, np.uint8)

    w = jnp.asarray(raw.view(np.int32).reshape(rows, 128))
    got = np.asarray(fn(w))
    want = np.asarray(swar_counts(w, specs))
    got_flat = np.concatenate([got[d] for d in range(n_data)], axis=1)
    assert (got_flat == want).all(), f"encs {encs} kw {kw}"


def test_host_shard_range_partition():
    """host_shard_range must tile [0, total) without gaps or overlap
    for any process count (single-process here: full range)."""
    from stringsext_tpu.parallel.distributed import host_shard_range

    lo, hi = host_shard_range(10 * 4096, 4096)
    assert (lo, hi) == (0, 10 * 4096)


def test_engine_tpu_hot_group_sizes(monkeypatch, tmp_path):
    """STRINGSEXT_HOT_GROUP: the engine=device hot-map pass must produce
    identical CLI output for any missions-per-launch grouping (1-group,
    multi-group, and the production default)."""
    import io

    from stringsext_tpu.cli import parse_args
    from stringsext_tpu.run import run

    blob = bytearray(rng.integers(0, 256, 200_000, np.uint8).tobytes())
    blob[60_000:120_000] = b"\x00" * 60_000
    for off, t in (
        (70_000, "group déjà € finding".encode()),
        (90_001, "UTF16 группа?".encode("utf-16-le")),
    ):
        blob[off : off + len(t)] = t
    p = tmp_path / "grp.bin"
    p.write_bytes(bytes(blob))

    argv = ["-t", "x", "-e", "UTF-8", "-e", "utf-16le", "-e", "utf-16be",
            "-e", "koi8-r", "-e", "windows-1252", "-e", "shift_jis",
            "-e", "euc-kr", str(p)]
    monkeypatch.setenv("STRINGSEXT_RUNTABLE_FEED", "0")  # hot-map path
    buf = io.BytesIO()
    run(parse_args(argv), out=buf, engine="auto")
    want = buf.getvalue()
    for grp in ("2", "3", "20"):
        monkeypatch.setenv("STRINGSEXT_HOT_GROUP", grp)
        buf = io.BytesIO()
        run(parse_args(argv), out=buf, engine="device")
        assert buf.getvalue() == want, f"group size {grp}"
    assert len(want) > 100


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_engine_tpu_mesh_hot_path(monkeypatch, tmp_path):
    """STRINGSEXT_MESH=1: the engine=device hot-map pass runs the SHARDED
    counts kernel over the virtual mesh; CLI output must equal the
    native engine exactly."""
    import io

    from stringsext_tpu.cli import parse_args
    from stringsext_tpu.run import run

    blob = bytearray(rng.integers(0, 256, 300_000, np.uint8).tobytes())
    blob[100_000:180_000] = b"\x00" * 80_000
    for off in (120_000, 150_001):
        m = "mesh déjà € finding".encode("utf-8")
        blob[off : off + len(m)] = m
    p = tmp_path / "mesh.bin"
    p.write_bytes(bytes(blob))

    argv = ["-t", "x", "-e", "UTF-8", "-e", "utf-16le", "-e", "euc-kr",
            str(p)]
    monkeypatch.setenv("STRINGSEXT_RUNTABLE_FEED", "0")  # hot-map path
    outs = {}
    for mesh_mode in ("0", "1"):
        monkeypatch.setenv("STRINGSEXT_MESH", mesh_mode)
        for engine in (("native",) if mesh_mode == "0" else ("device",)):
            buf = io.BytesIO()
            run(parse_args(argv), out=buf, engine=engine)
            outs[(mesh_mode, engine)] = buf.getvalue()
    assert outs[("1", "device")] == outs[("0", "native")]
    assert len(outs[("1", "device")]) > 100


def test_compiled_collectives_are_neighbor_ppermute_only():
    """Machine-check the mesh's communication claim on the virtual mesh:
    the compiled sharded programs contain NO all-gather/all-reduce/
    all-to-all/reduce-scatter, and every collective-permute is a
    data-axis neighbor exchange (scripts/audit_collectives.py is the
    standalone 8+16-device version)."""
    import numpy as np

    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent.parent / "scripts"))
    from audit_collectives import audit_hlo, compiled_text

    from stringsext_tpu.mission import Missions
    from stringsext_tpu.ops.swar import swar_params
    from stringsext_tpu.parallel import mesh as pmesh

    ms = Missions.new(flag_encoding=["UTF-8", "utf-16le", "utf-16be"])
    p = swar_params(ms.v)
    specs = (
        ("utf8", p["af_iv"], p["ubf_iv"], p["greps"][0]),
        ("utf16", False, p["cp_iv_le"], p["greps"][1]),
    )
    m8 = pmesh.make_mesh(8, 1)
    step = pmesh.build_sharded_counts(specs, m8, shard_rows=16)
    hlo = compiled_text(step, np.zeros((8 * 16, 128), np.int32))
    r = audit_hlo(hlo, 8, 1)
    assert r["ok"], r

    m42 = pmesh.make_mesh(4, 2)
    step2 = pmesh.build_sharded_scan(ms.v[:2], m42, shard_len=4096,
                                     capacity=128)
    hlo2 = compiled_text(step2, np.zeros(4 * 4096, np.uint8))
    r2 = audit_hlo(hlo2, 4, 2)
    assert r2["ok"], r2
