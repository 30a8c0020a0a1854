"""SWAR counts pass: field-word equivalence with the jnp lanes and
run-table parity of the counts path with the jnp-lanes reference."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stringsext_tpu.mission import Missions
from stringsext_tpu.ops import classify, swar
from stringsext_tpu.ops.runs import (
    accept_mask,
    extract_runs,
    filter_words,
)

rng = np.random.default_rng(41)


def _missions(grep="63"):
    return Missions.new(
        flag_encoding=["UTF-8", "utf-16le", "utf-16be"], flag_grep_char=grep
    )


def _corpus(nwords_rows, seed=0):
    r = np.random.default_rng(seed)
    n = nwords_rows * 128 * 4
    raw = r.integers(0, 256, size=n, dtype=np.uint8)
    raw[:512] = 0
    raw[-512:] = 0
    plants = [
        ("text ? déjà vu €uro here!".encode(), 3000),
        ("utf16 ? string Жж".encode("utf-16-le"), 9000),
        ("utf16 ? string Ωω".encode("utf-16-be"), 15000),
        ("astral \U0001F600 ? pair".encode("utf-16-le"), 20002),
    ]
    for t, off in plants:
        if off + len(t) < n - 512:
            raw[off : off + len(t)] = np.frombuffer(t, np.uint8)
    return raw


def _field_words(raw, params):
    """Whole-stream SWAR field words (UTF-8, UTF-16LE, UTF-16BE) of a
    zero-context stream, one int32 word per 4 bytes."""
    P = swar._Panel(jnp.asarray(raw.view(np.int32)).reshape(1, -1))
    return (
        swar.swar_utf8_panel(
            P, params["af_iv"], params["ubf_iv"], params["greps"][0]),
        swar.swar_utf16_panel(
            P, params["cp_iv_le"], params["greps"][1], False),
        swar.swar_utf16_panel(
            P, params["cp_iv_be"], params["greps"][2], True),
    )


def _lanes_runs(raw, m, capacity, grep=63):
    """Reference run table from the jnp classification lanes."""
    from stringsext_tpu.encodings import encoding_kind

    n = len(raw)
    kind = encoding_kind(m.encoding_name)
    if kind == "utf8":
        lanes = classify.utf8_lanes(jnp.asarray(raw), n)
    elif kind in ("utf16le", "utf16be"):
        lanes = classify.utf16_lanes(jnp.asarray(raw), kind == "utf16be", n)
    else:
        lanes = classify.single_byte_lanes(jnp.asarray(raw), m.encoding_name,
                                           n)
    af_w, ubf_w = filter_words(m)
    return extract_runs(lanes, jnp.asarray(af_w), jnp.asarray(ubf_w),
                        jnp.int32(grep), capacity=capacity)


def _unpack_bytes(ow, n):
    out = np.zeros(n, np.int32)
    for j in range(4):
        out[j::4] = (ow >> (8 * j)) & 0xFF
    return out


def _unpack_units(ow, n):
    out = np.zeros(n, np.int32)
    out[0::4] = ow & 0xFF
    out[2::4] = (ow >> 16) & 0xFF
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_swar_fields_match_jnp(seed):
    ms = _missions()
    params = swar.swar_params(ms.v)
    assert params is not None
    rows = 64
    raw = _corpus(rows, seed)
    n = len(raw)
    o8, ole, obe = _field_words(raw, params)
    sl = slice(512, n - 512)
    for mi, ow in enumerate([o8, ole, obe]):
        ow = np.asarray(ow).reshape(-1)
        af_w, ubf_w = filter_words(ms[mi])
        if mi == 0:
            lanes = classify.utf8_lanes(jnp.asarray(raw), n)
            f = _unpack_bytes(ow, n)
        else:
            lanes = classify.utf16_lanes(jnp.asarray(raw), mi == 2, n)
            f = _unpack_units(ow, n)
        acc = np.asarray(accept_mask(lanes, jnp.asarray(af_w), jnp.asarray(ubf_w)))
        st = np.asarray(lanes.start & ~lanes.pending)
        ln = np.asarray(lanes.length)
        cp = np.asarray(lanes.cp)
        np.testing.assert_array_equal(((f & 1) != 0)[sl], acc[sl], f"m{mi} accept")
        np.testing.assert_array_equal(
            (((f >> 5) & 1) != 0)[sl], st[sl], f"m{mi} start"
        )
        np.testing.assert_array_equal(
            np.where(((f >> 5) & 1) != 0, (f >> 1) & 7, 0)[sl],
            np.where(st, ln, 0)[sl],
            f"m{mi} len",
        )
        np.testing.assert_array_equal(
            ((f & 16) != 0)[sl], (acc & (cp == 63))[sl], f"m{mi} grep"
        )


def test_swar_runs_match_reference():
    from stringsext_tpu.ops.runs import extract_runs_swar_blocks

    ms = _missions()
    params = swar.swar_params(ms.v)
    rows = 64
    raw = _corpus(rows, 2)
    words = jnp.asarray(raw.view(np.int32).reshape(rows, 128))
    counts = swar.flagship_swar_counts(words, **params)
    eps = (
        dict(kind="utf8", af_iv=params["af_iv"], ubf_iv=params["ubf_iv"],
             grep=params["greps"][0]),
        dict(kind="utf16", cp_iv=params["cp_iv_le"], grep=params["greps"][1],
             be=False),
        dict(kind="utf16", cp_iv=params["cp_iv_be"], grep=params["greps"][2],
             be=True),
    )
    for mi, ep in enumerate(eps):
        rt_ref = _lanes_runs(raw, ms[mi], 512)
        rt_got = extract_runs_swar_blocks(
            words, counts[2 * mi], counts[2 * mi + 1], capacity=512, **ep
        )
        assert int(rt_ref.count) == int(rt_got.count), f"mission {mi}"
        c = int(rt_ref.count)
        for f in ("start", "end", "chars", "grep_hits"):
            np.testing.assert_array_equal(
                np.asarray(getattr(rt_ref, f))[:c],
                np.asarray(getattr(rt_got, f))[:c],
                f"m{mi} {f}",
            )


def test_swar_counts_path_matches_lanes_path():
    """The fused counts pass + raw-word slab re-derivation
    (flagship_swar_counts + extract_runs_swar_blocks) must produce the
    exact run tables of the jnp lanes + extract_runs."""
    from stringsext_tpu.ops.runs import extract_runs_swar_blocks

    ms = _missions()
    params = swar.swar_params(ms.v)
    rows = 64
    raw = _corpus(rows, 7)
    words = jnp.asarray(raw.view(np.int32).reshape(rows, 128))
    counts = swar.flagship_swar_counts(words, **params)
    eps = (
        dict(kind="utf8", af_iv=params["af_iv"], ubf_iv=params["ubf_iv"],
             grep=params["greps"][0]),
        dict(kind="utf16", cp_iv=params["cp_iv_le"], grep=params["greps"][1],
             be=False),
        dict(kind="utf16", cp_iv=params["cp_iv_be"], grep=params["greps"][2],
             be=True),
    )
    for mi, ep in enumerate(eps):
        ref = _lanes_runs(raw, ms[mi], 512)
        got = extract_runs_swar_blocks(
            words, counts[2 * mi], counts[2 * mi + 1], capacity=512, **ep
        )
        assert int(ref.count) == int(got.count), f"mission {mi}"
        assert bool(ref.overflow) == bool(got.overflow)
        c = int(ref.count)
        for f in ("start", "end", "chars", "grep_hits"):
            np.testing.assert_array_equal(
                np.asarray(getattr(ref, f))[:c],
                np.asarray(getattr(got, f))[:c],
                f"m{mi} {f}",
            )


def test_swar_counts_path_three_level_locate():
    """Inputs over 2 MiB (nb > 4096 blocks) take the THREE-level rank
    lookup in _runs_from_block_counts; run tables must still match the
    jnp-lanes reference exactly (capacity overflow included -
    random bytes are dense in valid UTF-16, so both paths truncate at
    the same first-capacity runs)."""
    from stringsext_tpu.ops.runs import extract_runs_swar_blocks

    ms = _missions()
    params = swar.swar_params(ms.v)
    rows = 6144  # 3 MiB: nsb = 96 > _SB
    raw = _corpus(rows, 11)
    raw[1 << 20 :] = 0  # sparse upper 2 MiB: runs end below capacity
    words = jnp.asarray(raw.view(np.int32).reshape(rows, 128))
    counts = swar.flagship_swar_counts(words, **params)
    eps = (
        dict(kind="utf8", af_iv=params["af_iv"], ubf_iv=params["ubf_iv"],
             grep=params["greps"][0]),
        dict(kind="utf16", cp_iv=params["cp_iv_le"], grep=params["greps"][1],
             be=False),
        dict(kind="utf16", cp_iv=params["cp_iv_be"], grep=params["greps"][2],
             be=True),
    )
    for cap in (1024, 4096):
        for mi, ep in enumerate(eps):
            ref = _lanes_runs(raw, ms[mi], cap)
            got = extract_runs_swar_blocks(
                words, counts[2 * mi], counts[2 * mi + 1], capacity=cap, **ep
            )
            assert int(ref.count) == int(got.count), f"cap {cap} mission {mi}"
            assert bool(ref.overflow) == bool(got.overflow)
            c = int(ref.count)
            for f in ("start", "end", "chars", "grep_hits"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(ref, f))[:c],
                    np.asarray(getattr(got, f))[:c],
                    f"cap {cap} m{mi} {f}",
                )

    # Independent oracle at this size with grep off: extract_runs goes
    # through _compact_runs (its own searchsorted locate), NOT the
    # hierarchical _runs_from_block_counts of swar_blocks above.
    af_w, ubf_w = filter_words(ms[0])
    lanes = classify.utf8_lanes(jnp.asarray(raw), len(raw))
    ind = extract_runs(
        lanes, jnp.asarray(af_w), jnp.asarray(ubf_w), jnp.int32(63),
        capacity=1024,
    )
    got = extract_runs_swar_blocks(
        words, counts[0], counts[1], capacity=1024, **eps[0]
    )
    assert int(ind.count) == int(got.count)
    c = int(ind.count)
    for f in ("start", "end", "chars", "grep_hits"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ind, f))[:c],
            np.asarray(getattr(got, f))[:c],
            f"oracle {f}",
        )


def test_swar_counts_mission_subsets():
    """swar_counts accepts arbitrary mission subsets (the generalized
    spec form used by the engine=device hot-block path) and must produce
    the same run tables as the jnp lanes for each mission."""
    from stringsext_tpu.ops.swar import swar_counts, swar_mission_spec
    from stringsext_tpu.ops.runs import extract_runs_swar_blocks

    ms = _missions()
    params = swar.swar_params(ms.v)
    rows = 64
    raw = _corpus(rows, 11)
    words = jnp.asarray(raw.view(np.int32).reshape(rows, 128))
    specs = [swar_mission_spec(m) for m in ms.v]
    assert all(sp is not None for sp in specs)
    eps = (
        dict(kind="utf8", af_iv=specs[0][1], ubf_iv=specs[0][2],
             grep=specs[0][3]),
        dict(kind="utf16", cp_iv=specs[1][2], grep=specs[1][3], be=False),
        dict(kind="utf16", cp_iv=specs[2][2], grep=specs[2][3], be=True),
    )
    # subsets: single utf8, single utf16be, utf8+utf16le pair
    for subset in ([0], [2], [0, 1]):
        counts = swar_counts(words, tuple(specs[i] for i in subset))
        assert counts.shape == (2 * len(subset), rows)
        for j, mi in enumerate(subset):
            ref = _lanes_runs(raw, ms[mi], 512)
            got = extract_runs_swar_blocks(
                words, counts[2 * j], counts[2 * j + 1], capacity=512,
                **eps[mi],
            )
            c = int(ref.count)
            assert c == int(got.count), f"subset {subset} mission {mi}"
            for f in ("start", "end", "chars", "grep_hits"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(ref, f))[:c],
                    np.asarray(getattr(got, f))[:c],
                    f"subset {subset} m{mi} {f}",
                )


def test_swar_sbyte_spec_matches_jnp_lanes():
    """Single-byte-encoding specs ("sbyte"): counts kernel + slab
    re-derivation must match the jnp single_byte_lanes + extract_runs
    reference run tables."""
    from stringsext_tpu.ops.swar import swar_counts, swar_mission_spec
    from stringsext_tpu.ops.runs import extract_runs_swar_blocks

    ms = Missions.new(
        flag_encoding=["KOI8-R", "x-user-defined"], flag_grep_char="63",
        flag_chars_min_nb="3",
    )
    rows = 32
    r = np.random.default_rng(13)
    raw = r.integers(0, 256, size=rows * 512, dtype=np.uint8)
    raw[:512] = 0
    raw[-512:] = 0
    msg = "Русский текст? here".encode("koi8-r")
    raw[3000 : 3000 + len(msg)] = np.frombuffer(msg, np.uint8)
    words = jnp.asarray(raw.view(np.int32).reshape(rows, 128))

    specs = tuple(swar_mission_spec(m) for m in ms.v)
    assert all(sp is not None and sp[0] == "sbyte" for sp in specs)
    counts = swar_counts(words, specs)
    for j, m in enumerate(ms.v):
        af_w, ubf_w = filter_words(m)
        lanes = classify.single_byte_lanes(
            jnp.asarray(raw), m.encoding_name, len(raw)
        )
        ref = extract_runs(
            lanes, jnp.asarray(af_w), jnp.asarray(ubf_w), jnp.int32(63),
            capacity=512,
        )
        got = extract_runs_swar_blocks(
            words, counts[2 * j], counts[2 * j + 1], kind="sbyte",
            acc_iv=specs[j][1], grep_iv=specs[j][2], capacity=512,
        )
        c = int(ref.count)
        assert c == int(got.count), f"{m.encoding_name}: {c} vs {int(got.count)}"
        assert c > 0
        for f in ("start", "end", "chars", "grep_hits"):
            np.testing.assert_array_equal(
                np.asarray(getattr(ref, f))[:c],
                np.asarray(getattr(got, f))[:c],
                f"{m.encoding_name} {f}",
            )


def test_interval_decomposition():
    from stringsext_tpu.ops.swar import decompose_intervals

    assert decompose_intervals(0b0, 8) == []
    assert decompose_intervals(0b1, 8) == [(0, 0)]
    assert decompose_intervals(0b0111_0110, 8) == [(1, 2), (4, 6)]
    # AF default = all minus ctrl: bytes 0x20..0x7E
    ms = _missions(grep=None)
    af_iv, ubf_iv = swar.utf8_lead_intervals(ms[0])
    assert af_iv == ((0x20, 0x7E),)
    assert ubf_iv == ((0xC2, 0xDF),)  # UBF Common


def test_utf16_surrogate_covering_interval_rejects_pairs():
    """UBF lead 0xED maps to cps 0xD000-0xDFFF, so filters like 'Asian'
    produce a BMP interval covering the surrogate range; the kernel's
    unit-test shortcut must still reject astral PAIRS there (their
    decoded cp >= 0x10000 passes no interval) - regression for the
    cp=u specialization wrongly testing the raw high surrogate."""
    import numpy as np
    import jax.numpy as jnp

    from stringsext_tpu.mission import Missions
    from stringsext_tpu.ops.swar import swar_counts, swar_mission_spec

    ms = Missions.new(
        flag_encoding=["utf-16le"], flag_unicode_block_filter="Asian"
    )
    spec = swar_mission_spec(ms.v[0])
    assert spec is not None
    assert any(lo <= 0xDFFF and hi >= 0xD800 for lo, hi in spec[2])

    text = ("\U0001F600" * 40).encode("utf-16-le")  # astral pairs only
    buf = np.zeros(4096, np.uint8)
    buf[: len(text)] = np.frombuffer(text, np.uint8)
    w = jnp.asarray(buf.view(np.int32).reshape(8, 128))
    counts = np.asarray(swar_counts(w, (spec,)))
    accepts = (counts[0] >> 20) & 0x3FF
    assert accepts.sum() == 0, accepts

    # and BMP chars inside the same filter still count
    text2 = ("日本語テスト寿司" * 8).encode("utf-16-le")
    buf2 = np.zeros(4096, np.uint8)
    buf2[: len(text2)] = np.frombuffer(text2, np.uint8)
    w2 = jnp.asarray(buf2.view(np.int32).reshape(8, 128))
    c2 = np.asarray(swar_counts(w2, (spec,)))
    assert ((c2[0] >> 20) & 0x3FF).sum() == len(text2) // 2


def test_unpadded_edge_runs_exact():
    """Accepted chars at the very stream edges, no zero padding (the
    entry()/bench calling convention): the counts-path run table must
    match the jnp-lanes oracle - regression for the old stream-edge
    halo WRAP, which suppressed the first run's start / last run's end
    and misaligned every rank in between."""
    import numpy as np
    import jax.numpy as jnp

    from stringsext_tpu.mission import Missions
    from stringsext_tpu.ops.classify import utf8_lanes
    from stringsext_tpu.ops.swar import flagship_swar_counts, swar_params
    from stringsext_tpu.ops.runs import (
        extract_runs,
        extract_runs_swar_blocks,
        filter_words,
    )

    ms = Missions.new(flag_encoding=["UTF-8", "utf-16le", "utf-16be"])
    p = swar_params(ms.v)
    n = 64 * 1024
    data = np.full(n, ord("A"), np.uint8)
    data[30000] = 0x00  # one run break
    w = jnp.asarray(data.view(np.int32).reshape(-1, 128))

    counts = flagship_swar_counts(w, **p)
    rt = extract_runs_swar_blocks(
        w, counts[0], counts[1], capacity=16,
        kind="utf8", af_iv=p["af_iv"], ubf_iv=p["ubf_iv"],
        grep=p["greps"][0],
    )
    af_w, ubf_w = filter_words(ms.v[0])
    ref = extract_runs(
        utf8_lanes(jnp.asarray(data), n), jnp.asarray(af_w),
        jnp.asarray(ubf_w), jnp.int32(-1), capacity=16,
    )
    assert int(rt.count) == int(ref.count) == 2
    for f in ("start", "end", "chars"):
        got = np.asarray(getattr(rt, f))[:2]
        want = np.asarray(getattr(ref, f))[:2]
        np.testing.assert_array_equal(got, want, err_msg=f)


def test_swar_counts_in_kernel_xor():
    """swar_counts(w, xor_word=x) + xor-aware extraction must equal
    scanning the pre-XORed stream (the bench's anti-hoisting path)."""
    from stringsext_tpu.ops.runs import extract_runs_swar_blocks

    ms = _missions()
    params = swar.swar_params(ms.v)
    rows = 32
    raw = _corpus(rows, 11)
    x = np.int32(0x01010101)
    words = jnp.asarray(raw.view(np.int32).reshape(rows, 128))
    words_x = jnp.asarray((raw ^ 1).view(np.int32).reshape(rows, 128))

    c_ref = np.asarray(swar.flagship_swar_counts(words_x, **params))
    c_got = np.asarray(swar.flagship_swar_counts(
        words, xor_word=x, **params
    ))
    np.testing.assert_array_equal(c_ref, c_got)

    eps = (
        dict(kind="utf8", af_iv=params["af_iv"], ubf_iv=params["ubf_iv"],
             grep=params["greps"][0]),
        dict(kind="utf16", cp_iv=params["cp_iv_le"], grep=params["greps"][1],
             be=False),
        dict(kind="utf16", cp_iv=params["cp_iv_be"], grep=params["greps"][2],
             be=True),
    )
    for mi, ep in enumerate(eps):
        ref = extract_runs_swar_blocks(
            words_x, c_ref[2 * mi], c_ref[2 * mi + 1], capacity=256, **ep
        )
        got = extract_runs_swar_blocks(
            words, c_got[2 * mi], c_got[2 * mi + 1], capacity=256,
            xor_word=jnp.int32(x), **ep
        )
        assert int(ref.count) == int(got.count), f"mission {mi}"
        c = int(ref.count)
        for f in ("start", "end", "chars", "grep_hits"):
            np.testing.assert_array_equal(
                np.asarray(getattr(ref, f))[:c],
                np.asarray(getattr(got, f))[:c],
                f"m{mi} {f}",
            )


def test_hot_only_many_utf16_missions():
    """hot_only fuses missions of ANY kind - more than 4 UTF-16
    missions must not hit the claim-shift pair-bit budget (regression:
    an assert rejected >4 UTF-16 missions per group)."""
    from stringsext_tpu.ops.swar import (
        swar_counts,
        swar_mission_spec,
    )

    ms = Missions.new(
        flag_encoding=["UTF-8", "utf-16le", "utf-16be", "utf-16le,6",
                       "utf-16be,6", "utf-16le,10"]
    )
    specs = tuple(swar_mission_spec(m) for m in ms.v)
    assert all(s is not None for s in specs)
    rows = 16
    raw = _corpus(rows, 3)
    words = jnp.asarray(raw.view(np.int32).reshape(rows, 128))
    c_all = np.asarray(
        swar_counts(words, specs, hot_only=True)
    )
    # Each mission's accept counts must equal its solo hot_only pass.
    for mi, sp in enumerate(specs):
        c_solo = np.asarray(
            swar_counts(words, (sp,), hot_only=True)
        )
        np.testing.assert_array_equal(c_all[2 * mi], c_solo[0], f"m{mi}")
        np.testing.assert_array_equal(c_all[2 * mi + 1], c_solo[1])


def test_swar_fields_exhaustive_pairs_and_boundaries():
    """Deterministic stressor for the SWAR byte algebra (the round-4
    mask-identity rewrites live here): ALL 65536 2-byte sequences plus
    targeted UTF-8 lead x second-byte boundary quads (E0/ED/F0/F4
    special ranges, C1/C2/DF/EF/F5 edges) must match the jnp
    classification lanes field for field."""
    pairs = np.array(
        [[i, j] for i in range(256) for j in range(256)], np.uint8
    ).reshape(-1)
    quads = []
    for lead in (0xE0, 0xED, 0xEF, 0xF0, 0xF4, 0xF5, 0xC1, 0xC2, 0xDF):
        for b2 in (0x7F, 0x80, 0x8F, 0x90, 0x9F, 0xA0, 0xBF, 0xC0):
            for b3 in (0x80, 0xBF, 0x41):
                quads.extend([lead, b2, b3, 0x41])
    raw = np.concatenate([pairs, np.array(quads, np.uint8)])
    raw = np.concatenate(
        [raw, np.zeros((-len(raw)) % 512, np.uint8)]).astype(np.uint8)
    rows = len(raw) // 512
    n = len(raw)
    ms = _missions()
    params = swar.swar_params(ms.v)
    o8, ole, obe = _field_words(raw, params)
    sl = slice(4, n - 4)
    for mi, ow in enumerate([o8, ole, obe]):
        ow = np.asarray(ow).reshape(-1)
        af_w, ubf_w = filter_words(ms[mi])
        if mi == 0:
            lanes = classify.utf8_lanes(jnp.asarray(raw), n)
            f = _unpack_bytes(ow, n)
        else:
            lanes = classify.utf16_lanes(jnp.asarray(raw), mi == 2, n)
            f = _unpack_units(ow, n)
        acc = np.asarray(accept_mask(
            lanes, jnp.asarray(af_w), jnp.asarray(ubf_w)))
        st = np.asarray(lanes.start & ~lanes.pending)
        ln = np.asarray(lanes.length)
        np.testing.assert_array_equal(
            ((f & 1) != 0)[sl], acc[sl], f"m{mi} accept")
        np.testing.assert_array_equal(
            (((f >> 5) & 1) != 0)[sl], st[sl], f"m{mi} start")
        np.testing.assert_array_equal(
            np.where(((f >> 5) & 1) != 0, (f >> 1) & 7, 0)[sl],
            np.where(st, ln, 0)[sl], f"m{mi} len")


def test_range_mask_exhaustive_all_bytes():
    """The four _range_mask special cases (full, equality, hi=255,
    lo=0, generic) verified for every byte value 0..255 against a
    direct oracle, over a corpus containing all byte values in all
    four word slots."""
    from stringsext_tpu.ops.swar import M01, _range_mask

    raw = np.arange(1024, dtype=np.uint8)  # every value in every slot
    for i in range(4):
        raw[i::4] = (np.arange(256) + 64 * i) % 256
    w = jnp.asarray(raw.view(np.int32))
    for lo, hi in [(0, 255), (7, 7), (0, 0), (255, 255), (0x80, 255),
                   (0xC0, 255), (0, 0x1F), (0x20, 0x7E), (0xA1, 0xDF),
                   (154, 154), (140, 144)]:
        got = np.asarray(_range_mask(w, lo, hi))
        expect = np.zeros(1024 // 4, np.int64)
        for b in range(4):
            v = raw[b::4].astype(np.int64)
            expect |= ((v >= lo) & (v <= hi)).astype(np.int64) << (8 * b)
        np.testing.assert_array_equal(
            got.astype(np.int64) & np.int64(M01), expect, f"[{lo},{hi}]")
