"""CJK hot-range scanning: the plausible-byte hot/cold map
(ops/specs.cjk_hot_spec) + the native emitter's ground-byte
cursor alignment (emitter.cpp align_cursor, kinds 4-8) must reproduce
the full scan byte-for-byte.

The reference has no analog (it always decodes the whole stream,
finding_collection.rs:84-342); these tests pin the exactness contract
of the device window-skipping extension for the
non-self-synchronizing CJK encodings."""

import numpy as np
import pytest

from stringsext_tpu.input import LoadedStream
from stringsext_tpu.mission import Missions
from stringsext_tpu.ops.swar import cjk_hot_spec
from stringsext_tpu.run import _scan_arrays


@pytest.fixture(autouse=True)
def _hot_map_path(monkeypatch):
    """These tests target the hot/cold-map machinery; the run-table
    feed (default-on under engine=device) would bypass it."""
    monkeypatch.setenv("STRINGSEXT_RUNTABLE_FEED", "0")

CJK = [
    ("euc-kr", "euc-kr", "안녕하세요 세계의 문자열"),
    ("shift_jis", "Shift_JIS", "こんにちは世界のテスト"),
    ("euc_jp", "EUC-JP", "日本語のテキスト標本"),
    ("gb18030", "gb18030", "你好世界示例字符串\U00020000"),
    ("gb18030", "GBK", "你好世界示例字符串"),
    ("big5", "Big5", "繁體中文測試字串"),
    # modal: escapes + mode switches sit right next to cold spans
    ("iso2022_jp", "ISO-2022-JP", "mode 日本語 switch ascii 漢字"),
]


def _sparse_corpus(codec, text, seed):
    """Mostly-zero stream with random islands, CJK chain-byte noise and
    planted strings (some adjacent to cold spans, some mid-noise)."""
    rng = np.random.default_rng(seed)
    data = bytearray(96 * 1024)
    t = text.encode(codec)
    for off in (3, 5000, 40960 - len(t) // 2, 70001):
        data[off : off + len(t)] = t
    # chain-byte noise: long 0x81-0xFE runs ending right before / at
    # block boundaries (the align_cursor ground-byte backscan case)
    for off, ln in ((9800, 500), (20480 - 37, 37), (51200, 2048)):
        data[off : off + ln] = rng.integers(0x81, 0xFF, ln, np.uint8).tobytes()
    for off in (30000, 60000):
        data[off : off + 256] = rng.integers(0, 256, 256, np.uint8).tobytes()
    return bytes(data)


def _scan(data, engine, enc, **kw):
    ms = Missions.new(flag_encoding=[enc], **kw)
    arr = np.frombuffer(data, np.uint8)
    stream = LoadedStream(data=arr, spans=[(0, 0, len(arr))])
    (m, r, sb) = _scan_arrays(stream, ms, engine)[0]
    return {k: v.tolist() for k, v in r.items()} | {"s": bytes(sb)}


@pytest.mark.parametrize("codec,enc,text", CJK)
@pytest.mark.parametrize("ubf", [None, "All"])
def test_cjk_tpu_engine_matches_native(codec, enc, text, ubf):
    data = _sparse_corpus(codec, text, seed=hash(enc) % 2**32)
    kw = dict(flag_unicode_block_filter=ubf) if ubf else {}
    a = _scan(data, "native", enc, **kw)
    b = _scan(data, "device", enc, **kw)
    assert a == b


@pytest.mark.parametrize("codec,enc,text", CJK)
@pytest.mark.parametrize("ubf", [None, "All", "Asian"])
def test_plausible_bytes_cover_accepted_chars(codec, enc, text, ubf):
    """Invariant behind the hot/cold map: every byte of every
    filter-ACCEPTED char lies inside the plausible-byte set, so
    zero-plausible blocks are provably cold. (Rejected chars' bytes
    need not be plausible - that is the whole point of the filter-aware
    set.)"""
    kw = dict(flag_unicode_block_filter=ubf) if ubf else {}
    ms = Missions.new(flag_encoding=[enc], **kw)
    m = ms.v[0]
    spec = cjk_hot_spec(m)
    assert spec is not None and spec[0] == "sbyte"
    plausible = np.zeros(256, bool)
    for lo, hi in spec[1]:
        plausible[lo : hi + 1] = True

    def accepted(cp):
        if cp < 0x80:
            return m.filter.pass_af_filter(cp)
        if cp < 0x800:
            lead = 0xC0 | (cp >> 6)
        elif cp < 0x10000:
            lead = 0xE0 | (cp >> 12)
        else:
            lead = 0xF0 | (cp >> 18)
        return m.filter.pass_ubf_filter(lead)

    checked = 0
    for ch in text + "ABC09 ~":
        try:
            raw = ch.encode(codec)
        except UnicodeEncodeError:
            continue
        if accepted(ord(ch)):
            checked += 1
            assert plausible[np.frombuffer(raw, np.uint8)].all(), (ch, raw)
    # NB "All" prefix-resolves to "All-Asian" (mission.rs alias order),
    # so only "Asian" is guaranteed to accept the CJK sample chars.
    if ubf == "Asian":
        assert checked > len("ABC09 ~")  # some CJK chars were exercised


@pytest.mark.parametrize("cold", [b"\xfe", b"\x00", b"\x0e"])
@pytest.mark.parametrize("gap", [1, 120, 128, 129, 2048, 4096])
def test_iso2022_output_flag_across_cold_spans(cold, gap):
    """The redundant-escape error depends on output_flag, which a
    rejected control decode resets - the emitter must not skip a window
    while the flag is set (a second escape after a cold span must still
    report the error / silence exactly like the full scan). Gap sizes
    straddle the 2*line_max window size and block boundaries."""
    head = b"JIS text: \x1b$B" + "日本".encode("iso2022_jp")[3:-3]
    for mid in (cold * gap, b"\x1b(B" + cold * gap):
        data = (
            b"\x00" * 700 + head + mid + b"\x1b$B"
            + "漢字".encode("iso2022_jp")[3:-3] + b"\x1b(B tail ascii str"
            + b"\x00" * 3000
        )
        kw = dict(flag_unicode_block_filter="Asian")
        a = _scan(data, "native", "ISO-2022-JP", **kw)
        b = _scan(data, "device", "ISO-2022-JP", **kw)
        assert a == b, (cold, gap, mid[:8])


@pytest.mark.parametrize("codec,enc,text", CJK)
def test_adversarial_byte_granular_hot_ranges(codec, enc, text):
    """Tightest legal hot ranges (byte-granular plausible spans, +-8)
    force skip boundaries right next to finding edges and inside
    chain-byte runs - the align_cursor stress case."""
    from stringsext_tpu import native
    from stringsext_tpu.input import slice_table

    data = _sparse_corpus(codec, text, seed=7)
    arr = np.frombuffer(data, np.uint8)
    stream = LoadedStream(data=arr, spans=[(0, 0, len(arr))])
    ms = Missions.new(flag_encoding=[enc])
    spec = cjk_hot_spec(ms.v[0])
    plausible = np.zeros(256, bool)
    for lo, hi in spec[1]:
        plausible[lo : hi + 1] = True
    hot = plausible[arr]
    d = np.diff(hot.astype(np.int8), prepend=0, append=0)
    s = np.maximum(np.flatnonzero(d == 1).astype(np.int64) - 8, 0)
    e = np.minimum(np.flatnonzero(d == -1).astype(np.int64) + 8, len(arr))
    merged_s, merged_e = [], []  # merge overlaps after the +-8 expand
    for k in range(len(s)):
        if merged_e and s[k] <= merged_e[-1]:
            merged_e[-1] = max(merged_e[-1], e[k])
        else:
            merged_s.append(s[k])
            merged_e.append(e[k])
    hot_ranges = (np.array(merged_s, np.int64), np.array(merged_e, np.int64))

    sl = slice_table(stream)
    full = native.native_scan(ms.v[0], stream.data, *sl)
    skip = native.native_scan(ms.v[0], stream.data, *sl, hot_ranges=hot_ranges)

    fr, fs = full
    sr, ss = skip
    assert bytes(fs) == bytes(ss)
    for k in fr:
        assert fr[k].tolist() == sr[k].tolist(), k
