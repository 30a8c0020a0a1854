"""Device run-table feed (STRINGSEXT_RUNTABLE_FEED=1): the emitter
consumes EXACT device-extracted accepted runs plus the device-decoded
UTF-8 payload (docs/KERNELS.md design 1 - the on-device analog of the
reference's decode loop, finding_collection.rs:84-342). Covers EVERY
kind: UTF-8 / UTF-16LE/BE / single-byte / the five CJK encodings /
modal ISO-2022-JP (whose mode chain is a device prefix scan,
ops/classify_iso2022.py). Interpret-mode differential pins
byte-identity; a corrupted-payload probe proves the fast lane actually
consumes the payload (not silently falling back).
"""

import io
import os

import numpy as np
import pytest

from stringsext_tpu import native
from stringsext_tpu.cli import parse_args
from stringsext_tpu.input import LoadedStream, slice_table
from stringsext_tpu.mission import Missions
from stringsext_tpu.ops.device_events import _utf8_encode_cps, runtable_feed
from stringsext_tpu.run import run

pytestmark = pytest.mark.skipif(
    native.get_lib() is None, reason="no native toolchain"
)

rng = np.random.default_rng(21)

# (encoding label, dense text in that encoding)
KIND_TEXTS = [
    ("UTF-8", lambda: ("Привет мир! ёлочка " * 40).encode("utf-8")),
    ("UTF-8", lambda: ("你好世界，这是一个测试。" * 30).encode("utf-8")),
    ("UTF-16LE", lambda: ("hello 世界 \U0001d11e music " * 30).encode("utf-16-le")),
    ("UTF-16BE", lambda: ("Привет 世界 " * 40).encode("utf-16-be")),
    ("KOI8-R", lambda: ("в лесу родилась ёлочка " * 30).encode("koi8_r")),
    ("EUC-KR", lambda: ("안녕하세요 세계 " * 30).encode("euc_kr")),
    ("Shift_JIS", lambda: ("こんにちは世界。テスト" * 30).encode("shift_jis")),
    ("EUC-JP", lambda: ("こんにちは世界。テスト" * 30).encode("euc_jp")),
    ("Big5", lambda: ("你好世界這是測試" * 30).encode("big5")),
    ("gb18030", lambda: ("你好，测试。\U0001d11e" * 30).encode("gb18030")),
]


def _corpus(text=None, n=256 * 1024):
    data = bytearray(rng.integers(0, 256, n, np.uint8).tobytes())
    if text is None:
        text = "в лесу родилась ёлочка, в лесу она росла ".encode("koi8_r")
    long_run = text * max(1, 4000 // len(text))
    for off in range(2048, n - len(long_run) - 64, 16384):
        data[off : off + len(long_run)] = long_run
    # short runs, runs cut by undefined/rejected bytes, window-edge runs
    for off in range(1024, n - 256, 7000):
        data[off : off + 3] = "\xd0\xd0!".encode("latin-1")
    return bytes(data)


def test_utf8_encode_cps_matches_python():
    cps = np.array(
        [0x41, 0x7F, 0x80, 0x7FF, 0x800, 0x2126, 0xFFFD, 0x451,
         0x10000, 0x1D11E, 0x10FFFF], np.int32
    )
    pay, co = _utf8_encode_cps(cps)
    expect = "".join(chr(c) for c in cps).encode("utf-8")
    assert pay.tobytes() == expect
    offs = np.cumsum([0] + [len(chr(c).encode()) for c in cps])
    assert np.array_equal(co, offs)


def test_feed_builder_matches_oracle():
    """Single-byte runs are exactly the maximal accepted-char runs; the
    payload is the concatenated UTF-8 of the accepted chars; the slot
    tables carry per-char input/payload offsets plus per-run
    sentinels."""
    blob = _corpus(n=64 * 1024)
    argv = ["-t", "x", "-e", "KOI8-R", "-n", "4", "/dev/null"]
    m = Missions.from_args(parse_args(argv)).v[0]
    data = np.frombuffer(blob, np.uint8)
    feed = runtable_feed(data, m)
    assert feed is not None
    rs, re, cb, co, ip, pay = feed
    # oracle accept mask from the decode table + filters
    from stringsext_tpu.encodings import full_byte_table

    tbl = full_byte_table(m.encoding_name)
    cp = tbl[data]
    f = m.filter
    acc = np.zeros(len(data), bool)
    for b in range(256):
        c = int(tbl[b])
        if c < 0:
            continue
        if c < 0x80:
            ok = bool((f.af >> c) & 1)
        else:
            lead = 0xC0 | (c >> 6) if c < 0x800 else 0xE0 | (c >> 12)
            ok = bool((f.ubf >> (lead & 0x3F)) & 1)
        if ok:
            acc |= data == b
    d = np.diff(acc.astype(np.int8), prepend=0, append=0)
    assert np.array_equal(rs, np.flatnonzero(d == 1))
    assert np.array_equal(re, np.flatnonzero(d == -1))
    expect_pay = "".join(chr(c) for c in cp[acc]).encode("utf-8")
    assert pay.tobytes() == expect_pay
    # slot structure: n_runs+1 bases; per-run slots = chars + sentinel
    nch = re - rs  # single-byte: 1 byte = 1 char
    assert len(cb) == len(rs) + 1
    assert np.array_equal(np.diff(cb), nch + 1)
    # ip: char k of run r at rs[r]+k; sentinel = re[r]
    for r in (0, len(rs) // 2, len(rs) - 1):
        s0, s1 = int(cb[r]), int(cb[r + 1])
        assert np.array_equal(
            ip[s0 : s1 - 1], np.arange(rs[r], re[r], dtype=np.int64))
        assert ip[s1 - 1] == re[r]
    # payload offsets are globally cumulative; sentinel closes the run
    assert co[0] == 0 and co[int(cb[-1]) - 1] == len(pay)


def test_feed_builder_utf8_payload_is_input():
    """UTF-8 feed: payload is None (the input itself), co == ip, and
    each run's slots step by the chars' UTF-8 byte lengths."""
    blob = _corpus(("Привет мир! " * 40).encode("utf-8"))
    argv = ["-t", "x", "-e", "UTF-8", "-n", "4", "/dev/null"]
    m = Missions.from_args(parse_args(argv)).v[0]
    data = np.frombuffer(blob, np.uint8)
    feed = runtable_feed(data, m)
    assert feed is not None
    rs, re, cb, co, ip, pay = feed
    assert pay is None
    assert np.array_equal(co, ip)
    # slots within each run are strictly increasing by 1..4 bytes
    for r in (0, len(rs) // 2):
        s0, s1 = int(cb[r]), int(cb[r + 1])
        steps = np.diff(ip[s0:s1])
        assert ((steps >= 1) & (steps <= 4)).all()
        assert ip[s0] == rs[r] and ip[s1 - 1] == re[r]


@pytest.mark.parametrize("enc,text", KIND_TEXTS,
                         ids=[f"{e}-{i}" for i, (e, _t) in
                              enumerate(KIND_TEXTS)])
def test_feed_scan_identity_all_kinds(enc, text):
    """Fed scan == unfed scan, bit for bit, for every feed kind; the
    device builder == the jax-free host twin builder."""
    blob = _corpus(text())
    argv = ["-t", "x", "-e", enc, "-n", "4", "/dev/null"]
    m = Missions.from_args(parse_args(argv)).v[0]
    data = np.frombuffer(blob, np.uint8)
    sl = slice_table(LoadedStream(data, [(1, 0, len(data))]))
    dev = runtable_feed(data, m, device=True)
    host = runtable_feed(data, m, device=False)
    assert dev is not None and host is not None
    for a, b in zip(dev, host):
        if a is None or b is None:
            assert a is None and b is None
        else:
            assert np.array_equal(a, b)
    base_res, base_sb = native.native_scan(m, data, *sl)
    f_res, f_sb = native.native_scan(m, data, *sl, runtable_feed=dev)
    assert bytes(f_sb) == bytes(base_sb)
    for k in base_res:
        assert np.array_equal(base_res[k], f_res[k]), k
    assert len(base_res["position"]) > 100  # real findings


@pytest.mark.parametrize("argv_extra", [
    ["-e", "KOI8-R"],
    ["-e", "KOI8-R", "-e", "UTF-8"],
    ["-e", "KOI8-R", "-q", "10"],  # small windows: many edge cases
    ["-e", "windows-1252", "-e", "KOI8-R", "-n", "6"],
    ["-e", "UTF-8", "-e", "UTF-16LE"],
    ["-e", "Shift_JIS", "-e", "gb18030", "-e", "UTF-8"],
])
def test_feed_end_to_end_byte_identical(tmp_path, monkeypatch, argv_extra):
    p = tmp_path / "feed.bin"
    mixed = (_corpus() + _corpus(("héllo wörld " * 50).encode("utf-8"))
             + _corpus(("国際化テスト " * 40).encode("shift_jis")))
    p.write_bytes(mixed)
    argv = ["-t", "x", "-n", "4"] + argv_extra + [str(p)]
    buf_a = io.BytesIO()
    assert run(parse_args(argv), out=buf_a, engine="auto") == 0
    monkeypatch.setenv("STRINGSEXT_RUNTABLE_FEED", "1")
    buf_t = io.BytesIO()
    assert run(parse_args(argv), out=buf_t, engine="device") == 0
    assert buf_t.getvalue() == buf_a.getvalue()
    assert buf_a.getvalue().count(b"\n") > 100  # real findings


@pytest.mark.parametrize("enc,extra,text", [
    ("KOI8-R", [], None),
    # all-bits UBF: long accepted runs under the default block filter
    # are rare for UTF-16 (the filter exists to cut false positives);
    # accepting every lead makes the planted text one long run so full
    # windows engage the lane
    ("UTF-16LE", ["-u", "0xffffffffffffffff"],
     lambda: ("hello 世界 music " * 30).encode("utf-16-le")),
    ("Shift_JIS", ["-u", "0xffffffffffffffff"],
     lambda: ("こんにちは世界。テスト" * 30).encode("shift_jis")),
])
def test_feed_lane_actually_consumes_payload(enc, extra, text):
    """Engagement proof: scanning with a CORRUPTED payload must change
    the output (the lane read it), and with the intact payload must
    equal the no-feed scan byte-for-byte."""
    blob = _corpus(None if text is None else text(), n=128 * 1024)
    argv = ["-t", "x", "-e", enc, "-n", "4"] + extra + ["/dev/null"]
    m = Missions.from_args(parse_args(argv)).v[0]
    data = np.frombuffer(blob, np.uint8)
    stream = LoadedStream(data, [(1, 0, len(data))])
    sl = slice_table(stream)
    feed = runtable_feed(data, m)
    assert feed is not None and len(feed[0]) > 10

    def scan(fd):
        res, sb = native.native_scan(m, data, *sl, runtable_feed=fd)
        return {k: np.asarray(v).copy() for k, v in res.items()}, bytes(sb)

    base_res, base_sb = scan(None)
    feed_res, feed_sb = scan(feed)
    assert base_sb == feed_sb
    for k in base_res:
        assert np.array_equal(base_res[k], feed_res[k]), k

    corrupt = list(feed)
    corrupt[5] = feed[5] ^ np.uint8(0x01)  # flip payload bits
    _res, bad_sb = scan(tuple(corrupt))
    assert bad_sb != base_sb, (
        "corrupted payload produced identical output - the feed lane "
        "never engaged"
    )


def test_feed_lane_engages_for_utf8_inref():
    """UTF-8 engagement proof: the payload IS the input, so corrupt the
    slot tables instead - shifting every payload offset by one byte
    must change the output iff the lane engaged."""
    blob = _corpus(("Привет мир! ёлочка " * 40).encode("utf-8"))
    argv = ["-t", "x", "-e", "UTF-8", "-n", "4", "/dev/null"]
    m = Missions.from_args(parse_args(argv)).v[0]
    data = np.frombuffer(blob, np.uint8)
    sl = slice_table(LoadedStream(data, [(1, 0, len(data))]))
    feed = runtable_feed(data, m)
    assert feed is not None and feed[5] is None
    _res, base_sb = native.native_scan(m, data, *sl)
    corrupt = list(feed)
    corrupt[3] = np.maximum(feed[3] - 1, 0)  # payload offsets only
    _res2, bad_sb = native.native_scan(
        m, data, *sl, runtable_feed=tuple(corrupt))
    assert bytes(bad_sb) != bytes(base_sb), (
        "corrupted payload offsets produced identical output - the "
        "UTF-8 feed lane never engaged"
    )


def test_feed_host_builder_matches_device():
    """runtable_feed(device=False) - the jax-free builder the ASan fuzz
    drives the C lane with - must produce arrays identical to the
    device-lanes builder (extras included)."""
    blob = _corpus(n=64 * 1024)
    argv = ["-t", "x", "-e", "KOI8-R", "-n", "4", "/dev/null"]
    m = Missions.from_args(parse_args(argv)).v[0]
    data = np.frombuffer(blob, np.uint8)
    dev = runtable_feed(data, m, device=True, with_extras=True)
    host = runtable_feed(data, m, device=False, with_extras=True)
    assert dev is not None and host is not None
    for a, b in zip(dev[0], host[0]):
        if a is None or b is None:
            assert a is None and b is None
        else:
            assert np.array_equal(a, b)
    for a, b in zip(dev[1], host[1]):
        assert np.array_equal(a, b)


def _assert_feeds_equal(dev, host):
    for a, b in zip(dev[0] + dev[1], host[0] + host[1]):
        if a is None or b is None:
            assert a is None and b is None
        else:
            assert np.array_equal(a, b)


@pytest.mark.parametrize("enc,text", KIND_TEXTS,
                         ids=[f"{e}-{i}" for i, (e, _t) in
                              enumerate(KIND_TEXTS)])
def test_feed_windows_match_whole_buffer(enc, text, monkeypatch):
    """The device feed classifies in bounded windows (1.5 KiB pieces
    here, so ~40 window seams cut chars, surrogate pairs and CJK pairs at every
    phase); the carried chain entry and report maximum make the result
    equal to the whole-buffer host builder, extras included."""
    from stringsext_tpu.ops import device_events

    monkeypatch.setattr(device_events, "_FEED_PIECE", 1536)
    data = np.frombuffer(_corpus(text(), n=64 * 1024), np.uint8)
    m = Missions.from_args(parse_args(
        ["-t", "x", "-e", enc, "-n", "4", "/dev/null"])).v[0]
    dev = runtable_feed(data, m, device=True, with_extras=True)
    host = runtable_feed(data, m, device=False, with_extras=True)
    assert dev is not None and len(dev[0][0]) > 100
    _assert_feeds_equal(dev, host)


@pytest.mark.parametrize("argv_extra", [
    ["-e", "UTF-8", "-e", "UTF-16LE", "-e", "UTF-16BE"],
    ["-e", "Shift_JIS", "-e", "KOI8-R", "-e", "gb18030"],
])
def test_feed_windows_end_to_end(tmp_path, monkeypatch, argv_extra):
    """A buffered input many feed windows long (64 KiB pieces here)
    scans byte-identically to the host engine; every mission is fed,
    so the counts pass does not run at all."""
    from stringsext_tpu import run as R
    from stringsext_tpu.ops import device_events

    p = tmp_path / "win.bin"
    p.write_bytes(_corpus() + _corpus(("国際化テスト " * 40).encode(
        "shift_jis")) + _corpus(("héllo wörld " * 50).encode("utf-16-le")))
    argv = ["-t", "x", "-n", "4"] + argv_extra + [str(p)]
    buf_a = io.BytesIO()
    assert run(parse_args(argv), out=buf_a, engine="auto") == 0
    monkeypatch.setattr(device_events, "_FEED_PIECE", 64 * 1024)
    monkeypatch.setattr(R, "_device_hot_ranges_swar",
                        lambda *a, **k: pytest.fail("fed missions need no "
                                                    "counts pass"))
    buf_t = io.BytesIO()
    assert run(parse_args(argv), out=buf_t, engine="device") == 0
    assert buf_t.getvalue() == buf_a.getvalue()
    assert buf_a.getvalue().count(b"\n") > 100


@pytest.mark.parametrize("shift", [-5, -3, -2, -1, 0, 1, 2])
def test_feed_windows_iso2022_state_across_seams(shift, monkeypatch):
    """ISO-2022-JP escapes placed on every window seam at each phase:
    a mode switch, a jis0208 pair and a redundant-escape error (two
    escapes with no data between) straddle the seam, so the carried
    mode and flag decide the next window's decode."""
    from stringsext_tpu.ops import device_events

    piece = 1536
    monkeypatch.setattr(device_events, "_FEED_PIECE", piece)
    r = np.random.default_rng(17 + shift)
    n = 48 * 1024
    data = bytearray(r.integers(0, 256, n, np.uint8).tobytes())
    jis = "国際化".encode("iso2022_jp")[3:-3]
    shapes = [b"\x1b$B" + jis + b"\x1b(B", b"\x1b(B\x1b(B" + b"ok text",
              b"\x1b(J\x1b(B\x1b$B" + jis, b"plain ascii \x1b$@" + jis]
    for k, c in enumerate(range(piece, n - 64, piece)):
        blk = shapes[k % len(shapes)]
        o = c - len(blk) // 2 + shift
        data[o:o + len(blk)] = blk
    data = np.frombuffer(bytes(data), np.uint8)
    m = Missions.from_args(parse_args(
        ["-t", "x", "-e", "ISO-2022-JP", "-n", "2", "/dev/null"])).v[0]
    dev = runtable_feed(data, m, device=True, with_extras=True)
    host = runtable_feed(data, m, device=False, with_extras=True)
    assert dev is not None
    _assert_feeds_equal(dev, host)


def _iso_corpus(n=256 * 1024, seed=11):
    """Random bytes + planted ISO-2022-JP blocks (jis0208 / katakana /
    Roman segments) + escapes scattered in COLD regions: mode switches,
    invalid escapes (pushback-clamped re-decodes), redundant escapes -
    every mode/phase-dependent shape the state_hot map must keep hot
    for the window skipper to stay sound."""
    r = np.random.default_rng(seed)
    data = bytearray(r.integers(0, 256, n, np.uint8).tobytes())
    text = "こんにちは世界。国際化テストです。".encode("iso2022_jp")
    kat = b"\x1b(I" + bytes(list(range(0x21, 0x5F)) * 6) + b"\x1b(B"
    for off in range(2048, n - 4096, 16384):
        blk = [b"\x1b$B" + text[3:-3] * 12 + b"\x1b(B", kat,
               b"\x1b(Jroman text with \\ and ~ chars " * 8 + b"\x1b(B"
               ][(off // 16384) % 3]
        data[off:off + len(blk)] = blk
    for off in range(5000, n - 16, 23456):
        data[off:off + 3] = b"\x1b$B"  # cold-region mode switch
    for off in range(9000, n - 16, 31111):
        data[off:off + 2] = b"\x1bX"  # invalid escape (pushback 1)
    for off in range(12000, n - 16, 37999):
        data[off:off + 6] = b"\x1b(B\x1b(B"  # redundant-escape error
    return bytes(data)


@pytest.mark.parametrize("extra", [
    [], ["-u", "0xffffffffffffffff"], ["-n", "2"], ["-q", "10"],
])
def test_feed_scan_identity_iso2022(extra):
    """Modal ISO-2022-JP: fed scan == unfed scan bit for bit, and the
    device lanes builder == the jax-free host twin (extras included -
    the state_hot mask that keeps mode/phase-dependent bytes hot)."""
    blob = _iso_corpus()
    argv = ["-t", "x", "-e", "ISO-2022-JP", "-n", "4"] + extra + [
        "/dev/null"]
    m = Missions.from_args(parse_args(argv)).v[0]
    data = np.frombuffer(blob, np.uint8)
    sl = slice_table(LoadedStream(data, [(1, 0, len(data))]))
    dev = runtable_feed(data, m, device=True, with_extras=True)
    host = runtable_feed(data, m, device=False, with_extras=True)
    assert dev is not None and host is not None
    for a, b in zip(dev[0], host[0]):
        if a is None or b is None:
            assert a is None and b is None
        else:
            assert np.array_equal(a, b)
    for a, b in zip(dev[1], host[1]):
        assert np.array_equal(a, b)
    base_res, base_sb = native.native_scan(m, data, *sl)
    f_res, f_sb = native.native_scan(m, data, *sl, runtable_feed=dev[0])
    assert bytes(f_sb) == bytes(base_sb)
    for k in base_res:
        assert np.array_equal(base_res[k], f_res[k]), k
    assert len(base_res["position"]) > 100


def test_feed_lane_engages_for_iso2022():
    """Engagement proof for the modal kind: long single-mode jis0208
    runs (no ASCII chars -> no mode switches inside) + all-bits UBF so
    full windows lie inside one run; a corrupted payload must change
    the output."""
    rng2 = np.random.default_rng(7)
    n = 128 * 1024
    data = bytearray(rng2.integers(0, 256, n, np.uint8).tobytes())
    text = "こんにちは世界。国際化テストです。".encode("iso2022_jp")
    for off in range(2048, n - 2048, 8192):
        blk = b"\x1b$B" + text[3:-3] * 12 + b"\x1b(B"
        data[off:off + len(blk)] = blk
    data = np.frombuffer(bytes(data), np.uint8)
    argv = ["-t", "x", "-e", "ISO-2022-JP", "-n", "4",
            "-u", "0xffffffffffffffff", "/dev/null"]
    m = Missions.from_args(parse_args(argv)).v[0]
    sl = slice_table(LoadedStream(data, [(1, 0, len(data))]))
    feed = runtable_feed(data, m)
    assert feed is not None and len(feed[0]) > 10
    base_res, base_sb = native.native_scan(m, data, *sl)
    _f, f_sb = native.native_scan(m, data, *sl, runtable_feed=feed)
    assert bytes(f_sb) == bytes(base_sb)
    corrupt = list(feed)
    corrupt[5] = feed[5] ^ np.uint8(0x01)
    _r, bad_sb = native.native_scan(
        m, data, *sl, runtable_feed=tuple(corrupt))
    assert bytes(bad_sb) != bytes(base_sb), (
        "corrupted payload produced identical output - the ISO-2022-JP "
        "feed lane never engaged"
    )


def test_feed_end_to_end_iso2022(tmp_path, monkeypatch):
    """Full run() path: engine=device + feed == engine=auto byte-for-byte
    on the escape-stress corpus (exercises the feed-derived hot map +
    the mode-gated window skipper together)."""
    p = tmp_path / "iso.bin"
    p.write_bytes(_iso_corpus(n=512 * 1024))
    for extra in ([], ["-e", "UTF-8"], ["-n", "2", "-q", "12"]):
        argv = ["-t", "x", "-e", "ISO-2022-JP", "-n", "4"] + extra + [
            str(p)]
        buf_a = io.BytesIO()
        assert run(parse_args(argv), out=buf_a, engine="auto") == 0
        monkeypatch.setenv("STRINGSEXT_RUNTABLE_FEED", "1")
        buf_t = io.BytesIO()
        assert run(parse_args(argv), out=buf_t, engine="device") == 0
        monkeypatch.delenv("STRINGSEXT_RUNTABLE_FEED")
        assert buf_t.getvalue() == buf_a.getvalue(), extra
        assert buf_a.getvalue().count(b"\n") > 100


def test_feed_extras_cover_multi_cp_big5(tmp_path, monkeypatch):
    """The four Big5 double-codepoint pairs are excluded from feed runs
    but must stay hot (their findings survive the window skipper)."""
    # 0x88 0x62 decodes to U+00CA U+0304 (WHATWG big5 pointer 1133)
    pair = b"\x88\x62"
    cold = bytes(256) + b"ABCD" + bytes(256)
    blob = bytes(8192) + b"\xa4\x40\xa4\x40" + pair + b"\xa4\x40\xa4\x40" \
        + bytes(8192) + cold
    argv = ["-t", "x", "-e", "Big5", "-n", "2", str(tmp_path / "b.bin")]
    (tmp_path / "b.bin").write_bytes(blob)
    buf_a = io.BytesIO()
    assert run(parse_args(argv), out=buf_a, engine="auto") == 0
    monkeypatch.setenv("STRINGSEXT_RUNTABLE_FEED", "1")
    buf_t = io.BytesIO()
    assert run(parse_args(argv), out=buf_t, engine="device") == 0
    assert buf_t.getvalue() == buf_a.getvalue()
    assert "Ê".encode() in buf_a.getvalue()  # the multi-cp pair decoded


def _stream_corpus(n=600 * 1024, seed=13):
    r = np.random.default_rng(seed)
    data = bytearray(r.integers(0, 256, n, np.uint8).tobytes())
    texts = [
        ("в лесу родилась ёлочка " * 30).encode("koi8_r"),
        ("Привет мир! ёлочка " * 30).encode("utf-8"),
        ("hello 世界 music " * 30).encode("utf-16-le"),
        ("こんにちは世界。テスト" * 30).encode("shift_jis"),
        b"\x1b$B"
        + ("こんにちは世界。国際化テストです。".encode("iso2022_jp")[3:-3]) * 12
        + b"\x1b(B",
    ]
    for off in range(2048, n - 4096, 12288):
        t = texts[(off // 12288) % len(texts)]
        data[off:off + len(t)] = t
    for off in range(5000, n - 16, 23456):
        data[off:off + 3] = b"\x1b$B"  # mode switch across chunk seams
    return bytes(data)


@pytest.mark.parametrize("argv,chunk", [
    (["-t", "x", "-e", "UTF-8", "-e", "KOI8-R", "-n", "4"], 8192),
    (["-t", "x", "-e", "utf-16le", "-e", "Shift_JIS", "-n", "4",
      "-u", "0xffffffffffffffff"], 8192),
    (["-t", "x", "-e", "ISO-2022-JP", "-e", "UTF-8", "-n", "4"], 8192),
    (["-t", "x", "-e", "gb18030", "-e", "Big5", "-e", "EUC-JP",
      "-n", "2"], 65536),
])
def test_feed_streaming_byte_identical(monkeypatch, argv, chunk):
    """Per-chunk run-table feed on the streaming path: cursor-grounded
    classification (exact for the non-self-synchronizing CJK kinds),
    ISO-2022-JP falling back on chunks entered mid-mode. Small chunks
    force many boundary crossings + carry splices."""
    from stringsext_tpu.run import _run_streaming_stdin

    blob = _stream_corpus()

    def stream(engine, feed):
        args = parse_args(argv + ["-"])
        ms = Missions.from_args(args)
        buf = io.BytesIO()
        if feed:
            monkeypatch.setenv("STRINGSEXT_RUNTABLE_FEED", "1")
        try:
            rc = _run_streaming_stdin(
                args, ms, buf, src=io.BytesIO(blob), chunk_bytes=chunk,
                engine=engine)
        finally:
            monkeypatch.delenv("STRINGSEXT_RUNTABLE_FEED",
                               raising=False)
        assert rc == 0
        return buf.getvalue()

    ref = stream("auto", False)
    got = stream("device", True)
    assert got == ref
    assert ref.count(b"\n") > 100


def test_feed_streaming_checkpoint_kill_resume(tmp_path, monkeypatch):
    """--checkpoint composes with the per-chunk feed: kill mid-stream
    with engine=device + STRINGSEXT_RUNTABLE_FEED=1, resume, and the
    assembled output equals the uninterrupted engine=auto run."""
    from stringsext_tpu.run import _run_streaming_stdin

    blob = _stream_corpus(n=200 * 1024)
    argv = ["-t", "x", "-e", "UTF-8", "-e", "Shift_JIS", "-n", "4", "-"]

    args = parse_args(argv)
    buf = io.BytesIO()
    rc = _run_streaming_stdin(args, Missions.from_args(args), buf,
                              src=io.BytesIO(blob), chunk_bytes=8192)
    assert rc == 0
    expected = buf.getvalue()

    class _Dying(io.BytesIO):
        def __init__(self, data, die_after):
            super().__init__(data)
            self.left = die_after

        def readinto(self, b):
            if self.left <= 0:
                raise RuntimeError("simulated crash")
            view = b[:self.left] if len(b) > self.left else b
            got = super().readinto(view)
            self.left -= got
            return got

    monkeypatch.setenv("STRINGSEXT_RUNTABLE_FEED", "1")
    ck = str(tmp_path / "feed.ck")
    out1 = tmp_path / "out.bin"
    args = parse_args(argv)
    with pytest.raises(RuntimeError, match="simulated crash"):
        with open(out1, "wb") as fo:
            _run_streaming_stdin(
                args, Missions.from_args(args), fo,
                src=_Dying(blob, 5 * 8192), chunk_bytes=8192,
                engine="device", checkpoint_path=ck)
    assert os.path.exists(ck)
    args = parse_args(argv)
    with open(out1, "r+b") as fo:
        rc = _run_streaming_stdin(
            args, Missions.from_args(args), fo,
            src=io.BytesIO(blob), chunk_bytes=8192,
            engine="device", checkpoint_path=ck)
    assert rc == 0
    assert not os.path.exists(ck)  # removed on success
    assert out1.read_bytes() == expected


@pytest.mark.parametrize("extra", [
    ["-r"], ["-g", "63"], ["-r", "-g", "63"], ["-n", "80", "-q", "6"],
])
def test_feed_ineligible_configs_fall_back_identically(extra):
    """Configs outside the emitter lane's eligibility (same-block,
    grep, chars_min > line_max) still accept a feed argument and must
    scan byte-identically (the lane stays off, the hot machinery and
    generic walk handle everything)."""
    r = np.random.default_rng(9)
    n = 128 * 1024
    data = bytearray(r.integers(0, 256, n, np.uint8).tobytes())
    for off in range(2048, n - 4096, 8192):
        t = ("в лесу? родилась ёлочка " * 20).encode("koi8_r")
        data[off:off + len(t)] = t
    data = np.frombuffer(bytes(data), np.uint8)
    for enc in ("KOI8-R", "UTF-8", "ISO-2022-JP", "Shift_JIS"):
        argv = ["-t", "x", "-e", enc, "-n", "4"] + extra + ["/dev/null"]
        m = Missions.from_args(parse_args(argv)).v[0]
        sl = slice_table(LoadedStream(data, [(1, 0, len(data))]))
        feed = runtable_feed(data, m)
        if feed is None:
            continue
        b_res, b_sb = native.native_scan(m, data, *sl)
        f_res, f_sb = native.native_scan(m, data, *sl, runtable_feed=feed)
        assert bytes(f_sb) == bytes(b_sb), (extra, enc)
        for k in b_res:
            assert np.array_equal(b_res[k], f_res[k]), (extra, enc, k)


def test_device_compact_matches_numpy_oracle():
    """_compact_fn / _fetch_compact (the on-device feed compaction:
    position bitmask + one packed (cp,len) scatter) against a direct
    numpy oracle, including empty, full, and single-element masks."""
    import jax.numpy as jnp

    from stringsext_tpu.ops.device_events import _compact_fn, _fetch_compact

    r = np.random.default_rng(4)
    compact = _compact_fn()
    for density in (0.0, 1.0, 0.5, 0.01):
        cap = 4096
        mask = r.random(cap) < density
        if density == 0.0:
            mask[:] = False
        length = r.integers(1, 5, cap).astype(np.int32)
        cp = r.integers(0, 0x110000, cap).astype(np.int32)
        cnt, bits, packed = compact(
            jnp.asarray(mask), jnp.asarray(length), jnp.asarray(cp))
        pos, ln, cps = _fetch_compact(cnt, bits, packed)
        want = np.flatnonzero(mask)
        assert np.array_equal(pos, want), density
        assert np.array_equal(ln, length[want]), density
        assert np.array_equal(cps, cp[want]), density
    # single element at the edges
    for idx in (0, 4095):
        mask = np.zeros(4096, bool)
        mask[idx] = True
        cnt, bits, packed = compact(
            jnp.asarray(mask), jnp.asarray(np.full(4096, 2, np.int32)),
            jnp.asarray(np.full(4096, 0x41, np.int32)))
        pos, ln, cps = _fetch_compact(cnt, bits, packed)
        assert list(pos) == [idx] and list(ln) == [2] and list(cps) == [0x41]
