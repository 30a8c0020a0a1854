"""Segment-parallel native scanning (run.py engine=device): splitting the
stream at provably-quiescent cold slices must be invisible in the
output - byte-identical to the unsegmented scan and to the Python
oracle, including boundary carries, precision marks and continuation
flags near the split points."""

import io

import numpy as np
import pytest

from stringsext_tpu import run as R
from stringsext_tpu.cli import parse_args

rng = np.random.default_rng(17)


@pytest.fixture(autouse=True)
def _hot_map_path(monkeypatch):
    """These tests target segment-parallel scanning, which requires the
    hot-map path; the run-table feed (default-on under engine=device)
    keeps feed missions unsegmented."""
    monkeypatch.setenv("STRINGSEXT_RUNTABLE_FEED", "0")


def _run(argv, engine, monkeypatch, max_seg):
    monkeypatch.setattr(R, "_SEGMENT_MAX", max_seg)
    buf = io.BytesIO()
    R.run(parse_args(argv), out=buf, engine=engine)
    return buf.getvalue()


def _clustered_corpus(size=400_000):
    """Hot clusters separated by long cold (zero / high-byte) gaps -
    the sparse-disk-image shape segmentation targets."""
    blob = bytearray(rng.integers(0, 256, size, np.uint8).tobytes())
    blob[60_000:140_000] = b"\x00" * 80_000
    blob[200_000:260_000] = b"\xff" * 60_000
    plants = [
        (30_000, "first cluster déjà €uro".encode()),
        (59_990, "string touching the gap".encode()),  # into the gap
        (140_010, "after gap +continuation test".encode()),
        (150_000, "wide Кириллица".encode("utf-16-le")),
        (260_000, "tail cluster Ωμέγα".encode("utf-16-be")),
        (399_000, "final string at stream end".encode()),
    ]
    for off, m in plants:
        blob[off : off + len(m)] = m
    return bytes(blob)


@pytest.mark.parametrize("max_seg", [2, 3, 7])
def test_segmented_equals_unsegmented(tmp_path, monkeypatch, max_seg):
    p = tmp_path / "seg.bin"
    p.write_bytes(_clustered_corpus())
    argv = ["-t", "x", "-e", "UTF-8", "-e", "utf-16le", "-e", "utf-16be",
            str(p)]
    ref = _run(argv, "python", monkeypatch, 1)
    un = _run(argv, "device", monkeypatch, 1)
    seg = _run(argv, "device", monkeypatch, max_seg)
    assert un == ref
    assert seg == ref
    assert ref.count(b"\n") > 1000


def test_segmented_multifile_odd_boundary(tmp_path, monkeypatch):
    """An odd-length first file shifts every later slice to odd
    offsets: UTF-16 segments must refuse those split points (unit
    phase) while UTF-8 may still split; output must stay identical."""
    a = tmp_path / "a.bin"
    b = tmp_path / "b.bin"
    blob1 = bytearray(rng.integers(0, 256, 30_001, np.uint8).tobytes())
    blob1[1000:1010] = b"abcdefghij"
    blob2 = bytearray(rng.integers(0, 256, 200_000, np.uint8).tobytes())
    blob2[50_000:120_000] = b"\x00" * 70_000
    m = "après le vide".encode()
    blob2[130_000 : 130_000 + len(m)] = m
    w = "wide string".encode("utf-16-le")
    blob2[140_001 : 140_001 + len(w)] = w  # odd absolute offset
    a.write_bytes(bytes(blob1))
    b.write_bytes(bytes(blob2))
    argv = ["-t", "d", "-e", "UTF-8", "-e", "utf-16le", str(a), str(b)]
    ref = _run(argv, "python", monkeypatch, 1)
    seg = _run(argv, "device", monkeypatch, 6)
    assert seg == ref


def test_segment_rows_constraints():
    """_segment_rows only proposes rows after cold slices of >=2
    windows with even absolute starts."""
    starts = np.array([0, 4096, 8192, 12288], np.int64)
    lens = np.array([4096, 4096, 4096, 100], np.int32)
    fids = np.full(4, -1, np.int32)
    last = np.zeros(4, np.uint8)
    sl = (starts, lens, fids, last)
    # Hot range inside slice 1 only: slices 0 and 2 are cold.
    hot = (np.array([5000], np.int64), np.array([6000], np.int64))
    rows = R._segment_rows(sl, hot, window_bytes=128, max_segments=4)
    # Row 1 (after cold slice 0), row 3 (after cold slice 2) are legal;
    # row 2 (after the hot slice 1) is not.
    assert set(rows) <= {1, 3}
    assert rows
    none = R._segment_rows(sl, (np.zeros(0, np.int64), np.zeros(0, np.int64)),
                           window_bytes=4096, max_segments=4)
    # windows of 4096 bytes: no slice holds two windows -> no splits.
    assert none == []


def test_host_hotmap_auto_engine(tmp_path, monkeypatch):
    """engine=auto with the host-side hot-map prepass forced on must be
    byte-identical to the Python oracle (and to auto with maps off),
    including a CJK plausible-spec mission."""
    p = tmp_path / "hostmap.bin"
    p.write_bytes(_clustered_corpus())
    argv = ["-t", "x", "-e", "UTF-8", "-e", "utf-16be", "-e", "euc-kr",
            str(p)]
    ref = _run(argv, "python", monkeypatch, 1)
    monkeypatch.setenv("STRINGSEXT_HOST_HOTMAP", "0")
    off = _run(argv, "auto", monkeypatch, 1)
    monkeypatch.setenv("STRINGSEXT_HOST_HOTMAP", "1")
    on = _run(argv, "auto", monkeypatch, 1)
    on_seg = _run(argv, "auto", monkeypatch, 4)
    assert off == ref
    assert on == ref
    assert on_seg == ref


def test_host_hotmap_ranges_cover_findings(tmp_path, monkeypatch):
    """The host hot map must be a strict superset of every finding's
    bytes (spot-check on a random corpus with planted strings)."""
    import numpy as np

    from stringsext_tpu.input import LoadedStream
    from stringsext_tpu.mission import Missions

    blob = bytearray(rng.integers(0, 256, 100_000, np.uint8).tobytes())
    blob[5_000:45_000] = b"\x00" * 40_000
    m1 = "утф16 строка".encode("utf-16-le")
    blob[20_000 : 20_000 + len(m1)] = m1  # planted INSIDE the zero gap
    data = np.frombuffer(bytes(blob), np.uint8)
    stream = LoadedStream(data, [(None, 0, len(data))])
    ms = Missions.new(flag_encoding=["UTF-8", "utf-16le"])
    hot = R._host_hot_ranges(stream, list(enumerate(ms.v)))
    res = R._scan_arrays(stream, ms, "python")
    for i, (m, cols, _sb) in enumerate(res):
        hs, he = hot[i]
        for pos, ln in zip(cols["position"], cols["str_len"]):
            # every finding's first byte lies in a hot range
            k = np.searchsorted(he, int(pos), "right")
            assert k < len(hs) and hs[k] <= int(pos) < he[k], (
                m.encoding_name, int(pos))


def test_segment_rows_span_guards():
    """No split where an event could span the boundary: a continuation
    byte at the split point (UTF-8) or a preceding high surrogate
    (UTF-16) vetoes the candidate - a valid-but-REJECTED char
    straddling the split would otherwise re-decode as malformed events
    and shift the call-granular printed position of a finding in the
    segment's first window."""
    starts = np.array([0, 4096, 8192], np.int64)
    lens = np.array([4096, 4096, 4096], np.int32)
    sl = (starts, lens, np.full(3, -1, np.int32), np.zeros(3, np.uint8))
    hot = (np.array([8200], np.int64), np.array([8300], np.int64))

    data = np.zeros(12288, np.uint8)
    rows = R._segment_rows(sl, hot, 128, 4, data=data, kind="utf8")
    assert 4096 in starts[rows] or 8192 in starts[rows]

    # Continuation byte right at every candidate start: all vetoed.
    data2 = data.copy()
    data2[4096] = 0xAD
    data2[8192] = 0x98
    rows2 = R._segment_rows(sl, hot, 128, 4, data=data2, kind="utf8")
    assert rows2 == []

    # UTF-16LE: a high surrogate unit just before the boundary vetoes.
    data3 = data.copy()
    data3[4095] = 0xD8  # unit [4094,4096) = lone/pair high surrogate
    rows3 = R._segment_rows(sl, hot, 128, 4, data=data3, kind="utf16le")
    assert 4096 not in starts[rows3].tolist()
    # BE: high byte sits at the unit's first byte.
    data4 = data.copy()
    data4[4094] = 0xD9
    rows4 = R._segment_rows(sl, hot, 128, 4, data=data4, kind="utf16be")
    assert 4096 not in starts[rows4].tolist()


def test_segmented_spanning_rejected_char(tmp_path, monkeypatch):
    """End-to-end adversarial layout from the review: slices land at
    504 mod 512 (odd-length first file), a filter-rejected 3-byte char
    straddles the only split-eligible slice boundary, and an accepted
    string sits 8 bytes after it (hot range starts exactly at the
    boundary). Output must not depend on segmentation."""
    f1 = tmp_path / "a.bin"
    f2 = tmp_path / "b.bin"
    f1.write_bytes(b"\x00" * (3 * 4096 + 504))
    blob = bytearray(b"\x00" * 65536)
    # Slice boundaries in file 2 sit at 504 mod 4096 absolute... build
    # relative to file 2: its slices start at offsets 0, 4096, ... and
    # absolute positions 3*4096+504 + k*4096 (== 504 mod 512).
    for k in (2, 5, 9):
        b0 = k * 4096  # file-2-relative slice boundary
        blob[b0 - 2 : b0 + 1] = b"\xe4\xb8\xad"  # rejected CJK char
        msg = b"boundary finding text"
        blob[b0 + 8 : b0 + 8 + len(msg)] = msg
    f2.write_bytes(bytes(blob))
    argv = ["-t", "x", "-e", "UTF-8", "-e", "utf-16le", str(f1), str(f2)]
    ref = _run(argv, "python", monkeypatch, 1)
    un = _run(argv, "device", monkeypatch, 1)
    for max_seg in (2, 4, 8):
        seg = _run(argv, "device", monkeypatch, max_seg)
        assert seg == ref, max_seg
    assert un == ref


def _cjk_corpus(size=512 * 1024):
    """CJK/ISO-2022-JP strings in hot clusters with cold zero gaps,
    plus a jis0208 mode left OPEN across a gap (segment entry modes
    must ride the escape-history composition)."""
    blob = bytearray(size)
    msgs = [
        "シフトジスの文字列テスト".encode("shift_jis"),
        "汉字字符串测试一二三".encode("gb18030"),
        "한국어 문자열 테스트".encode("euc_kr"),
        "日本語のテキストです".encode("iso-2022-jp"),
        b"plain ascii string here",
    ]
    k = 0
    for off in range(800, size - 256, 2600):
        if (off % (64 * 1024)) > 40 * 1024:
            continue  # cold gap in every 64 KiB period
        m = msgs[k % len(msgs)]
        blob[off : off + len(m)] = m
        k += 1
    third = size // 3
    frag = b"\x1b$B" + "漢字".encode("iso-2022-jp")[3:-3]
    blob[third : third + len(frag)] = frag  # jis mode left open
    return bytes(blob)


@pytest.mark.parametrize("max_seg", [2, 5])
def test_segmented_cjk_iso2022_equals_unsegmented(tmp_path, monkeypatch,
                                                  max_seg):
    """Round 3: the non-self-synchronizing kinds segment too - CJK via
    the ground-byte decode-forward alignment proof, ISO-2022-JP via
    escape-history entry modes - byte-identically."""
    p = tmp_path / "cjkseg.bin"
    p.write_bytes(_cjk_corpus())
    argv = ["-t", "x", "-e", "Shift_JIS", "-e", "gb18030", "-e", "euc-kr",
            "-e", "ISO-2022-JP", "-n", "4", str(p)]
    ref = _run(argv, "python", monkeypatch, 1)
    un = _run(argv, "device", monkeypatch, 1)
    seg = _run(argv, "device", monkeypatch, max_seg)
    assert un == ref
    assert seg == ref
    assert ref.count(b"\n") > 100

    # the splitter must actually produce CJK split points here (the
    # byte-equality above would be vacuous if segmentation never ran)
    from stringsext_tpu.input import load_stream, slice_table
    from stringsext_tpu.mission import Missions

    ms = Missions.from_args(parse_args(argv))
    stream = load_stream([str(p)])
    sl = slice_table(stream)
    hot = R._host_hot_ranges(stream, list(enumerate(ms.v)))
    m0 = ms.v[0]  # Shift_JIS
    splits = R._segment_rows(
        sl, hot[0], 2 * m0.output_line_char_nb_max, max_seg,
        data=stream.data, kind="shift_jis",
    )
    assert splits, "no CJK split points found on the clustered corpus"
