"""Constant-memory stdin streaming must be byte-identical to the
buffered scan: state-carrying chunk scans + per-chunk merge replicate
the reference's lock-step batch pipeline (main.rs:118-136)."""

import io

import numpy as np
import pytest

from stringsext_tpu import native
from stringsext_tpu.cli import parse_args
from stringsext_tpu.mission import Missions
from stringsext_tpu.run import _run_streaming_stdin, run

pytestmark = pytest.mark.skipif(
    native.get_lib() is None, reason="no native toolchain"
)

rng = np.random.default_rng(99)


def _corpus(n=100_000):
    data = bytearray(rng.integers(0, 256, n, np.uint8).tobytes())
    msgs = [
        b"plain ascii finding string",
        "utf-8 déjà € find".encode("utf-8"),
        "wide ЖЖ utf16 string".encode("utf-16-le"),
        "こんにちは world".encode("iso2022_jp"),
        "ЖЖЖЖЖЖ utf8 multi".encode("utf-8"),
    ]
    # Strings straddling every 4096-boundary (chunk-edge candidate) at a
    # DIFFERENT byte phase each time, so multi-byte chars and escape
    # sequences land ACROSS chunk edges at every alignment - the carry
    # logic's hard case (a partial char at a chunk edge must be carried,
    # not dropped or decoded short).
    k = 0
    for edge in range(4096, n - 64, 4096):
        m = msgs[k % len(msgs)]
        off = edge - 1 - (k % (len(m) - 1))
        data[off : off + len(m)] = m
        k += 1
    data[50000:60000] = b"\x00" * 10000  # cold span
    return bytes(data)


def _buffered(argv, blob, tmp_path):
    p = tmp_path / "in.bin"
    p.write_bytes(blob)
    buf = io.BytesIO()
    run(parse_args(argv + [str(p)]), out=buf, engine="native")
    return buf.getvalue()


@pytest.mark.parametrize("chunk", [4096, 8192, 65536])
@pytest.mark.parametrize(
    "argv",
    [
        ["-t", "x", "-e", "UTF-8", "-e", "utf-16le", "-e", "iso-2022-jp"],
        ["-t", "d", "-e", "UTF-8", "-e", "euc-kr", "-n", "2"],
        ["-e", "utf-16be", "-g", "32"],
        ["-t", "o", "-c", "-e", "UTF-8", "-s", "7777"],
    ],
)
def test_streaming_stdin_matches_buffered(argv, chunk, tmp_path):
    blob = _corpus()
    want = _buffered(argv, blob, tmp_path)

    args = parse_args(argv + ["-"])
    ms = Missions.from_args(args)
    buf = io.BytesIO()
    _run_streaming_stdin(args, ms, buf, src=io.BytesIO(blob),
                         chunk_bytes=chunk)
    assert buf.getvalue() == want


def test_streaming_empty_stdin(tmp_path):
    args = parse_args(["-e", "UTF-8", "-"])
    ms = Missions.from_args(args)
    buf = io.BytesIO()
    _run_streaming_stdin(args, ms, buf, src=io.BytesIO(b""), chunk_bytes=4096)
    assert buf.getvalue() == b"\xef\xbb\xbf\n"


def test_streaming_exact_chunk_multiple(tmp_path):
    """Stream length an exact chunk multiple: the final read returns
    b'' and must still terminate/flush correctly."""
    blob = _corpus(32768)
    want = _buffered(["-t", "x", "-e", "UTF-8", "-e", "utf-16le"], blob,
                     tmp_path)
    args = parse_args(["-t", "x", "-e", "UTF-8", "-e", "utf-16le", "-"])
    ms = Missions.from_args(args)
    buf = io.BytesIO()
    _run_streaming_stdin(args, ms, buf, src=io.BytesIO(blob),
                         chunk_bytes=8192)
    assert buf.getvalue() == want


def test_streaming_iso2022_mode_across_chunks(tmp_path):
    """A JIS-mode section straddling a chunk boundary: the decoder MODE
    must carry across chunks (state ABI), or the resumed chunk
    misdecodes the rest of the section."""
    blob = bytearray(24576)
    text = ("日本語の長いテキスト" * 8).encode("iso2022_jp")  # one long JIS section
    # Straddle the 8192 boundary mid-mode AND mid-PAIR (the +1 puts the
    # chunk edge between a jis0208 lead and its trail byte).
    off = 8192 - len(text) // 2 + 1
    blob[off : off + len(text)] = text
    blob = bytes(blob)
    argv = ["-t", "x", "-e", "iso-2022-jp", "-u", "Asian"]
    want = _buffered(argv, blob, tmp_path)
    args = parse_args(argv + ["-"])
    ms = Missions.from_args(args)
    buf = io.BytesIO()
    _run_streaming_stdin(args, ms, buf, src=io.BytesIO(blob),
                         chunk_bytes=8192)
    assert buf.getvalue() == want


@pytest.mark.parametrize("chunk", [8192, 65536])
def test_streaming_tpu_engine_hot_maps(chunk, tmp_path, monkeypatch):
    """engine=device streaming computes per-chunk device hot maps
    (buffer-relative window skipping with carried state) - output must
    still equal the buffered scan. (Feed pinned off: this targets the
    hot-map path; the per-chunk feed has its own streaming tests.)"""
    monkeypatch.setenv("STRINGSEXT_RUNTABLE_FEED", "0")
    blob = _corpus()
    argv = ["-t", "x", "-e", "UTF-8", "-e", "utf-16le", "-e", "euc-kr",
            "-e", "iso-2022-jp"]
    want = _buffered(argv, blob, tmp_path)
    args = parse_args(argv + ["-"])
    ms = Missions.from_args(args)
    buf = io.BytesIO()
    _run_streaming_stdin(args, ms, buf, src=io.BytesIO(blob),
                         chunk_bytes=chunk, engine="device")
    assert buf.getvalue() == want


def test_streaming_tpu_odd_carry_utf16_phase(tmp_path, monkeypatch):
    """Streaming engine=device with a mission mix that leaves an ODD
    unconsumed-tail length (Shift_JIS cursor parked at a pending pair
    lead on the chunk edge) must keep the UTF-16 unit phase: the chunk
    buffer's base parity flips, and both the device hot map and the
    emitter's skip-resume alignment must not pair units off-phase
    (fuzz 987654 trials 696/2884: a bogus off-phase finding appeared
    and a real one vanished after cold-window skips)."""
    monkeypatch.setenv("STRINGSEXT_RUNTABLE_FEED", "0")  # hot-map path
    import io

    from stringsext_tpu.cli import parse_args
    from stringsext_tpu.mission import Missions
    from stringsext_tpu.run import _run_streaming_stdin, run

    blob = bytearray(32768)
    # Shift_JIS pair lead at the last byte of chunk 1: the pair
    # completes in chunk 2, so the SJIS cursor stays at 4095 (odd) and
    # the carry tail is odd-length.
    blob[4095] = 0x81
    blob[4096] = 0x40
    # UTF-16LE strings beyond cold gaps: one at an even stream offset
    # (must be found), one at an odd offset (must NOT be found).
    w = "UTF16 Кириллица строка".encode("utf-16-le")
    blob[8194 : 8194 + len(w)] = w
    blob[16001 : 16001 + len(w)] = w
    a = "astral \U0001F600 pairs".encode("utf-16-le")
    blob[24000 : 24000 + len(a)] = a
    blob = bytes(blob)

    argv = ["-e", "shift_jis", "-e", "utf-16le", "-t", "d"]
    p = tmp_path / "phase.bin"
    p.write_bytes(blob)
    buf = io.BytesIO()
    run(parse_args(argv + [str(p)]), out=buf, engine="python")
    ref = buf.getvalue()
    assert "Кириллица".encode() in ref  # even-offset plant found
    assert ref.count("Кириллица".encode()) == 1  # odd-offset one not

    for engine in ("auto", "device"):
        for chunk in (4096, 8192):
            args = parse_args(argv + ["-"])
            ms = Missions.from_args(args)
            out = io.BytesIO()
            _run_streaming_stdin(
                args, ms, out, src=io.BytesIO(blob), chunk_bytes=chunk,
                engine=engine,
            )
            assert out.getvalue() == ref, (engine, chunk)


def test_large_single_file_streams(tmp_path, monkeypatch):
    """A single file above STRINGSEXT_STREAM_FILE_MIN scans through the
    constant-memory streaming pipeline, byte-identical to buffered."""
    import io

    import numpy as np

    from stringsext_tpu.cli import parse_args
    from stringsext_tpu.run import run

    rng = np.random.default_rng(31)
    blob = bytearray(rng.integers(0, 256, 3 * 8 * 1024 * 1024 + 12345,
                                  np.uint8).tobytes())
    m = "streamed déjà € file".encode()
    for off in range(5000, len(blob) - 64, 1_000_003):
        blob[off : off + len(m)] = m
    p = tmp_path / "big.bin"
    p.write_bytes(bytes(blob))
    argv = ["-t", "x", "-e", "UTF-8", "-e", "utf-16le", str(p)]

    monkeypatch.setenv("STRINGSEXT_STREAM_FILE_MIN", str(1 << 60))
    buf = io.BytesIO()
    run(parse_args(argv), out=buf, engine="auto")
    buffered = buf.getvalue()

    monkeypatch.setenv("STRINGSEXT_STREAM_FILE_MIN", "1")
    buf = io.BytesIO()
    run(parse_args(argv), out=buf, engine="auto")
    streamed = buf.getvalue()
    assert streamed == buffered
    assert buffered.count(b"streamed d") >= 25
