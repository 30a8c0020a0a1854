"""Native C++ engine must produce byte-identical output with the
Python automaton path, across encodings, filters and boundary layouts.
"""

import io

import numpy as np
import pytest

from stringsext_tpu.cli import parse_args
from stringsext_tpu.native import get_lib
from stringsext_tpu.run import run

rng = np.random.default_rng(11)

pytestmark = pytest.mark.skipif(get_lib() is None, reason="no native toolchain")


def _run(argv, stream_bytes, engine):
    import tempfile, os

    with tempfile.NamedTemporaryFile(delete=False) as f:
        f.write(stream_bytes)
        path = f.name
    try:
        args = parse_args(argv + [path])
        buf = io.BytesIO()
        assert run(args, out=buf, engine=engine) == 0
        return buf.getvalue()
    finally:
        os.unlink(path)


def _corpus(i):
    size = [300, 5000, 9000, 16384][i % 4]
    data = bytearray(rng.integers(0, 256, size=size, dtype=np.uint8).tobytes())
    texts = [
        "plain ascii string with spaces".encode(),
        "déjà vu être naïve €uro".encode("utf-8"),
        "UTF16LE Кириллица text".encode("utf-16-le"),
        "UTF16BE Ελληνικά text".encode("utf-16-be"),
        "astral \U0001F600\U0001F601 chars".encode("utf-8"),
        "한국어 테스트".encode("cp949"),
        "日本語テスト".encode("cp932"),
        "中文测试\U00020000".encode("gb18030"),
        "日本語のテスト".encode("euc_jp"),
        "中文字元測試".encode("big5hkscs") + b"\x88\x62tail",
    ]
    for j, t in enumerate(texts):
        off = (j * 977 + i * 131) % max(1, size - len(t) - 1)
        data[off : off + len(t)] = t
    return bytes(data)


CONFIGS = [
    ["-e", "UTF-8", "-tx"],
    ["-e", "UTF-8", "-e", "utf-16le", "-e", "utf-16be", "-tx", "-q", "16"],
    ["-e", "ascii", "-n", "6", "-td"],
    ["-e", "utf-16le,6,All,Default", "-tx", "-g", "32"],
    ["-e", "UTF-8", "-r", "-u", "Default", "-to"],
    ["-e", "windows-1251", "-e", "KOI8-R", "-tx", "-n", "3"],
    ["-e", "UTF-8", "-c"],
    ["-e", "utf-16be", "-tx", "-s", "77777", "-q", "8"],
    ["-e", "euc-kr", "-e", "shift_jis", "-tx", "-u", "Default", "-q", "12"],
    ["-e", "gb18030", "-e", "euc-jp", "-tx", "-u", "Default"],
    ["-e", "gbk", "-tx", "-u", "Asian", "-n", "2"],
    ["-e", "iso-2022-jp", "-tx", "-u", "Default"],
    ["-e", "big5", "-tx", "-u", "Default", "-n", "3"],
]


@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_native_matches_python(ci):
    for i in range(3):
        blob = _corpus(i + ci)
        a = _run(CONFIGS[ci], blob, "python")
        b = _run(CONFIGS[ci], blob, "auto")
        assert a == b, f"config {ci} corpus {i}: outputs differ"


@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_tpu_engine_matches_python(ci):
    """engine='device': device run tables + window-skipping emitter must be
    byte-identical (device kernels run on the CPU backend here)."""
    for i in range(2):
        blob = _corpus(i + ci + 5)
        a = _run(CONFIGS[ci], blob, "python")
        b = _run(CONFIGS[ci], blob, "device")
        assert a == b, f"config {ci} corpus {i}: device engine differs"


def test_tpu_engine_golden(golden_dir):
    import subprocess, os, sys

    env = dict(os.environ, STRINGSEXT_ENGINE="device", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "stringsext_tpu.cli", "-q", "16", "-g", "63",
         "-tx", "-a", "All-Ctrl", "-u", "Common", "-e", "UTF-8",
         "-e", "utf-16le", "-e", "utf-16be", str(golden_dir / "input1")],
        capture_output=True, env=env,
    )
    assert out.returncode == 0, out.stderr[:500]
    assert out.stdout == (golden_dir / "expected_output1").read_bytes()


def test_native_multifile():
    import os, tempfile

    blobs = [_corpus(0), _corpus(1), b"", _corpus(2)]
    paths = []
    for b in blobs:
        f = tempfile.NamedTemporaryFile(delete=False)
        f.write(b)
        f.close()
        paths.append(f.name)
    try:
        argv = ["-e", "UTF-8", "-e", "utf-16le", "-tx", "-q", "20"]
        outs = []
        for engine in ("python", "auto"):
            args = parse_args(argv + paths)
            buf = io.BytesIO()
            run(args, out=buf, engine=engine)
            outs.append(buf.getvalue())
        assert outs[0] == outs[1]
    finally:
        for p in paths:
            os.unlink(p)
