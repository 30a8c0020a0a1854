"""CLI behaviors: stdin, -p FILE, exit codes, error messages."""

import os
import subprocess
import sys

import pytest

ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def _cli(args, stdin=b"", check=True):
    return subprocess.run(
        [sys.executable, "-m", "stringsext_tpu.cli", *args],
        input=stdin, capture_output=True, env=ENV, cwd="/root/repo",
    )


def test_stdin_dash():
    r = _cli(["-e", "UTF-8", "-tx", "-"], stdin=b"\x00\x01hello stdin world\x02")
    assert r.returncode == 0
    assert b"hello stdin world" in r.stdout
    assert r.stdout.startswith(b"\xef\xbb\xbf")
    assert r.stdout.endswith(b"\n")


def test_no_files_reads_stdin():
    r = _cli(["-e", "ascii"], stdin=b"\xffplain text here\xff")
    assert r.returncode == 0
    assert b"plain text here" in r.stdout


def test_output_file(tmp_path):
    out = tmp_path / "out.txt"
    inp = tmp_path / "in.bin"
    inp.write_bytes(b"\x00find me please\x00")
    r = _cli(["-e", "UTF-8", "-p", str(out), str(inp)])
    assert r.returncode == 0
    assert r.stdout == b""
    assert b"find me please" in out.read_bytes()


def test_bad_encoding_exit_code():
    r = _cli(["-e", "no-such-enc", "/dev/null"])
    assert r.returncode == 1
    assert b"invalid input encoding name" in r.stderr


def test_bad_filter_alias():
    r = _cli(["-e", "UTF-8", "-u", "Klingon", "/dev/null"])
    assert r.returncode == 1
    assert b"not valid" in r.stderr


def test_unreadable_file_warns_and_continues(tmp_path):
    inp = tmp_path / "in.bin"
    inp.write_bytes(b"\x00real data string\x00")
    r = _cli(["-e", "UTF-8", "-tx", str(tmp_path / "missing.bin"), str(inp)])
    assert r.returncode == 0
    assert b"can not read file" in r.stderr
    assert b"real data string" in r.stdout


def test_grep_out_of_range():
    r = _cli(["-e", "UTF-8", "-g", "200", "/dev/null"])
    assert r.returncode == 1


def test_line_len_minimum():
    r = _cli(["-e", "UTF-8", "-q", "5", "/dev/null"])
    assert r.returncode == 1


def test_replacement_encoding_all_engines(tmp_path):
    """The WHATWG replacement decoder never yields findings; all
    engines (incl. native + device hot maps + stdin streaming) must
    produce the identical empty output, alone and mixed with UTF-8."""
    import io

    import numpy as np

    from stringsext_tpu.cli import parse_args
    from stringsext_tpu.run import run

    rng = np.random.default_rng(5)
    blob = rng.integers(0, 256, 30000, np.uint8).tobytes()
    blob = blob[:700] + b"findable ascii string" + blob[700:]
    p = tmp_path / "r.bin"
    p.write_bytes(blob)

    for argv in (["-e", "replacement"],
                 ["-t", "x", "-e", "replacement", "-e", "UTF-8"]):
        outs = {}
        for engine in ("python", "auto", "device"):
            buf = io.BytesIO()
            run(parse_args(argv + [str(p)]), out=buf, engine=engine)
            outs[engine] = buf.getvalue()
        assert outs["python"] == outs["auto"] == outs["device"]
        if argv == ["-e", "replacement"]:
            assert outs["python"] == b"\xef\xbb\xbf\n"
        else:
            assert b"findable ascii string" in outs["python"]


def test_full_argv_parse():
    """options.rs:121-178 analog: every flag in one invocation parses
    into the expected Args/Missions."""
    from stringsext_tpu.cli import parse_args
    from stringsext_tpu.mission import Missions
    from stringsext_tpu.options import Radix

    args = parse_args([
        "-a", "All-Ctrl", "-c", "-e", "utf-16le,12,All,Common,47",
        "-e", "ascii", "-g", "58", "-n", "10", "-p", "/tmp/out.txt",
        "-q", "40", "-r", "-s", "1500", "-t", "o", "--", "f1", "f2",
    ])
    assert args.radix is Radix.O
    assert args.no_metadata and args.same_unicode_block
    assert args.output == "/tmp/out.txt"
    assert args.counter_offset == "1500"  # parsed later (hex allowed)
    assert args.inputs == ["f1", "f2"]
    ms = Missions.from_args(args)
    assert len(ms.v) == 2
    m0, m1 = ms.v
    # per-encoding DSL overrides the globals for scanner 0 only
    assert m0.encoding_name == "UTF-16LE" and m0.chars_min_nb == 12
    assert m0.filter.grep_char == 47
    assert m1.encoding_name == "x-user-defined"  # ascii emulation
    assert m1.chars_min_nb == 10 and m1.filter.grep_char == 58
    assert m0.output_line_char_nb_max == 40
    assert m0.counter_offset == 1500


def test_usage_error_exit_code_is_1():
    """clap parity: usage errors exit 1, not argparse's default 2."""
    import subprocess

    r = subprocess.run(
        ["python", "-m", "stringsext_tpu.cli", "--bogus"],
        capture_output=True, cwd="/root/repo",
    )
    assert r.returncode == 1


def test_broken_pipe_exits_zero(tmp_path):
    """`stringsext big | head -1` must exit 0 without EPIPE noise."""
    import subprocess

    import numpy as np

    p = tmp_path / "b.bin"
    p.write_bytes((b"finding string here! " * 300000))
    r = subprocess.run(
        f"python -m stringsext_tpu.cli -e UTF-8 -- {p} | head -c 100 >/dev/null",
        shell=True, capture_output=True, cwd="/root/repo",
    )
    assert b"Exception ignored" not in r.stderr


def test_parse_integer_rust_parity():
    """u8/u64::from_str accepts a leading '+', rejects Unicode digits;
    hex failures use the hexadecimal error message (mission.rs:449-463)."""
    import pytest as _pytest

    from stringsext_tpu.mission import MissionError, Missions

    ms = Missions.new(flag_encoding=["UTF-8"], flag_chars_min_nb="+10")
    assert ms.v[0].chars_min_nb == 10
    with _pytest.raises(MissionError):
        Missions.new(flag_encoding=["UTF-8"], flag_chars_min_nb="٣")
    with _pytest.raises(MissionError, match="hexadecimal"):
        Missions.new(flag_encoding=["UTF-8"], flag_chars_min_nb="0xzz")


def test_debug_options_dump(capsys):
    """-d pretty-prints every parsed Mission and exits 0 (help.rs:22-45
    - the config introspection surface). Pin the structure and the
    parsed per-encoding DSL values."""
    from stringsext_tpu.cli import main

    rc = main(["-d", "-e", "UTF-8,10,All-Ctrl,Cyrillic,63", "-e", "euc-kr",
               "--", "/dev/null"])
    assert rc == 0
    out = capsys.readouterr().out
    assert 'A = "/dev/null"' in out
    assert "a = UTF-8,10,All-Ctrl,Cyrillic,63" in out
    assert "Scanner (a)" in out and "Scanner (b)" in out
    assert "chars_min_nb: 10," in out
    assert "grep_char: Some(63)," in out
    assert "ubf: 0x1f0000," in out  # Cyrillic alias resolved
    assert "encoding: EUC-KR," in out


def test_debug_options_dump_golden(capsys):
    """Full-byte golden pin of the -d dump (help.rs:22-45): the config
    introspection surface must not drift (VERDICT r3 item 10). Regen:
    python -m stringsext_tpu.cli -d -t x \\
      -e UTF-8,10,All-Ctrl,Cyrillic,63 -e euc-kr -e ascii -g 58 -n 6 \\
      -s 4096 -q 32 --same-unicode-block /dev/null /etc/hostname \\
      > tests/golden_extra/debug_dump.expected"""
    import pathlib

    from stringsext_tpu.cli import main

    rc = main(["-d", "-t", "x", "-e", "UTF-8,10,All-Ctrl,Cyrillic,63",
               "-e", "euc-kr", "-e", "ascii", "-g", "58", "-n", "6",
               "-s", "4096", "-q", "32", "--same-unicode-block",
               "/dev/null", "/etc/hostname"])
    assert rc == 0
    expected = (pathlib.Path(__file__).parent / "golden_extra"
                / "debug_dump.expected").read_text()
    assert capsys.readouterr().out == expected


def test_version_flag(capsys):
    """-V prints 'Version X, AUTHOR' and exits 0 (help.rs:17-20)."""
    from stringsext_tpu import __version__
    from stringsext_tpu.cli import main

    rc = main(["-V"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.startswith(f"Version {__version__}, ")


def test_list_encodings(capsys):
    """-l lists the ascii label + 40 WHATWG encodings and both filter
    alias tables with resolved hex values (help.rs:47-144)."""
    from stringsext_tpu.cli import main
    from stringsext_tpu.encodings import ALL_ENCODING_NAMES

    rc = main(["-l"])
    assert rc == 0
    out = capsys.readouterr().out
    names = [ln.strip() for ln in out.splitlines() if ln.startswith("\t")]
    for e in ["ascii", *ALL_ENCODING_NAMES]:
        assert e in names, e
    assert len(ALL_ENCODING_NAMES) == 40  # 41 listed incl. the ascii label
    # alias tables with resolved values (mission.rs:167-218, 255-274)
    assert "All-Ctrl     =  0x7fffffffffffffffffffffff00000000" in out
    assert "Cyrillic     =           0x1f0000" in out
