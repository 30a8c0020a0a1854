"""Reference unit-test parity for argv parsing and the OutputFull
(buffer-overflow) behavior.

- test_arg_parser mirrors /root/reference/src/options.rs:121-178
  field-for-field (the same argv, the same assertions).
- The OutputFull path (finding_collection.rs:306-323): the reference
  holds decoded text in a fixed 0x9192-byte pinned buffer; on overflow
  it CLEARS the collection, warns on stderr and loses findings. The
  this build's engines append to growable buffers, so the overflow
  cannot occur; the tests below pin the superior observable behavior -
  pathological inputs (one enormous accepted run, output lines close
  to the reference's whole buffer size) produce COMPLETE output with
  no warning and no loss - and document the divergence.
"""

import io

import numpy as np
import pytest

from stringsext_tpu import native
from stringsext_tpu.cli import parse_args
from stringsext_tpu.options import Radix
from stringsext_tpu.run import run


def test_arg_parser():
    # options.rs:133-156 argv, options.rs:159-176 assertions.
    args = parse_args([
        "-d", "-n", "10", "-g", "64", "-e", "ascii", "-e", "utf-8",
        "-V", "-l", "-s", "1500", "-p", "outfile", "-q", "40",
        "-t", "o", "-r", "infile1", "infile2",
    ])
    assert args.inputs[0] == "infile1"
    assert args.inputs[1] == "infile2"
    assert args.debug_option
    assert args.encoding == ["ascii", "utf-8"]
    assert args.version
    assert args.list_encodings
    assert args.chars_min == "10"
    assert args.same_unicode_block
    assert args.grep_char == "64"
    assert args.radix == Radix.O
    assert args.counter_offset == "1500"
    assert args.output == "outfile"
    assert args.output_line_len == "40"
    assert not args.no_metadata


@pytest.mark.parametrize("engine", ["python", "auto"])
def test_no_output_full_loss_on_pathological_input(
    tmp_path, capsys, engine
):
    """A single accepted run far larger than the reference's whole
    output buffer (0x9192 = 37266 bytes, finding.rs:22-23), scanned
    with an output line length near the buffer size: the reference
    would hit OutputFull, clear the collection, warn, and LOSE
    findings; this build emits everything, loses nothing and prints no
    warning."""
    if engine == "auto" and native.get_lib() is None:
        pytest.skip("no native lib")
    n = 200_000
    data = bytes([0x41 + (i % 26) for i in range(n)])  # A..Z run
    p = tmp_path / "big.bin"
    p.write_bytes(data)
    buf = io.BytesIO()
    rc = run(
        parse_args(["-t", "x", "-e", "UTF-8", "-q", "30000", str(p)]),
        out=buf, engine=engine,
    )
    assert rc == 0
    out = buf.getvalue()
    # Strip BOM + newlines + metadata: the concatenated finding payload
    # must reproduce the input completely (nothing cleared or lost).
    lines = out[3:].split(b"\n")
    payload = b"".join(ln.split(b"\t", 1)[1] for ln in lines if b"\t" in ln)
    assert payload == data
    err = capsys.readouterr().err
    assert "overflow" not in err.lower()


def test_multibyte_pathological_no_loss(tmp_path):
    """4-byte-UTF-8 chars at maximum line length: each output line
    approaches 4*line_max bytes, the exact shape that overflows the
    reference's fixed buffer fastest."""
    if native.get_lib() is None:
        pytest.skip("no native lib")
    ch = "\U0001F600".encode()  # 4-byte emoji
    data = ch * 20_000
    p = tmp_path / "emoji.bin"
    p.write_bytes(data)
    buf = io.BytesIO()
    rc = run(
        parse_args(["-e", "UTF-8", "-q", "9000",
                    "-u", "0xffffffffffffffff", str(p)]),
        out=buf, engine="auto",
    )
    assert rc == 0
    payload = buf.getvalue()[3:].replace(b"\n", b"")
    assert payload == data
