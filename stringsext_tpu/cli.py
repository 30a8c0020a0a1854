"""Command-line interface.

Parity reference: /root/reference/src/options.rs:35-91 (flags) and
/root/reference/src/main.rs:178-185 (entry point, exit codes per the
manpage: 0 success, 1 error).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .options import Args, Radix


class _Parser(argparse.ArgumentParser):
    """argparse with reference exit-code parity: usage errors exit 1
    (clap convention, manpage :277-285), not argparse's default 2."""

    def error(self, message):
        self.print_usage(sys.stderr)
        print(f"{self.prog}: error: {message}", file=sys.stderr)
        raise SystemExit(1)


def build_parser() -> argparse.ArgumentParser:
    p = _Parser(
        prog="stringsext",
        description="Find multi-byte encoded strings in binary data.",
        add_help=True,
        allow_abbrev=False,  # clap rejects abbreviated long options
    )
    p.add_argument("-a", "--ascii-filter", dest="ascii_filter", metavar="AF",
                   help="filter applied after decoding (see --list-encodings for AF examples)")
    p.add_argument("-c", "--no-metadata", dest="no_metadata", action="store_true",
                   help="never print byte-counter, encoding or filter")
    p.add_argument("-d", "--debug-option", dest="debug_option", action="store_true",
                   help="show how command-line-options are interpreted")
    p.add_argument("-e", "--encoding", dest="encoding", action="append", default=[],
                   metavar="ENC", help="set (multiple) encodings to search for")
    p.add_argument("-g", "--grep-char", dest="grep_char", metavar="ASCII_CODE",
                   help="grep for characters with ASCII-code in output lines")
    p.add_argument("-l", "--list-encodings", dest="list_encodings", action="store_true",
                   help="list predefined encoding and filter names for ENC")
    p.add_argument("-n", "--chars-min", dest="chars_min", metavar="NUM",
                   help="minimum characters of printed strings")
    p.add_argument("-r", "--same-unicode-block", dest="same_unicode_block",
                   action="store_true",
                   help="require chars in finding to be in the same Unicode-block")
    p.add_argument("-p", "--output", dest="output", metavar="FILE",
                   help="print not to stdout but in file")
    p.add_argument("-q", "--output-line-len", dest="output_line_len", metavar="NUM",
                   help="output line length in Unicode-codepoints")
    p.add_argument("-s", "--counter-offset", dest="counter_offset", metavar="NUM",
                   help="start counting input bytes with NUM")
    p.add_argument("-t", "--radix", dest="radix", metavar="RADIX",
                   help="enable byte-counter with radix `o`, `x` or `d`")
    p.add_argument("-u", "--unicode-block-filter", dest="unicode_block_filter",
                   metavar="UBF",
                   help="filter applied after decoding (see --list-encodings for UBF examples)")
    p.add_argument("-V", "--version", dest="version", action="store_true",
                   help="print version and exit")
    p.add_argument("inputs", nargs="*", metavar="FILE",
                   help="paths to files to scan (or `-` for stdin)")
    ext = p.add_argument_group(
        "runtime extensions",
        "flags without a stringsext analog; the STRINGSEXT_* environment "
        "variable of the same name overrides each flag when set")
    ext.add_argument("--engine", dest="engine",
                     choices=["auto", "device", "tpu", "python"],
                     help="scan engine: auto (native C++; promotes itself "
                          "to device when the cached accelerator-link "
                          "probe finds a co-located accelerator), device "
                          "(device run-table feed + native emitter; tpu is "
                          "its old name), python (pure-python oracle); "
                          "default auto")
    ext.add_argument("--checkpoint", dest="checkpoint", metavar="FILE",
                     help="checkpoint scan state to FILE after every chunk "
                          "and resume from it if it exists (single input "
                          "or stdin; removed on successful completion)")
    ext.add_argument("--hot-group", dest="hot_group", metavar="NUM",
                     help="at most NUM missions per fused device hot-map "
                          "launch (engine=device; default 24)")
    ext.add_argument("--mesh", dest="mesh", action="store_true",
                     help="shard the device counts pass over every "
                          "attached GPU (off by default)")
    ext.add_argument("--stream-file-min", dest="stream_file_min",
                     metavar="BYTES",
                     help="stream (constant-memory) single files at least "
                          "this large; default 1073741824")
    ext.add_argument("--host-hotmap", dest="host_hotmap",
                     action="store_true",
                     help="enable the numpy host hot-map prepass for "
                          "engine=auto (window skipping without a device; "
                          "segment-parallel scanning engages by default "
                          "without it)")
    ext.add_argument("--dist-nprocs", dest="dist_nprocs", metavar="N",
                     help="distributed scan: total number of processes "
                          "(run the same command on every host with "
                          "matching --dist-rank; process 0 prints)")
    ext.add_argument("--dist-rank", dest="dist_rank", metavar="K",
                     help="distributed scan: this process's rank (0..N-1)")
    ext.add_argument("--dist-coord", dest="dist_coord", metavar="HOST:PORT",
                     help="distributed scan: jax.distributed coordinator "
                          "address (rank 0's host)")
    return p


def parse_args(argv: Optional[List[str]] = None) -> Args:
    ns = build_parser().parse_args(argv)
    radix = None
    if ns.radix is not None:
        try:
            radix = Radix.from_str(ns.radix)
        except ValueError as e:
            print(f"error: Invalid value for '--radix <radix>': {e}", file=sys.stderr)
            raise SystemExit(1)
    return Args(
        inputs=ns.inputs,
        ascii_filter=ns.ascii_filter,
        no_metadata=ns.no_metadata,
        debug_option=ns.debug_option,
        encoding=ns.encoding,
        grep_char=ns.grep_char,
        list_encodings=ns.list_encodings,
        chars_min=ns.chars_min,
        same_unicode_block=ns.same_unicode_block,
        output=ns.output,
        output_line_len=ns.output_line_len,
        counter_offset=ns.counter_offset,
        radix=radix,
        unicode_block_filter=ns.unicode_block_filter,
        version=ns.version,
        engine=ns.engine,
        dist_nprocs=ns.dist_nprocs,
        dist_rank=ns.dist_rank,
        dist_coord=ns.dist_coord,
        checkpoint=ns.checkpoint,
        hot_group=ns.hot_group,
        mesh=ns.mesh,
        stream_file_min=ns.stream_file_min,
        host_hotmap=ns.host_hotmap,
    )


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.version:
        # Fast path: -V answers from this module alone (no numpy /
        # mission-table imports) - the reference is a static binary
        # that starts in milliseconds (help.rs:17-20).
        from . import version_line

        print(version_line())
        return 0
    # Heavy imports (numpy via mission/encodings) stay off the -V path;
    # jax is imported by NO scan path (only engine=device passes).
    from .help import help_and_maybe_exit
    from .mission import MissionError

    try:
        if help_and_maybe_exit(args):
            return 0
        import os

        from .run import run

        # Engine selection: "auto" (native C++), "device" (device
        # passes pre-filter + native emitter; "tpu" is its old name),
        # "python" (reference impl). The env var overrides the --engine
        # flag (scripts/CI may pin an engine around arbitrary
        # invocations).
        engine = os.environ.get("STRINGSEXT_ENGINE") or args.engine or "auto"
        if engine not in ("auto", "device", "tpu", "python"):
            print(
                f"Error: unknown STRINGSEXT_ENGINE `{engine}` "
                "(expected auto|device|python).",
                file=sys.stderr,
            )
            return 1
        return run(args, engine=engine)
    except MissionError as e:
        print(f"Error while parsing command-line arguments: {e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        # Downstream closed (e.g. `| head`): devnull stdout so the
        # interpreter-shutdown flush cannot re-raise EPIPE (which would
        # print "Exception ignored" noise and turn the exit status
        # into 120).
        import os

        try:
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        except OSError:
            pass
        return 0
    except Exception as e:  # run() error -> exit 1 (main.rs:181-184)
        print(f"Error: `{e}`.", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
