"""Command-line options and directly related constants.

Parity reference: /root/reference/src/options.rs (constants at :12-33,
`Args` struct :43-91, `Radix` :93-114).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

# Encoding name literal used when simulating the non-built-in ASCII decoder
# (options.rs:12).
ASCII_ENC_LABEL = "ascii"

# Default encoding when no `-e` is given (options.rs:17).
ENCODING_DEFAULT = "UTF-8"

# Default for `--chars-min` (options.rs:21). Must fit u8.
CHARS_MIN_DEFAULT = 4

# Default for `--counter-offset` (options.rs:25).
COUNTER_OFFSET_DEFAULT = 0

# Default for `--output-line-len` (options.rs:29).
OUTPUT_LINE_CHAR_NB_MAX_DEFAULT = 64

# Minimum accepted `--output-line-len` (options.rs:33): room for at least
# 3 long Unicode characters to guarantee streaming progress.
OUTPUT_LINE_CHAR_NB_MIN = 6


class Radix(enum.Enum):
    """Radix of the byte counter when printed (options.rs:93-102)."""

    O = "o"  # octal
    X = "x"  # hexadecimal
    D = "d"  # decimal

    @staticmethod
    def from_str(rad: str) -> "Radix":
        low = rad.lower()
        for r in Radix:
            if r.value == low:
                return r
        raise ValueError("can not convert radix variant")


@dataclasses.dataclass
class Args:
    """Parsed command-line options (options.rs:43-91).

    Numeric-ish flags are kept as raw strings exactly like the reference;
    parsing/validation happens in `mission.Missions` so error messages and
    hex/alias handling match.
    """

    inputs: List[str] = dataclasses.field(default_factory=list)
    ascii_filter: Optional[str] = None  # -a
    no_metadata: bool = False  # -c
    debug_option: bool = False  # -d
    encoding: List[str] = dataclasses.field(default_factory=list)  # -e
    grep_char: Optional[str] = None  # -g
    list_encodings: bool = False  # -l
    chars_min: Optional[str] = None  # -n
    same_unicode_block: bool = False  # -r
    output: Optional[str] = None  # -p
    output_line_len: Optional[str] = None  # -q
    counter_offset: Optional[str] = None  # -s
    radix: Optional[Radix] = None  # -t
    unicode_block_filter: Optional[str] = None  # -u
    version: bool = False  # -V

    # --- Extension flags (no reference analog; options.rs:43-91 ends
    # at -V). Environment variables of the same name override these
    # (STRINGSEXT_ENGINE, STRINGSEXT_HOT_GROUP, STRINGSEXT_MESH,
    # STRINGSEXT_STREAM_FILE_MIN, STRINGSEXT_HOST_HOTMAP).
    engine: Optional[str] = None  # --engine auto|device|python
    checkpoint: Optional[str] = None  # --checkpoint FILE
    hot_group: Optional[str] = None  # --hot-group N
    mesh: bool = False  # --mesh
    stream_file_min: Optional[str] = None  # --stream-file-min BYTES
    host_hotmap: bool = False  # --host-hotmap
    dist_nprocs: Optional[str] = None  # --dist-nprocs N
    dist_rank: Optional[str] = None  # --dist-rank K
    dist_coord: Optional[str] = None  # --dist-coord HOST:PORT
