"""Input streaming: concatenate files (or stdin) into one logical byte
stream, sliced for batch processing.

Parity reference: /root/reference/src/input.rs (Slicer :33-168,
INPUT_BUF_LEN=4096 :22, shrunk to 0x20 under test :24-25).

The reference reads 4096-byte slices; multiple files are concatenated
into ONE logical stream (so strings spanning a file boundary are found)
while each slice still carries its originating file id. When a file
ends, the reference emits one empty slice tagged with the *next* file's
id (input.rs:134-158) - observable only as a no-op, but we reproduce the
slice sequence exactly because slice boundaries are observable (they
decide window grids, precision tags and leftovers).

This build separates *slicing* (this module: cheap bookkeeping that
drives the emission automaton) from *bulk reading* (whole-stream reads
feeding device-sized chunks to the classification passes).
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Iterator, List, Optional, Tuple

import numpy as np

# Size of one input slice in bytes (input.rs:22). Page-aligned.
INPUT_BUF_LEN = 4096

# ByteCounter is u64 in the reference (input.rs:16); Python ints are fine.


@dataclasses.dataclass
class StreamSlice:
    """One slice of the logical input stream."""

    data: np.ndarray  # uint8
    stream_start: int  # offset of data[0] in the logical stream
    input_file_id: Optional[int]  # None = stdin; 1-based file index
    is_last: bool  # parity note: the reference never yields True
    # (input.rs:130-137 returns None instead), so
    # production scans never flush the decoder.


@dataclasses.dataclass
class LoadedStream:
    """The whole logical input stream, resident in memory."""

    data: np.ndarray  # uint8, concatenation of all inputs
    # (file_id, stream_start, stream_end) per input in order; file_id is
    # None for stdin.
    spans: List[Tuple[Optional[int], int, int]]

    def slices(self, buf_len: int = INPUT_BUF_LEN) -> Iterator[StreamSlice]:
        """Replay the reference Slicer's slice sequence over the
        in-memory stream: per file, `buf_len`-byte slices plus a short
        tail; after each non-final file, one empty slice tagged with the
        next file's id (input.rs:138-158)."""
        nspans = len(self.spans)
        for k, (file_id, start, end) in enumerate(self.spans):
            pos = start
            while pos < end:
                n = min(buf_len, end - pos)
                yield StreamSlice(self.data[pos : pos + n], pos, file_id, False)
                pos += n
            if k + 1 < nspans:
                next_id = self.spans[k + 1][0]
                yield StreamSlice(self.data[end:end], end, next_id, False)
            # Final file: the reference returns None at EOF without
            # yielding an empty last slice.


def slice_table(stream: LoadedStream, buf_len: int = INPUT_BUF_LEN):
    """Vectorized slice table for the native engine: arrays
    (stream_start int64, length int32, file_id int32 [-1 = stdin],
    is_last uint8) matching `LoadedStream.slices()` exactly."""
    starts: List[np.ndarray] = []
    lens: List[np.ndarray] = []
    fids: List[np.ndarray] = []
    nspans = len(stream.spans)
    for k, (file_id, start, end) in enumerate(stream.spans):
        n = end - start
        if n > 0:
            s = np.arange(start, end, buf_len, dtype=np.int64)
            l = np.minimum(end - s, buf_len).astype(np.int32)
            starts.append(s)
            lens.append(l)
            fids.append(np.full(len(s), -1 if file_id is None else file_id, np.int32))
        if k + 1 < nspans:  # empty switch slice tagged with next file's id
            nid = stream.spans[k + 1][0]
            starts.append(np.array([end], np.int64))
            lens.append(np.array([0], np.int32))
            fids.append(np.array([-1 if nid is None else nid], np.int32))
    if not starts:
        return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                np.zeros(0, np.int32), np.zeros(0, np.uint8))
    s = np.concatenate(starts)
    return (s, np.concatenate(lens), np.concatenate(fids),
            np.zeros(len(s), np.uint8))


# Single files at least this large are memory-mapped instead of read
# into RAM: the scan engines stream through the pages sequentially.
MMAP_THRESHOLD = 64 * 1024 * 1024


def load_stream(inputs: List[str]) -> LoadedStream:
    """Read all inputs into one stream. An unreadable file produces a
    warning and is treated as empty (input.rs:78-84), and still occupies
    a file-id position. A single large file is memory-mapped."""
    use_stdin = (not inputs) or (len(inputs) == 1 and inputs[0] == "-")
    if not use_stdin and len(inputs) == 1:
        try:
            if os.path.getsize(inputs[0]) >= MMAP_THRESHOLD:
                data = np.memmap(inputs[0], dtype=np.uint8, mode="r")
                return LoadedStream(data=data, spans=[(1, 0, len(data))])
        except OSError:
            pass  # fall through to the generic reader (warns below)

    spans: List[Tuple[Optional[int], int, int]] = []
    if use_stdin:
        buf = sys.stdin.buffer.read()
        spans.append((None, 0, len(buf)))
        data = np.frombuffer(buf, dtype=np.uint8)
        return LoadedStream(data=data, spans=spans)

    # Multi-file: size first, then readinto one preallocated buffer
    # (a parts list + join would double peak memory). Non-regular
    # inputs (FIFOs, procfs/sysfs, char devices) report a zero or
    # meaningless st_size, so they get a read()-to-EOF loop like the
    # reference's Read-based Slicer (input.rs:120-129); the same loop
    # picks up bytes a regular file GREW between stat and read.
    import stat as statmod

    sizes: List[int] = []
    regular: List[bool] = []
    for name in inputs:
        try:
            st = os.stat(name)
            reg = statmod.S_ISREG(st.st_mode)
            sizes.append(st.st_size if reg else 0)
            regular.append(reg)
        except OSError:
            sizes.append(0)  # warn below at open time
            regular.append(True)
    data = np.empty(sum(sizes), np.uint8)
    pos = 0  # write cursor into the preallocated buffer
    deviated = False  # an extra appeared: switch to parts + concat
    parts: List[np.ndarray] = []
    cur_len = 0  # logical stream length so far (== pos until deviation)
    for i, (name, sz) in enumerate(zip(inputs, sizes)):
        n = 0
        extra = b""
        try:
            with open(name, "rb") as f:
                if regular[i] and sz:
                    n = f.readinto(memoryview(data[pos : pos + sz]))
                    if n == sz:
                        extra = f.read()  # grew since stat
                else:
                    extra = f.read()  # non-regular: stat size lies
        except OSError as e:
            print(f"Error: can not read file`\"{name}\"`: {e}", file=sys.stderr)
        if not deviated:
            start = pos
            if extra:
                deviated = True
                if pos + n:
                    parts.append(data[: pos + n])  # stream so far
                parts.append(np.frombuffer(extra, np.uint8))
            cur_len = pos + n + len(extra)
        else:
            start = cur_len
            if n:
                parts.append(data[pos : pos + n])
            if extra:
                parts.append(np.frombuffer(extra, np.uint8))
            cur_len += n + len(extra)
        spans.append((i + 1, start, start + n + len(extra)))
        pos += n
    if deviated:
        data = np.concatenate(parts) if len(parts) > 1 else parts[0]
    elif pos != len(data):  # a file shrank between stat and read
        data = data[:pos]
    return LoadedStream(data=data, spans=spans)
