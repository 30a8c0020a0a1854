"""Multi-process orchestration across hosts.

The reference is a single process (`std::sync::mpsc` + scoped threads,
main.rs:98,151) that reads each input byte exactly once
(input.rs:120-167); its distributed analog here (SURVEY.md section 5)
keeps that property PER RANK:

- `initialize()` wires `jax.distributed` so all hosts join one runtime.
- Shard boundaries are found by a bounded WINDOWED search around each
  nominal split point (`_find_boundary_row`): every rank evaluates the
  same pure function of the same bytes, so all agree without
  communication, and nobody scans the whole input just to split it.
- Each rank then reads ONLY its shard's bytes (`_read_range`), scans
  them with fresh provably-true mission states, and sends its findings
  to rank 0 over a TCP side channel rendezvoused through the
  jax.distributed key-value store (`_gather_to_zero`) - no padded
  allgather, no O(total-findings) residency on non-zero ranks.
- Rank 0 streams the merged output shard by shard with the same
  boundary-tie holdback the chunked stdin pipeline uses
  (run._run_streaming_stdin), so its memory is O(one shard's findings).

Boundary exactness: a rank may start scanning at slice row r iff every
mission's quiescence predicate holds there (previous slice cold + two
windows long - `run._quiescent_mask`, the predicate pinned by
tests/test_segments.py) AND the per-kind alignment guard holds at the
boundary byte:

  utf8 / utf16 / single-byte: the `_quiescent_mask` kind guards
      (continuation byte / unit phase+surrogate; nothing for sbyte);
  CJK multi-byte (euc-kr, big5, shift_jis, euc-jp, gb18030): decode
      forward from the last "ground" byte (one that can never be a
      non-first event byte - emitter.cpp cjk_ground_limit) and require
      an event to START exactly at the boundary with every earlier
      event reporting and ending before it (`_cjk_boundary_aligned`);
  iso-2022-jp: nothing extra locally - its hot spec is mode-blind
      (ops/specs.cjk_hot_spec), so a COLD slice contains no escapes
      and no pair-phase carriers: every cold byte is a one-byte event
      in every mode, hence the boundary is an event start with
      output_flag=false. Only the entry MODE is non-local; each rank
      computes its shard's mode transfer (last valid escape - a pure
      function of the bytes, since every 0x1B starts escape processing
      in every mode and escape validity is mode-independent) and a
      tiny allgather + prefix composition yields each rank's entry
      mode (`_iso_mode_transfer`).

Multi-host execution needs several hosts; the process-level tests
(tests/test_distributed_2proc.py) run TRUE 2- and 3-process scans over
localhost Gloo and pin byte-identical output plus O(shard) bytes-read.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import jax
import numpy as np

# ---------------------------------------------------------------------------
# Runtime wiring
# ---------------------------------------------------------------------------


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the multi-host JAX runtime (no-op when single-process or
    already initialized - the CLI may call this after a harness did).
    The already-joined probe must NOT touch jax.process_count(): that
    initializes the XLA backend, after which joining becomes
    impossible."""
    if num_processes is None or num_processes <= 1:
        return
    if jax.distributed.is_initialized():
        if jax.process_count() != num_processes:
            raise RuntimeError(
                f"jax.distributed already initialized with "
                f"{jax.process_count()} processes; cannot re-join as "
                f"{num_processes}"
            )
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=_rank_local_devices(process_id),
    )


def _rank_local_devices(process_id: Optional[int]) -> Optional[List[int]]:
    """The one local GPU a rank opens: card (process_id % cards on this
    host), so ranks that share a host never all reserve every card.
    None (JAX's default) on hosts without NVIDIA device nodes, and
    when CUDA_VISIBLE_DEVICES already narrows what the rank sees."""
    import glob

    if os.environ.get("CUDA_VISIBLE_DEVICES") is not None:
        return None
    cards = len(glob.glob("/dev/nvidia[0-9]*"))
    if not cards:
        return None
    return [int(process_id or 0) % cards]


def host_shard_range(total_bytes: int, shard_len: int) -> Tuple[int, int]:
    """Byte range this host feeds: contiguous run of data-shards."""
    nproc = jax.process_count()
    pid = jax.process_index()
    nshards = total_bytes // shard_len
    per = (nshards + nproc - 1) // nproc
    lo = min(pid * per, nshards)
    hi = min(lo + per, nshards)
    return lo * shard_len, hi * shard_len


def gather_run_tables(rt):
    """Bring the sharded run tables to every host (they are small:
    capacity-bounded per shard/mission). With jax.Array + a global mesh
    this is a device_get of the globally-sharded value; XLA inserts the
    cross-host transfers."""
    return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), rt)


# ---------------------------------------------------------------------------
# O(shard) input plane: stat-only spans, windowed reads
# ---------------------------------------------------------------------------

# Bytes this process actually read from the input files (windows +
# shard); reset by distributed_run, asserted by the O(shard) test.
BYTES_READ = 0
LAST_STATS: dict = {}


def stat_spans(inputs: List[str]) -> List[Tuple[Optional[int], int, int]]:
    """The logical-stream spans [(file_id, start, end)] from file sizes
    alone - no byte is read. Matches input.load_stream's span layout
    (file_id is 1-based; an unstattable file occupies a zero-length
    span, the distributed analog of input.rs:78-84's warn-and-empty).
    Inputs must be immutable for the duration of the scan (all ranks
    must see the same bytes)."""
    spans = []
    pos = 0
    for i, name in enumerate(inputs):
        try:
            sz = os.path.getsize(name)
        except OSError:
            sz = 0
        spans.append((i + 1, pos, pos + sz))
        pos += sz
    return spans


class _SpanStream:
    """Duck-typed stand-in for input.LoadedStream when only the span
    table is needed (input.slice_table reads nothing but .spans)."""

    def __init__(self, spans):
        self.spans = spans


def _read_range(inputs: List[str], spans, lo: int, hi: int) -> np.ndarray:
    """Read logical-stream bytes [lo, hi) - and ONLY those - from the
    underlying files. Raises if a file shrank or became unreadable
    after stat (ranks would silently diverge otherwise; the reference
    panics on mid-stream read errors too, input.rs:123-128)."""
    global BYTES_READ
    out = np.zeros(max(hi - lo, 0), np.uint8)
    for (_fid, s, e), name in zip(spans, inputs):
        a, b = max(s, lo), min(e, hi)
        if a >= b:
            continue
        try:
            with open(name, "rb") as f:
                f.seek(a - s)
                got = f.readinto(memoryview(out[a - lo : b - lo]))
        except OSError as exc:
            raise RuntimeError(
                f"distributed scan: cannot read bytes {a - s}..{b - s} of "
                f"{name!r} ({exc}); distributed inputs must stay readable "
                f"and constant-size during the scan"
            )
        if got != b - a:
            raise RuntimeError(
                f"distributed scan: {name!r} shrank after stat "
                f"(expected {b - a} bytes at offset {a - s}, got {got})"
            )
        BYTES_READ += got
    return out


# ---------------------------------------------------------------------------
# Boundary search
# ---------------------------------------------------------------------------

_WINDOW0 = 8 * 1024 * 1024  # first search window per boundary

# Smallest byte value that can be a NON-FIRST byte of any event
# (emitter.cpp cjk_ground_limit); any byte below is a provable event
# start.
# (_CJK_GROUND / _cjk_boundary_aligned / _iso_mode_transfer /
# _compose_entry_mode live in engine/align.py - JAX-FREE, shared
# with the host probe/segment splitters; re-imported here.)
from ..engine.align import (  # noqa: F401
    _CJK_GROUND,
    _cjk_boundary_aligned,
    _compose_entry_mode,
    _iso_mode_transfer,
)


def _mission_jobs(missions):
    """[(idx, mission, kind)] plus a hot-spec presence check; returns
    None when any mission has no host-computable hot spec (then no
    cold-slice certificate exists and there is no exact split)."""
    from ..encodings import encoding_kind
    from ..ops.specs import cjk_hot_spec, swar_mission_spec

    jobs = []
    for i, m in enumerate(missions.v):
        if swar_mission_spec(m) is None and cjk_hot_spec(m) is None:
            return None
        jobs.append((i, m, encoding_kind(m.encoding_name)))
    return jobs



def _window_first_boundary(inputs, spans, jobs, sl, target: int,
                           w_lo: int, w_hi: int) -> Optional[int]:
    """First acceptable boundary ROW with slice start in
    [max(target, w_lo+4096+64), w_hi-64), evaluated entirely from the
    window bytes [w_lo, w_hi) (4096-aligned). Window-edge blocks are
    force-hot by _host_hot_ranges, so verdicts are conservative but
    deterministic: every rank evaluating a boundary uses the identical
    window (a pure function of the target), hence identical bytes."""
    from ..input import LoadedStream
    from ..run import _host_hot_ranges, _quiescent_mask

    starts, lens, fids, last = sl
    win = _read_range(inputs, spans, w_lo, w_hi)
    wstream = LoadedStream(win, [(None, 0, len(win))])
    hot = _host_hot_ranges(wstream, [(i, m) for i, m, _k in jobs])

    # Rows whose slice lies inside the window AND whose previous row's
    # slice does too.
    ra = int(np.searchsorted(starts, w_lo, "left"))
    rb = int(np.searchsorted(starts + lens.astype(np.int64), w_hi, "right"))
    if rb - ra < 2:
        return None
    sub = (starts[ra:rb] - w_lo, lens[ra:rb], fids[ra:rb], last[ra:rb])
    ok_all = np.ones(rb - ra - 1, bool)
    for i, m, kind in jobs:
        k = kind if kind in ("utf8", "utf16le", "utf16be") else "other"
        ok_all &= _quiescent_mask(
            sub, hot[i], 2 * m.output_line_char_nb_max, data=win, kind=k,
        )
    abs_rows = np.flatnonzero(ok_all) + ra + 1
    cand_p = starts[abs_rows]
    keep = (
        (cand_p >= max(target, w_lo + 4096 + 64))
        & (cand_p + 64 <= w_hi)
        & (cand_p % 2 == 0)  # even base: UTF-16 unit phase + device maps
    )
    abs_rows = abs_rows[keep]
    cjk_kinds = [k for _i, _m, k in jobs if k in _CJK_GROUND]
    for r in abs_rows:
        p = int(starts[r])
        if all(
            _cjk_boundary_aligned(win, w_lo, p, k) for k in set(cjk_kinds)
        ):
            return int(r)
    return None


def _find_boundary_row(inputs, spans, jobs, sl, target: int, total: int,
                       cap: int) -> Optional[int]:
    """First quiescent+aligned row with slice start >= target, searched
    in growing windows up to `cap` bytes past the target; None when the
    stretch is too dense to split (the left neighbor absorbs it). Pure
    in (inputs' bytes, target): every rank computes identical results."""
    w_lo = max(0, ((target - 8192) // 4096) * 4096)
    limit = min(total, target + cap)
    w = _WINDOW0
    while True:
        w_hi = min(total, w_lo + w)
        r = _window_first_boundary(inputs, spans, jobs, sl, target, w_lo, w_hi)
        if r is not None:
            return r
        if w_hi >= limit:
            return None
        w *= 2


def shard_row_bounds(inputs, spans, missions, nprocs: int):
    """Row bounds [0, r_1, .., n_rows] for an nprocs-way distributed
    scan, or None when no mission-set-wide cold certificate exists
    (some mission has no hot spec). A boundary with no quiescent row
    within the search cap collapses FORWARD onto the next boundary
    (that shard comes out empty and its left neighbor absorbs the
    dense stretch); later boundaries still split. Deterministic across
    ranks: pure function of (file sizes, file bytes near each target).
    """
    from ..input import slice_table

    sl = slice_table(_SpanStream(spans))
    n_rows = len(sl[0])
    total = spans[-1][2] if spans else 0
    if n_rows == 0 or nprocs <= 1:
        return [0, n_rows] + [n_rows] * max(nprocs - 1, 0)
    jobs = _mission_jobs(missions)
    if jobs is None:
        return None
    cap = max(64 * 1024 * 1024, total // max(nprocs, 1) // 4)
    raw = []
    for k in range(1, nprocs):
        target = total * k // nprocs
        raw.append(_find_boundary_row(inputs, spans, jobs, sl, target,
                                      total, cap))
    # Collapse unfound boundaries forward onto the next found one.
    bounds = [n_rows] * (nprocs + 1)
    bounds[0] = 0
    nxt = n_rows
    for k in range(nprocs - 1, 0, -1):
        if raw[k - 1] is not None:
            nxt = min(raw[k - 1], nxt)
        bounds[k] = nxt
    # Monotone by construction (first-candidate>=target is monotone in
    # target); clamp defensively anyway.
    for k in range(1, nprocs + 1):
        bounds[k] = max(bounds[k], bounds[k - 1])
    return bounds


def shard_boundaries(stream, missions, nprocs: int):
    """In-memory compatibility wrapper over the windowed boundary
    search (tests build a LoadedStream directly): returns row bounds or
    None when no exact split exists. File-backed callers use
    shard_row_bounds, which never loads the whole stream."""
    import tempfile

    if nprocs <= 1:
        from ..input import slice_table

        return [0, len(slice_table(stream)[0])]
    tmps = []
    try:
        for _fid, s, e in stream.spans:
            tf = tempfile.NamedTemporaryFile(
                suffix=".sx-shard", delete=False
            )
            tf.write(np.ascontiguousarray(stream.data[s:e]).tobytes())
            tf.close()
            tmps.append(tf.name)
        # Same span lengths -> same slice-row layout; file ids are not
        # consulted by the boundary predicate.
        return shard_row_bounds(tmps, stat_spans(tmps), missions, nprocs)
    finally:
        for t in tmps:
            try:
                os.unlink(t)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# ISO-2022-JP entry-mode composition (the only non-local shard state)
# ---------------------------------------------------------------------------





# ---------------------------------------------------------------------------
# Shard scan (buffer-relative, exactly like the streaming chunk scans)
# ---------------------------------------------------------------------------

_FINDING_COLS = (
    ("position", np.uint64), ("precision", np.int8),
    ("completes", np.uint8), ("file_id", np.int32),
    ("str_off", np.uint64), ("str_len", np.uint32),
)


def _empty_per_mission(missions):
    return [
        ({name: np.zeros(0, dt) for name, dt in _FINDING_COLS}, b"")
        for _ in missions.v
    ]


def _shard_hot_maps(missions, data, p_lo: int, engine: str):
    """Hot byte ranges over THIS RANK'S shard buffer (buffer-relative
    coordinates; the shard base is even by the boundary predicate, so
    UTF-16 unit pairing by buffer offset matches the stream).
    engine=device uses the device passes; engine=auto honors the opt-in
    STRINGSEXT_HOST_HOTMAP=1 numpy prepass (the no-device skip
    machinery - what makes a many-mission sparse sweep feasible on
    plain hosts)."""
    from ..input import LoadedStream

    if not len(data):
        return {}
    if engine == "device":
        from ..ops.specs import cjk_hot_spec, swar_mission_spec
        from ..run import _device_hot_ranges_swar, _warn_once

        if p_lo % 2:
            _warn_once(
                ("dist-odd-base", jax.process_index()),
                f"Warning: rank {jax.process_index()} shard starts at "
                f"an odd stream offset {p_lo}; skipping device hot maps "
                f"for it (full host scan - output is unaffected).",
            )
            return {}
        swar_jobs = []
        for i, m in enumerate(missions.v):
            spec = swar_mission_spec(m) or cjk_hot_spec(m)
            if spec is not None:
                swar_jobs.append((i, spec))
        if not swar_jobs:
            return {}
        return _device_hot_ranges_swar(
            LoadedStream(data, [(None, 0, len(data))]), swar_jobs
        )
    if os.environ.get("STRINGSEXT_HOST_HOTMAP") == "1":
        from ..run import _host_hot_ranges

        return _host_hot_ranges(
            LoadedStream(data, [(None, 0, len(data))]),
            list(enumerate(missions.v)),
        )
    return {}


def scan_shard(inputs, spans, missions, sl, r0: int, r1: int,
               entry_mode: int = 0, engine: str = "auto", data=None):
    """Exact scan of slice rows [r0, r1): reads ONLY those bytes,
    rebases the slice rows onto the shard buffer (the emitter handles
    buffer-relative cursors with absolute `consumed` bookkeeping - the
    same contract the streaming chunk pipeline is pinned on), and runs
    one native scan thread per mission. `entry_mode` seeds the
    ISO-2022-JP decoder mode (composed across earlier shards).
    Returns ([(res_columns, strbuf_bytes)] per mission, (p_lo, p_hi))."""
    from concurrent.futures import ThreadPoolExecutor

    from .. import native
    from ..input import LoadedStream

    if r0 >= r1:
        return _empty_per_mission(missions), (0, 0)
    starts, lens, fids, last = sl
    p_lo = int(starts[r0])
    p_hi = int(starts[r1 - 1] + lens[r1 - 1])
    if data is None:
        data = _read_range(inputs, spans, p_lo, p_hi)
    ssl = (
        (starts[r0:r1] - p_lo).astype(np.int64),
        lens[r0:r1], fids[r0:r1], last[r0:r1],
    )

    hot_by_mission = _shard_hot_maps(missions, data, p_lo, engine)

    def _mission_state(m):
        return {
            "consumed": m.counter_offset + p_lo,
            "cursor": 0,
            "printed_maybe_cut": False,
            "dec_mode": entry_mode,
            "dec_output_flag": False,
            "leftover_cps": [],
        }

    runtable_feeds = {}
    from ..run import _feed_enabled

    if engine == "device" and len(data) and _feed_enabled():
        # Per-shard device run-table feed: the shard base is a true
        # event start for every mission (the windowed boundary search
        # guarantees it), so the chunk-feed builder applies directly
        # with cursor 0; ISO-2022-JP engages only when this shard's
        # composed entry mode is ground (the builder's gate).
        from ..run import _chunk_runtable_feed, _merge_ranges

        for i, m in enumerate(missions.v):
            r = _chunk_runtable_feed(data, m, _mission_state(m))
            if r is None:
                continue
            feed, (ex_pos, ex_len) = r
            runtable_feeds[i] = feed
            hs = np.concatenate([feed[0], ex_pos]) - 8
            he = np.concatenate([feed[1], ex_pos + ex_len]) + 8
            hot_by_mission[i] = _merge_ranges(hs, he, len(data))

    def job(im):
        i, m = im
        return native.native_scan(
            m, data, *ssl, state=_mission_state(m),
            hot_ranges=hot_by_mission.get(i),
            runtable_feed=runtable_feeds.get(i),
        )

    with ThreadPoolExecutor(max_workers=max(1, len(missions.v))) as ex:
        out = list(ex.map(job, enumerate(missions.v)))
    return out, (p_lo, p_hi)


# ---------------------------------------------------------------------------
# Per-rank checkpoint/resume (--checkpoint with --dist-nprocs)
# ---------------------------------------------------------------------------
#
# The distributed scan has two phases: per-rank shard scans (the bulk
# of the work) and the rank-0 gather+merge (idempotent: the output file
# is opened fresh and rewritten in full on every run). The checkpoint
# therefore protects only SCAN progress: each rank chunks its shard's
# slice rows, carries the native resumable state between chunks (the
# split-with-state == one-shot identity is fuzz-pinned,
# scripts/fuzz.py's checkpoint branch), and persists states +
# findings-so-far after every chunk to `<ckpt>.rank<K>` (atomic npz).
# Resume restarts the same N-process job with the same command line;
# ranks whose files exist skip their completed chunks (a finished rank
# skips straight to the gather). All files are removed on success.

_CKPT_CHUNK_ROWS = 8192  # ~32 MiB of slice rows per checkpoint chunk


def _ckpt_chunk_rows() -> int:
    try:
        return max(1, int(os.environ.get("STRINGSEXT_DIST_CKPT_CHUNK", "")))
    except ValueError:
        return _CKPT_CHUNK_ROWS


def _atomic_write(path: str, blob: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _dist_ckpt_save(path, fingerprint_js: str, states, next_chunk,
                    part=None):
    """Persist one chunk's findings as its OWN part file (written once,
    never rewritten - saves stay O(chunk), not O(findings so far)),
    then the small manifest (states + progress) atomically LAST: a
    crash between the two leaves an unreferenced part file the next
    run overwrites."""
    import io as _io
    import json as _json

    if part is not None:
        c, per_mission = part
        _atomic_write(f"{path}.part{c}", _serialize_findings(per_mission))
    buf = _io.BytesIO()
    np.savez(buf, meta=np.frombuffer(
        _json.dumps({
            "fingerprint": fingerprint_js,
            "states": states,
            "next_chunk": int(next_chunk),
        }).encode(), np.uint8
    ))
    _atomic_write(path, buf.getvalue())


def _dist_ckpt_load(path, fingerprint_js: str, n_missions: int):
    """Returns (states, parts, next_chunk) or None (absent). Raises on
    a fingerprint mismatch (different inputs/missions/world/bounds) or
    a missing referenced part file (corrupt checkpoint set)."""
    import json as _json

    if not os.path.exists(path):
        return None
    z = np.load(path)
    meta = _json.loads(z["meta"].tobytes().decode())
    if meta["fingerprint"] != fingerprint_js:
        raise ValueError(
            f"distributed checkpoint {path} was written by a different "
            "configuration (inputs/missions/world size/bounds differ); "
            "resume must rerun the identical command on identical inputs"
        )
    parts = []
    for c in range(int(meta["next_chunk"])):
        pp = f"{path}.part{c}"
        if not os.path.exists(pp):
            raise ValueError(
                f"distributed checkpoint part {pp} is missing - the "
                "checkpoint set is incomplete; remove "
                f"{path}* to start fresh"
            )
        with open(pp, "rb") as f:
            parts.append(_deserialize_findings(f.read(), n_missions))
    return meta["states"], parts, int(meta["next_chunk"])


def _dist_ckpt_cleanup(path: str) -> None:
    import glob

    for p in [path] + glob.glob(f"{path}.part*") + glob.glob(
        f"{path}.tmp.*"
    ):
        try:
            os.remove(p)
        except OSError:
            pass


def _concat_parts(missions, parts):
    """Concatenate per-chunk per-mission findings (str_off rebased)."""
    if not parts:
        return _empty_per_mission(missions)
    out = []
    for i in range(len(missions.v)):
        cols = {name: [] for name, _ in _FINDING_COLS}
        bufs = []
        off = 0
        for pm in parts:
            res, sb = pm[i]
            for name, _dt in _FINDING_COLS:
                v = res[name]
                if name == "str_off":
                    v = v + np.uint64(off)
                cols[name].append(v)
            bufs.append(bytes(sb))
            off += len(bufs[-1])
        out.append((
            {k: np.concatenate(v) for k, v in cols.items()},
            b"".join(bufs),
        ))
    return out


def scan_shard_checkpointed(inputs, spans, missions, sl, r0: int, r1: int,
                            entry_mode: int, engine: str, ck_path: str,
                            fingerprint_js: str, data=None):
    """scan_shard with per-chunk crash recovery (see the section
    comment above). Returns (per_mission, (p_lo, p_hi),
    chunks_skipped, chunks_total)."""
    from concurrent.futures import ThreadPoolExecutor

    from .. import native

    if r0 >= r1:
        return _empty_per_mission(missions), (0, 0), 0, 0
    starts, lens, fids, last = sl
    p_lo = int(starts[r0])
    p_hi = int(starts[r1 - 1] + lens[r1 - 1])
    if data is None:
        data = _read_range(inputs, spans, p_lo, p_hi)
    ssl = (
        (starts[r0:r1] - p_lo).astype(np.int64),
        lens[r0:r1], fids[r0:r1], last[r0:r1],
    )
    n_rows = r1 - r0
    crows = _ckpt_chunk_rows()
    chunk_bounds = list(range(0, n_rows, crows)) + [n_rows]
    n_chunks = len(chunk_bounds) - 1

    fresh = [
        {
            "consumed": m.counter_offset + p_lo,
            "cursor": 0,
            "printed_maybe_cut": False,
            "dec_mode": entry_mode,
            "dec_output_flag": False,
            "leftover_cps": [],
        }
        for m in missions.v
    ]
    loaded = _dist_ckpt_load(ck_path, fingerprint_js, len(missions.v))
    if loaded is not None:
        states, parts, next_chunk = loaded
        states = [dict(st) for st in states]
    else:
        states, parts, next_chunk = fresh, [], 0

    hot_by_mission = _shard_hot_maps(missions, data, p_lo, engine)

    pool = ThreadPoolExecutor(max_workers=max(1, len(missions.v)))
    try:
        for c in range(next_chunk, n_chunks):
            c0, c1 = chunk_bounds[c], chunk_bounds[c + 1]
            csl = tuple(a[c0:c1] for a in ssl)
            clo = int(csl[0][0])
            chi = int(csl[0][-1] + csl[1][-1])

            def job(im):
                i, m = im
                hot = hot_by_mission.get(i)
                if hot is not None:
                    hs, he = hot
                    ksel = (hs < chi) & (he > clo)
                    hot = (hs[ksel], he[ksel])
                return native.native_scan(
                    m, data, *csl, state=states[i], hot_ranges=hot
                )

            pm = list(pool.map(job, enumerate(missions.v)))
            parts.append(pm)
            _dist_ckpt_save(
                ck_path, fingerprint_js,
                [dict(st) for st in states], c + 1, part=(c, pm),
            )
            die = os.environ.get("STRINGSEXT_DIST_CKPT_DIE")
            if die is not None and c + 1 - next_chunk >= int(die):
                # test hook: simulated crash after N chunks THIS run
                raise RuntimeError("simulated distributed crash")
    finally:
        pool.shutdown()
    return (
        _concat_parts(missions, parts), (p_lo, p_hi),
        next_chunk, n_chunks,
    )


# ---------------------------------------------------------------------------
# Findings transport: serialize + gather-to-rank-0 (TCP side channel)
# ---------------------------------------------------------------------------


def _serialize_findings(per_mission) -> bytes:
    import io

    payload = {}
    for i, (res, sb) in enumerate(per_mission):
        for name, dt in _FINDING_COLS:
            payload[f"m{i}_{name}"] = np.asarray(res[name], dt)
        payload[f"m{i}_strbuf"] = np.frombuffer(bytes(sb), np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **payload)
    return buf.getvalue()


def _deserialize_findings(blob: bytes, n_missions: int):
    import io

    z = np.load(io.BytesIO(blob))
    out = []
    for i in range(n_missions):
        res = {
            name: z[f"m{i}_{name}"].astype(dt, copy=False)
            for name, dt in _FINDING_COLS
        }
        out.append((res, z[f"m{i}_strbuf"].tobytes()))
    return out


_GATHER_EPOCH = 0


def _kv_client():
    try:
        from jax._src import distributed as _jd

        return _jd.global_state.client
    except Exception:
        return None


def _local_ip() -> str:
    """IP other ranks can reach this process at: the interface used to
    reach the jax.distributed coordinator."""
    import socket

    coord = None
    try:
        from jax._src import distributed as _jd

        coord = _jd.global_state.coordinator_address
    except Exception:
        pass
    if coord:
        host = coord.rsplit(":", 1)[0]
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.connect((host, 1))
            ip = s.getsockname()[0]
            s.close()
            return ip
        except OSError:
            pass
    return "127.0.0.1"


def _gather_shards_to_zero(blob: bytes, p_lo: int, p_hi: int,
                           timeout_s: float = 3600.0):
    """Rank 0: yields (rank, p_lo, p_hi, blob) for ranks 1..n-1 in rank
    order, reading each rank's payload only when its turn comes (TCP
    backpressure holds the senders; rank 0 never buffers more than one
    shard's findings). Other ranks: send and return None.

    Rendezvous rides the jax.distributed key-value store (a tiny
    "host:port" string); the payload itself rides a direct TCP
    connection - the distributed analog of the reference's mpsc channel
    into the merger thread (main.rs:98,161), with rank 0 as the merger.
    Falls back to multihost_utils.process_allgather when the KV store
    is unavailable (then every rank transiently holds all payloads)."""
    import socket
    import struct

    global _GATHER_EPOCH
    _GATHER_EPOCH += 1
    nproc = jax.process_count()
    pid = jax.process_index()
    if nproc == 1:
        return iter(()) if pid == 0 else None
    client = _kv_client()
    if os.environ.get("STRINGSEXT_FORCE_GATHER_FALLBACK") == "1":
        client = None  # test/ops hook: exercise the allgather fallback
    key = f"stringsext:gather:{_GATHER_EPOCH}"
    if client is None:
        return _gather_fallback_allgather(blob, p_lo, p_hi, nproc, pid)

    header = struct.Struct("<qqqq")
    if pid == 0:
        lsock = socket.socket()
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((_local_ip(), 0))
        lsock.listen(nproc)
        lsock.settimeout(timeout_s)
        addr = f"{lsock.getsockname()[0]}:{lsock.getsockname()[1]}"
        client.key_value_set(key, addr)

        def recv_all(sock, n):
            buf = bytearray(n)
            view = memoryview(buf)
            got = 0
            while got < n:
                k = sock.recv_into(view[got:], n - got)
                if k == 0:
                    raise RuntimeError(
                        "distributed gather: peer closed mid-payload"
                    )
                got += k
            return bytes(buf)

        def gen():
            pending = {}
            try:
                for _ in range(nproc - 1):
                    conn, _peer = lsock.accept()
                    conn.settimeout(timeout_s)
                    r, lo, hi, ln = header.unpack(
                        recv_all(conn, header.size)
                    )
                    pending[int(r)] = (conn, int(lo), int(hi), int(ln))
                for r in range(1, nproc):
                    conn, lo, hi, ln = pending.pop(r)
                    payload = recv_all(conn, ln)
                    conn.close()
                    yield r, lo, hi, payload
            finally:
                for conn, *_rest in pending.values():
                    conn.close()
                lsock.close()

        return gen()

    # Sender ranks: look up rank 0's address, connect, ship, return.
    addr = client.blocking_key_value_get(key, int(timeout_s * 1000))
    host, port = addr.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)), timeout=timeout_s)
    try:
        sock.sendall(header.pack(pid, p_lo, p_hi, len(blob)))
        sock.sendall(blob)
    finally:
        sock.close()
    return None


_GATHER_FALLBACK_CHUNK = 8 << 20  # bytes per allgather round


def _gather_fallback_allgather(blob, p_lo, p_hi, nproc, pid):
    """Findings gather without a key-value store: CHUNKED allgather
    rounds. Each round every rank contributes one fixed-size chunk of
    its payload, so a non-zero rank transiently holds nproc x chunk
    bytes - never all payloads (the round-2 padded form allgathered
    whole max-size blobs). Rank 0 accumulates per-rank payloads across
    rounds (it must hold them anyway to merge). Loud: engaging this
    path warns once - it is strictly worse than the TCP gather."""
    from jax.experimental import multihost_utils

    from ..run import _warn_once

    _warn_once(
        ("gather-fallback-allgather",),
        "Warning: jax.distributed key-value store unavailable; the "
        "findings gather falls back to chunked allgather rounds "
        "(every rank transiently holds one chunk per peer).",
    )
    meta = np.array([len(blob), p_lo, p_hi], np.int64)
    metas = np.asarray(multihost_utils.process_allgather(meta))
    metas = metas.reshape(nproc, 3)
    mx = int(metas[:, 0].max())
    chunk = max(1, min(_GATHER_FALLBACK_CHUNK, mx))
    nrounds = max(1, -(-mx // chunk))
    src = np.frombuffer(blob, np.uint8)
    parts = [bytearray() for _ in range(nproc)] if pid == 0 else None
    for c in range(nrounds):
        lo = c * chunk
        part = np.zeros(chunk, np.uint8)
        if lo < len(src):
            seg = src[lo : lo + chunk]
            part[: len(seg)] = seg
        allp = np.asarray(multihost_utils.process_allgather(part))
        allp = allp.reshape(nproc, chunk)
        if pid == 0:
            for r in range(1, nproc):
                take = min(max(int(metas[r, 0]) - lo, 0), chunk)
                if take:
                    parts[r] += allp[r, :take].tobytes()
        del allp
    if pid != 0:
        return None

    def gen():
        for r in range(1, nproc):
            _ln, lo2, hi2 = (int(v) for v in metas[r])
            yield r, lo2, hi2, bytes(parts[r])

    return gen()


# ---------------------------------------------------------------------------
# The end-to-end distributed run
# ---------------------------------------------------------------------------


def distributed_run(args, missions, out, engine: str = "auto",
                    checkpoint_path=None) -> int:
    """Multi-process end-to-end scan: every rank finds its shard via
    the windowed boundary search, reads and scans ONLY its shard's
    bytes, and ships findings to rank 0, which streams the
    byte-identical merged output (BOM + lines + trailing newline,
    main.rs:103-139) shard by shard with boundary-tie holdback.
    jax.distributed must already be initialized (see `initialize`).

    `checkpoint_path` makes the SCAN phase resumable per rank (see the
    checkpoint section comment): resume = rerun the identical command
    with the same world; the merge phase is idempotent (the output is
    rewritten in full), so no output bookkeeping is needed."""
    global BYTES_READ
    from ..run import _engine_name

    engine = _engine_name(engine)

    from ..encodings import encoding_kind
    from ..input import slice_table
    from ..run import _emit_lines, _warn_once

    BYTES_READ = 0
    from .. import native

    if native.get_lib() is None or not all(
        native.native_supported(encoding_kind(m.encoding_name))
        for m in missions.v
    ):
        raise RuntimeError(
            "distributed scan requires the native engine for every "
            "mission (shard scans are native; no Python fallback exists "
            "at the rank level)"
        )
    nproc = jax.process_count()
    pid = jax.process_index()
    _warmup_collectives(nproc)
    inputs = list(args.inputs)
    spans = stat_spans(inputs)
    sl = slice_table(_SpanStream(spans))
    n_rows = len(sl[0])

    bounds = shard_row_bounds(inputs, spans, missions, nproc)
    if bounds is None:
        _warn_once(
            ("dist-fallback",),
            "Warning: no exact distributed split for this mission set "
            "(a mission has no host-computable cold-block spec); rank 0 "
            "scans everything and ranks 1.. stay idle.",
        )
        bounds = [0] + [n_rows] * nproc
    nonempty = sum(
        1 for k in range(nproc) if bounds[k + 1] > bounds[k]
    )
    if nonempty < nproc:
        _warn_once(
            ("dist-degenerate", nonempty),
            f"Warning: distributed split is degenerate - only {nonempty} "
            f"of {nproc} ranks got a non-empty shard (no quiescent "
            f"boundary near the other split points); the extra ranks do "
            f"no work.",
        )

    # ISO-2022-JP entry modes: each rank's shard transfer (pure in its
    # own bytes), allgathered (one int per rank) and prefix-composed.
    entry_mode = 0
    has_iso = any(
        encoding_kind(m.encoding_name) == "iso-2022-jp" for m in missions.v
    )
    r0, r1 = bounds[pid], bounds[pid + 1]
    shard_bytes = None
    if has_iso:
        from jax.experimental import multihost_utils

        transfer = -1
        if r1 > r0:
            p_lo = int(sl[0][r0])
            p_hi = int(sl[0][r1 - 1] + sl[1][r1 - 1])
            shard_bytes = _read_range(inputs, spans, p_lo, p_hi)
            transfer = _iso_mode_transfer(shard_bytes)
        transfers = np.asarray(
            multihost_utils.process_allgather(
                np.array([transfer], np.int32)
            )
        ).reshape(-1)
        entry_mode = _compose_entry_mode(transfers.tolist(), pid)

    ck_skipped = ck_total = 0
    if checkpoint_path is not None:
        import json as _json

        from ..utils.checkpoint import _mission_fingerprint

        fp_js = _json.dumps({
            "missions": _mission_fingerprint(missions),
            "sizes": [int(e - s) for _f, s, e in spans],
            "nprocs": nproc, "rank": pid, "bounds": list(bounds),
            "engine": engine, "entry_mode": entry_mode,
        }, sort_keys=True)
        rank_ck = f"{checkpoint_path}.rank{pid}"
        per_mission, (p_lo, p_hi), ck_skipped, ck_total = (
            scan_shard_checkpointed(
                inputs, spans, missions, sl, r0, r1,
                entry_mode=entry_mode, engine=engine,
                ck_path=rank_ck, fingerprint_js=fp_js,
                data=shard_bytes,
            )
        )
    else:
        per_mission, (p_lo, p_hi) = scan_shard(
            inputs, spans, missions, sl, r0, r1,
            entry_mode=entry_mode, engine=engine, data=shard_bytes,
        )

    blob = b"" if pid == 0 else _serialize_findings(per_mission)
    remote = _gather_shards_to_zero(blob, p_lo, p_hi)

    LAST_STATS.clear()
    LAST_STATS.update(
        rank=pid, nprocs=nproc, bounds=list(bounds),
        bytes_read=BYTES_READ, shard=(p_lo, p_hi),
        entry_mode=entry_mode,
        ckpt_chunks_skipped=ck_skipped, ckpt_chunks_total=ck_total,
    )

    if pid != 0:
        # Hold the distributed runtime open until rank 0 has finished
        # writing (a sender tearing down the coordinator mid-merge
        # would abort rank 0); rank 0 joins this barrier after its
        # final flush. The barrier also means checkpoint files are
        # removed only once the WHOLE job succeeded.
        _done_barrier()
        if checkpoint_path is not None:
            _dist_ckpt_cleanup(f"{checkpoint_path}.rank{pid}")
        return 0

    # Rank 0: stream the merged output shard by shard. Findings at a
    # shard's boundary position can tie with the next shard under the
    # (position, mission_id) merge key, so they are held back one shard
    # and merged there as EARLIER streams - the same holdback the
    # chunked stdin pipeline uses (run._run_streaming_stdin).
    out.write(b"\xef\xbb\xbf")  # BOM (main.rs:116)
    held: list = []

    def emit_shard(shard_pm, s_hi, last):
        nonlocal held
        rows = held + [
            (missions.v[i], res, sb)
            for i, (res, sb) in enumerate(shard_pm)
        ]
        emit, hold = [], []
        for m, res, sb in rows:
            if last:
                emit.append((m, res, sb))
                continue
            bound = m.counter_offset + s_hi
            pos = res["position"]
            cut = int(np.searchsorted(pos, bound, "left"))
            emit.append((m, {k: v[:cut] for k, v in res.items()}, sb))
            if cut < len(pos):
                hold.append(
                    (m, {k: v[cut:] for k, v in res.items()}, sb)
                )
        held = hold
        _emit_lines(out, args, emit)

    emit_shard(per_mission, p_hi, nproc == 1)
    if remote is not None:
        for r, _lo, hi, payload in remote:
            pm = _deserialize_findings(payload, len(missions.v))
            emit_shard(pm, hi, r == nproc - 1)
    if held:
        # Defensive: the last shard is always emitted with last=True,
        # so nothing can remain held; flush anyway.
        _emit_lines(out, args, held)
        held = []
    out.write(b"\n")
    out.flush()
    _done_barrier()
    if checkpoint_path is not None:
        _dist_ckpt_cleanup(f"{checkpoint_path}.rank0")
    return 0


def _warmup_collectives(nproc: int) -> None:
    """Create the Gloo communicator BEFORE any finding output: Gloo
    prints "[Gloo] Rank .. is connected to .." to C-level stdout when a
    context is built, which would corrupt the byte-exact stream when
    the output is stdout. The warm-up runs the first collective with fd
    1 redirected to stderr; later collectives reuse the context."""
    if nproc <= 1:
        return
    import sys

    try:
        sys.stdout.flush()
        saved = os.dup(1)
    except OSError:
        saved = None
    try:
        if saved is not None:
            os.dup2(2, 1)
        from jax.experimental import multihost_utils

        multihost_utils.process_allgather(np.zeros(1, np.int32))
    finally:
        if saved is not None:
            os.dup2(saved, 1)
            os.close(saved)


def _done_barrier():
    if jax.process_count() <= 1:
        return
    try:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(
            f"stringsext:dist-done:{_GATHER_EPOCH}"
        )
    except Exception:
        pass  # best-effort: teardown races are a robustness concern only


def simulate_ranks(args, paths, nprocs: int, engine: str = "auto"):
    """In-process simulation of the distributed data plane: the
    boundary search, shard scans, entry-mode composition and rank-0
    holdback merge are pure functions (no collectives), so N ranks run
    sequentially in one process. Used by tests/test_distributed_sim.py
    and the randomized distributed fuzz (scripts/fuzz.py --dist
    branch).

    Returns (output_bytes, stats) where stats carries the row bounds,
    the per-rank shard read sizes (the O(shard) evidence - excludes
    the bounded boundary-search windows), and n_rows.
    """
    import io as _io

    from ..encodings import encoding_kind
    from ..input import slice_table
    from ..mission import Missions
    from ..run import _emit_lines

    ms = Missions.from_args(args)
    spans = stat_spans(paths)
    sl = slice_table(_SpanStream(spans))
    n_rows = len(sl[0])
    bounds = shard_row_bounds(paths, spans, ms, nprocs)
    if bounds is None:
        bounds = [0] + [n_rows] * nprocs
    has_iso = any(
        encoding_kind(m.encoding_name) == "iso-2022-jp" for m in ms.v
    )
    transfers = []
    shard_data = []
    shard_read = []
    for s in range(nprocs):
        r0, r1 = bounds[s], bounds[s + 1]
        sd = None
        t = -1
        if r1 > r0:
            lo = int(sl[0][r0])
            hi = int(sl[0][r1 - 1] + sl[1][r1 - 1])
            sd = _read_range(paths, spans, lo, hi)
            if has_iso:
                t = _iso_mode_transfer(sd)
        shard_data.append(sd)
        shard_read.append(0 if sd is None else len(sd))
        transfers.append(t)

    out = _io.BytesIO()
    out.write(b"\xef\xbb\xbf")
    held = []
    for s in range(nprocs):
        em = _compose_entry_mode(transfers, s) if has_iso else 0
        pm, (_lo, p_hi) = scan_shard(
            paths, spans, ms, sl, bounds[s], bounds[s + 1],
            entry_mode=em, engine=engine, data=shard_data[s],
        )
        rows = held + [(ms.v[i], res, sb) for i, (res, sb) in
                       enumerate(pm)]
        emit, hold = [], []
        last = s == nprocs - 1
        for m, res, sb in rows:
            if last:
                emit.append((m, res, sb))
                continue
            bound = m.counter_offset + p_hi
            pos = res["position"]
            cut = int(np.searchsorted(pos, bound, "left"))
            emit.append((m, {k: v[:cut] for k, v in res.items()}, sb))
            if cut < len(pos):
                hold.append((m, {k: v[cut:] for k, v in res.items()}, sb))
        held = hold
        _emit_lines(out, args, emit)
    out.write(b"\n")
    return out.getvalue(), {
        "bounds": bounds,
        "n_rows": n_rows,
        "shard_read": shard_read,
    }
