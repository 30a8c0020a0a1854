"""Native runtime: C++ emission engine bindings (ctypes).

Builds `libemitter.so` on demand with g++ (cached next to the source,
-march=native). When no toolchain is available, falls back to the
PREBUILT portable `libemitter-generic.so` that wheels ship
(-march=x86-64-v3, compiled by setup.py at wheel-build time - the
analog of the reference's prebuilt release binaries) with a one-time
warning. Only if neither exists does the engine report unavailable
(loudly), and callers fall back to the pure-Python automaton
(identical output, much slower).
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import sys
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "emitter.cpp")
_LIB = os.path.join(_DIR, "libemitter.so")
_LIB_GENERIC = os.path.join(_DIR, "libemitter-generic.so")

_lib = None
_lib_tried = False
_lib_lock = threading.Lock()


class _SeMission(ctypes.Structure):
    _fields_ = [
        ("af_lo", ctypes.c_uint64),
        ("af_hi", ctypes.c_uint64),
        ("ubf", ctypes.c_uint64),
        ("grep_char", ctypes.c_int32),
        ("chars_min_nb", ctypes.c_int32),
        ("line_max", ctypes.c_int32),
        ("same_block", ctypes.c_int32),
        ("counter_offset", ctypes.c_uint64),
        ("kind", ctypes.c_int32),
        ("table256", ctypes.POINTER(ctypes.c_int32)),
        ("pair_cp", ctypes.POINTER(ctypes.c_int32)),
        ("pair_cp2", ctypes.POINTER(ctypes.c_int32)),
        ("gb_ptrs", ctypes.POINTER(ctypes.c_int64)),
        ("gb_cps", ctypes.POINTER(ctypes.c_int32)),
        ("gb_nranges", ctypes.c_int32),
        ("multi_keys", ctypes.POINTER(ctypes.c_int32)),
        ("multi_cp1", ctypes.POINTER(ctypes.c_int32)),
        ("multi_cp2", ctypes.POINTER(ctypes.c_int32)),
        ("n_multi", ctypes.c_int32),
        ("input_refs", ctypes.c_int32),
    ]


def _build() -> bool:
    # Built on the machine that runs it, so -march=native is safe; fall
    # back to plain -O3 for toolchains that reject it.
    for extra in (["-O3", "-march=native", "-funroll-loops"], ["-O3"]):
        try:
            subprocess.run(
                ["g++", *extra, "-shared", "-fPIC", "-std=c++17",
                 "-o", _LIB, _SRC],
                check=True,
                capture_output=True,
            )
            return True
        except (OSError, subprocess.CalledProcessError) as e:
            err = e
    sys.stderr.write(f"stringsext-tpu: native emitter build failed: {err}\n")
    return False


def get_lib():
    """Load (building if needed) the native library, or None.

    Thread-safe: the per-mission scan threads may race the FIRST call
    (nothing loads the lib on the main thread for file inputs), and
    without the lock a losing thread would observe _lib_tried=True with
    _lib still None and wrongly fall back / crash."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    with _lib_lock:
        return _get_lib_locked()


def _get_lib_locked():
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    try:
        _lib = _load_lib()
    finally:
        # Only set once the attempt COMPLETED: the unlocked fast path
        # in get_lib reads it without the lock.
        _lib_tried = True
    return _lib


def _load_lib():
    path = _LIB
    stale = not os.path.exists(_LIB) or (
        os.path.exists(_SRC)
        and os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
    )
    if stale and not _build():
        if os.path.exists(_LIB_GENERIC):
            sys.stderr.write(
                "stringsext-tpu: no native toolchain; using the "
                "prebuilt generic (x86-64-v3) emitter - install g++ "
                "for a machine-tuned build\n"
            )
            path = _LIB_GENERIC
        else:
            sys.stderr.write(
                "stringsext-tpu: native engine unavailable (no "
                "toolchain and no prebuilt library); falling back to "
                "the pure-Python engine (identical output, much "
                "slower)\n"
            )
            return None
    try:
        lib = ctypes.CDLL(path, use_errno=True)
    except OSError:
        if path != _LIB_GENERIC and os.path.exists(_LIB_GENERIC):
            try:
                lib = ctypes.CDLL(_LIB_GENERIC, use_errno=True)
            except OSError:
                return None
        else:
            return None
    P = ctypes.POINTER
    lib.se_scan.restype = ctypes.c_void_p
    lib.se_scan.argtypes = [
        ctypes.c_void_p,  # data
        ctypes.c_int64,  # total
        ctypes.c_void_p,  # slice_starts int64*
        ctypes.c_void_p,  # slice_lens int32*
        ctypes.c_void_p,  # slice_file_ids int32*
        ctypes.c_void_p,  # slice_is_last uint8*
        ctypes.c_int64,  # nslices
        P(_SeMission),
        ctypes.c_void_p,  # state_io int64[5] or NULL
        ctypes.c_void_p,  # leftover_io int32* or NULL
        ctypes.c_void_p,  # leftover_len_io int32* or NULL
        ctypes.c_int32,  # leftover_cap
        ctypes.c_void_p,  # hot_start int64* or NULL
        ctypes.c_void_p,  # hot_end int64* or NULL
        ctypes.c_int64,  # n_hot
        ctypes.c_void_p,  # ft_start int64* or NULL (run-table feed)
        ctypes.c_void_p,  # ft_end int64* or NULL
        ctypes.c_void_p,  # ft_co_base int64* or NULL
        ctypes.c_void_p,  # ft_co int64* or NULL (payload char offsets)
        ctypes.c_void_p,  # ft_ip int64* or NULL (input char offsets)
        ctypes.c_void_p,  # ft_pay uint8* or NULL (decoded payload)
        ctypes.c_int64,  # n_ft
        P(ctypes.c_int64),  # out_count
        P(P(ctypes.c_uint64)),  # position
        P(P(ctypes.c_int8)),  # precision
        P(P(ctypes.c_uint8)),  # completes
        P(P(ctypes.c_int32)),  # file_id
        P(P(ctypes.c_uint64)),  # str_off
        P(P(ctypes.c_uint32)),  # str_len
        P(P(ctypes.c_uint8)),  # strbuf
        P(ctypes.c_int64),  # strbuf_len
    ]
    lib.se_free.argtypes = [ctypes.c_void_p]
    lib.se_format.restype = ctypes.c_void_p
    lib.se_format.argtypes = [
        ctypes.c_int64,  # n
        ctypes.c_void_p,  # position uint64*
        ctypes.c_void_p,  # precision int8*
        ctypes.c_void_p,  # completes uint8*
        ctypes.c_void_p,  # file_id int32*
        ctypes.c_void_p,  # midx int32*
        ctypes.c_void_p,  # str_off uint64*
        ctypes.c_void_p,  # str_len uint32*
        ctypes.c_void_p,  # strbufs uint8**
        ctypes.c_void_p,  # enc_prefix bytes
        ctypes.c_void_p,  # enc_pref_off int32*
        ctypes.c_void_p,  # enc_pref_len int32*
        ctypes.c_int32,  # flags
        ctypes.c_char,  # radix
        P(P(ctypes.c_uint8)),  # out_buf
        P(ctypes.c_int64),  # out_len
    ]
    lib.se_format_free.argtypes = [ctypes.c_void_p]
    lib.se_format_fd.restype = ctypes.c_int64
    lib.se_format_fd.argtypes = [ctypes.c_int32] + lib.se_format.argtypes[:-2]
    lib.se_merge_fd.restype = ctypes.c_int64
    lib.se_merge_fd.argtypes = [
        ctypes.c_int32,  # fd
        ctypes.c_int32,  # k streams
        ctypes.c_void_p,  # n_m int64[k]
        ctypes.c_void_p,  # pos_m uint64*[k]
        ctypes.c_void_p,  # prec_m int8*[k]
        ctypes.c_void_p,  # comp_m uint8*[k]
        ctypes.c_void_p,  # fid_m int32*[k]
        ctypes.c_void_p,  # soff_m uint64*[k]
        ctypes.c_void_p,  # slen_m uint32*[k]
        ctypes.c_void_p,  # strbufs uint8*[k]
        ctypes.c_void_p,  # inbufs uint8*[k] (SE_INREF base per stream)
        ctypes.c_void_p,  # mission_ids int32[k]
        ctypes.c_void_p,  # enc_prefix bytes
        ctypes.c_void_p,  # enc_pref_off int32[k]
        ctypes.c_void_p,  # enc_pref_len int32[k]
        ctypes.c_int32,  # flags
        ctypes.c_char,  # radix
    ]
    lib.se_merge_buf.restype = ctypes.c_int64
    lib.se_merge_buf.argtypes = [
        ctypes.c_int32,  # k streams
        ctypes.c_void_p,  # c0 int64[k] (slab row starts)
        ctypes.c_void_p,  # c1 int64[k] (slab row ends)
        ctypes.c_void_p,  # pos_m uint64*[k]
        ctypes.c_void_p,  # prec_m int8*[k]
        ctypes.c_void_p,  # comp_m uint8*[k]
        ctypes.c_void_p,  # fid_m int32*[k]
        ctypes.c_void_p,  # soff_m uint64*[k]
        ctypes.c_void_p,  # slen_m uint32*[k]
        ctypes.c_void_p,  # strbufs uint8*[k]
        ctypes.c_void_p,  # inbufs uint8*[k]
        ctypes.c_void_p,  # mission_ids int32[k]
        ctypes.c_void_p,  # enc_prefix bytes
        ctypes.c_void_p,  # enc_pref_off int32[k]
        ctypes.c_void_p,  # enc_pref_len int32[k]
        ctypes.c_int32,  # flags
        ctypes.c_char,  # radix
        ctypes.c_int64,  # cap (exact output upper bound)
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),  # out_buf
    ]
    return lib


def native_format(position, precision, completes, file_id, midx, str_off,
                  str_len, strbufs, enc_prefixes, flags, radix_char,
                  fd=None):
    """Byte-exact merge-ordered line formatting in C++ (se_format).
    All array arguments are contiguous numpy arrays already gathered
    into merge order; `strbufs` is the per-mission string buffer list
    (bytes), `enc_prefixes` the per-mission b"(a ENC)\\t" prefixes.
    Returns the formatted bytes, or None when the library is absent.
    With `fd` given, the payload is written straight to that file
    descriptor in C (se_format_fd - no Python bytes / BufferedWriter
    copies) and the byte count is returned; raises OSError on a write
    failure."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    n = len(position)
    bufs = (ctypes.c_void_p * len(strbufs))()
    keep = []  # zero-copy views pinning the underlying buffers
    for k, sb in enumerate(strbufs):
        a = np.frombuffer(sb, np.uint8) if len(sb) else np.zeros(1, np.uint8)
        keep.append(a)
        bufs[k] = a.ctypes.data
    ep = b"".join(enc_prefixes)
    ep_buf = ctypes.create_string_buffer(ep, max(len(ep), 1))
    offs = np.zeros(len(enc_prefixes), np.int32)
    lens = np.array([len(x) for x in enc_prefixes], np.int32)
    if len(enc_prefixes) > 1:
        offs[1:] = np.cumsum(lens[:-1])

    def p(a):
        return a.ctypes.data if len(a) else None

    common = (
        n, p(position), p(precision), p(completes), p(file_id), p(midx),
        p(str_off), p(str_len), ctypes.addressof(bufs),
        ctypes.addressof(ep_buf), offs.ctypes.data, lens.ctypes.data,
        flags, radix_char,
    )
    if fd is not None:
        wrote = lib.se_format_fd(fd, *common)
        if wrote < 0:
            raise OSError(ctypes.get_errno(), "se_format_fd write failed")
        return wrote
    out_buf = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_int64()
    handle = lib.se_format(
        *common, ctypes.byref(out_buf), ctypes.byref(out_len),
    )
    try:
        return ctypes.string_at(out_buf, out_len.value)
    finally:
        lib.se_format_free(handle)


# Slab-parallel merge thresholds: slabs smaller than this many rows
# are not worth the thread + quantile bookkeeping.
_SLAB_ROWS = 1 << 16
_MERGE_POOL = None
_MERGE_POOL_LOCK = threading.Lock()


def _merge_pool(workers: int):
    global _MERGE_POOL
    with _MERGE_POOL_LOCK:
        if _MERGE_POOL is None:
            from concurrent.futures import ThreadPoolExecutor

            _MERGE_POOL = ThreadPoolExecutor(max_workers=workers)
        return _MERGE_POOL


def _merge_workers(n_streams: int) -> int:
    """Worker count for the slab-parallel merge (the parallel analog of
    the reference's single merger thread, main.rs:103-136).
    STRINGSEXT_MERGE_WORKERS overrides; 1 disables slabbing. Default:
    the cores LEFT OVER after one scan thread per stream plus the
    reader - on a host where scans already saturate the cores, the
    fused single-pass merge (no slab buffers, no extra copy) measured
    faster on a 2-core host, so slabbing must not steal their
    cycles."""
    try:
        return max(1, int(os.environ.get("STRINGSEXT_MERGE_WORKERS", "")))
    except ValueError:
        return max(1, (os.cpu_count() or 1) - n_streams - 1)


def native_merge_fd(fd, streams, enc_prefixes, flags, radix_char):
    """Fused k-way merge + format + straight-to-fd write.

    `streams` is a list of (res, strbuf, mission_id[, inbuf]) where
    `res` holds the per-mission finding columns (position uint64,
    precision int8, completes uint8, file_id int32, str_off uint64,
    str_len uint32) in scan (position-sorted) order; ties on (position,
    mission_id) across streams resolve to the earliest stream, matching
    the stable lexsort of the Python path. `inbuf`, when present, is
    the stream's input byte buffer for SE_INREF-flagged str_off values
    (native_scan input_refs=True). `enc_prefixes` is per-STREAM.

    Large batches are partitioned BY POSITION RANGE into independent
    slabs (the merge key is position-major) rendered concurrently on
    all cores (se_merge_buf) and written in order; small batches take
    the single fused C pass (se_merge_fd). Returns bytes written, or
    None when the library is absent; raises OSError on a write
    failure."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    k = len(streams)
    keep = []
    cols = []  # per-stream dict of contiguous column arrays

    for s in streams:
        d = {}
        for cname, dtype in (
            ("position", np.uint64), ("precision", np.int8),
            ("completes", np.uint8), ("file_id", np.int32),
            ("str_off", np.uint64), ("str_len", np.uint32),
        ):
            d[cname] = np.ascontiguousarray(s[0][cname], dtype=dtype)
        cols.append(d)
        keep.append(d)

    n_m = np.array([len(d["position"]) for d in cols], np.int64)
    ptr_tables = {}
    for cname in ("position", "precision", "completes", "file_id",
                  "str_off", "str_len"):
        arr = (ctypes.c_void_p * k)()
        for j in range(k):
            arr[j] = cols[j][cname].ctypes.data
        ptr_tables[cname] = arr
    bufs = (ctypes.c_void_p * k)()
    inbufs = (ctypes.c_void_p * k)()
    for j, s in enumerate(streams):
        sb = s[1]
        a = np.frombuffer(sb, np.uint8) if len(sb) else np.zeros(1, np.uint8)
        keep.append(a)
        bufs[j] = a.ctypes.data
        ib = s[3] if len(s) > 3 else None
        if ib is not None and len(ib):
            ia = np.ascontiguousarray(ib, dtype=np.uint8)
            keep.append(ia)
            inbufs[j] = ia.ctypes.data
        else:
            inbufs[j] = bufs[j]  # flag never set for this stream
    mids = np.array([s[2] for s in streams], np.int32)
    ep = b"".join(enc_prefixes)
    ep_buf = ctypes.create_string_buffer(ep, max(len(ep), 1))
    offs = np.zeros(k, np.int32)
    lens = np.array([len(x) for x in enc_prefixes], np.int32)
    if k > 1:
        offs[1:] = np.cumsum(lens[:-1])

    common = (
        ctypes.addressof(ptr_tables["position"]),
        ctypes.addressof(ptr_tables["precision"]),
        ctypes.addressof(ptr_tables["completes"]),
        ctypes.addressof(ptr_tables["file_id"]),
        ctypes.addressof(ptr_tables["str_off"]),
        ctypes.addressof(ptr_tables["str_len"]),
        ctypes.addressof(bufs), ctypes.addressof(inbufs),
        mids.ctypes.data,
        ctypes.addressof(ep_buf), offs.ctypes.data, lens.ctypes.data,
        flags, radix_char,
    )

    n_tot = int(n_m.sum())
    workers = _merge_workers(k)
    n_slabs = min(workers, max(1, n_tot // _SLAB_ROWS))
    if n_slabs >= 2:
        return _merge_fd_slabs(
            lib, fd, k, cols, enc_prefixes, flags, n_slabs, common, keep
        )

    wrote = lib.se_merge_fd(fd, k, n_m.ctypes.data, *common)
    if wrote < 0:
        raise OSError(ctypes.get_errno(), "se_merge_fd write failed")
    return wrote


def _merge_fd_slabs(lib, fd, k, cols, enc_prefixes, flags, n_slabs,
                    common, keep):
    """Render n_slabs position-range slabs concurrently (se_merge_buf,
    GIL released per call) and write them to `fd` in order while later
    slabs render. Byte-identical to the single fused pass: every
    stream's rows are cut at the SAME position values with searchsorted
    'left', so all (position, mission_id) ties stay within one slab."""
    import numpy as np

    # Cut positions: quantiles of the largest stream (balance only -
    # correctness holds for any cut values).
    big = max(range(k), key=lambda j: len(cols[j]["position"]))
    pb = cols[big]["position"]
    cuts = pb[[len(pb) * s // n_slabs for s in range(1, n_slabs)]]
    bounds = []  # per stream: int64[n_slabs+1] row bounds
    for j in range(k):
        pj = cols[j]["position"]
        b = np.empty(n_slabs + 1, np.int64)
        b[0] = 0
        b[-1] = len(pj)
        b[1:-1] = np.searchsorted(pj, cuts, "left")
        bounds.append(b)
    # Exact per-slab output caps: rows * (32 >= SE_LINE_META_MAX +
    # slack + enc prefix) + payload bytes (cumsum of str_len).
    show_enc = bool(flags & 4)
    pref = [len(p) if show_enc else 0 for p in enc_prefixes]
    csums = []
    for j in range(k):
        c = np.zeros(len(cols[j]["str_len"]) + 1, np.int64)
        np.cumsum(cols[j]["str_len"], out=c[1:])
        csums.append(c)

    def render(s):
        c0 = np.ascontiguousarray([bounds[j][s] for j in range(k)],
                                  np.int64)
        c1 = np.ascontiguousarray([bounds[j][s + 1] for j in range(k)],
                                  np.int64)
        cap = 64
        for j in range(k):
            rows = int(c1[j] - c0[j])
            cap += rows * (32 + pref[j]) + int(
                csums[j][c1[j]] - csums[j][c0[j]]
            )
        out_buf = ctypes.POINTER(ctypes.c_uint8)()
        n = lib.se_merge_buf(
            k, c0.ctypes.data, c1.ctypes.data, *common,
            cap, ctypes.byref(out_buf),
        )
        return n, out_buf

    pool = _merge_pool(os.cpu_count() or 1)
    futs = [pool.submit(render, s) for s in range(n_slabs)]
    total = 0
    for f in futs:
        n, out_buf = f.result()
        if n < 0:
            raise MemoryError("se_merge_buf allocation failed")
        try:
            if n:
                mv = memoryview(
                    (ctypes.c_ubyte * n).from_address(
                        ctypes.addressof(out_buf.contents)
                    )
                )
                off = 0
                while off < n:
                    off += os.write(fd, mv[off:])
        finally:
            lib.se_format_free(out_buf)
        total += n
    del keep  # explicit: column buffers outlive every render
    return total


# kind codes (emitter.cpp). Big5's four WHATWG double-codepoint
# pointers ride a sparse (key, cp1, cp2) side table next to the flat
# pair-cp table.
KIND_CODE = {
    "utf8": 0,
    "utf16le": 1,
    "utf16be": 2,
    "single-byte": 3,
    "euc-kr": 4,
    "shift_jis": 6,
    "euc-jp": 7,
    "gb18030": 8,
    "iso-2022-jp": 9,  # jis0208 cps via the EUC-JP pair table
    "big5": 5,  # double-cp pairs via the sparse multi table
    # WHATWG replacement decoder: the whole stream is one malformed
    # event, so no finding can ever exist; an all-invalid byte table
    # yields the identical (empty) observable output per byte.
    "replacement": 3,
}


def native_supported(encoding_kind: str) -> bool:
    return encoding_kind in KIND_CODE and get_lib() is not None


@functools.lru_cache(maxsize=None)
def _pair_cp_table(kind: str) -> np.ndarray:
    """int32[256,256]: decoded cp per (lead, trail) pair, -1 invalid.
    Sourced from the vendored WHATWG index corpus; Big5's four
    double-codepoint pairs stay -1 here (they ride the sparse multi
    side table, see `native_scan`)."""
    from ..encodings import whatwg

    return whatwg.pair_cp(kind)


@functools.lru_cache(maxsize=None)
def _eucjp_0212_cp_table() -> np.ndarray:
    from ..encodings import whatwg

    return whatwg.jis0212_cp()


def _gb18030_ranges() -> "tuple[np.ndarray, np.ndarray]":
    """(pointers, cps): breakpoints of the gb18030 four-byte linear
    ranges (vendored WHATWG gb18030-ranges table)."""
    from ..encodings import whatwg

    return whatwg.gb18030_ranges()


class _NativeOwner:
    """Frees one se_scan Output when the last numpy view over it dies."""

    def __init__(self, lib, handle):
        self._lib = lib
        self._h = handle

    def __del__(self):
        try:
            self._lib.se_free(self._h)
        except Exception:
            pass  # interpreter shutdown


class _OwnedArray(np.ndarray):
    """ndarray subclass carrying the C-buffer owner; slices/views keep
    the owner alive through the .base chain."""


def _owned_view(ptr, n, dtype, owner):
    import numpy as _np

    nbytes = n * _np.dtype(dtype).itemsize
    addr = ctypes.cast(ptr, ctypes.c_void_p).value
    cbuf = (ctypes.c_ubyte * nbytes).from_address(addr)
    a = _np.frombuffer(cbuf, dtype=dtype).view(_OwnedArray)
    a._owner = owner
    return a


def native_scan(
    mission,
    data: np.ndarray,
    slice_starts: np.ndarray,
    slice_lens: np.ndarray,
    slice_file_ids: np.ndarray,
    slice_is_last: np.ndarray,
    state: Optional[dict] = None,
    hot_ranges: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    input_refs: bool = False,
    runtable_feed=None,
):
    """Scan one mission natively. Returns (columns_dict, strbuf_bytes).

    `runtable_feed`, when given, is (run_start, run_end, co_base, co,
    ip, payload): EXACT device-extracted accepted-char runs plus the
    device-decoded UTF-8 payload with per-char slot offsets
    (STRINGSEXT_RUNTABLE_FEED=1; docs/KERNELS.md design 1; slot layout
    documented on ops/device_events._assemble_feed). payload=None means
    the payload is the input buffer itself (UTF-8). The emitter
    consumes whole runs: a full window inside one run becomes a few
    payload memcpys instead of a per-char decode walk.

    `input_refs=True` lets the fast lanes emit findings whose bytes are
    verbatim input spans as SE_INREF-flagged str_off values (bit 63 =
    offset into `data`, zero strbuf copy). ONLY pass it when every
    consumer of the result resolves the flag (the fused se_merge_fd
    output path with per-stream inbufs).

    `state`, when given, is the resumable scanner state
    {"consumed", "cursor", "printed_maybe_cut", "leftover_cps"} - used
    as the initial state and UPDATED IN PLACE with the final state
    (checkpoint/resume and chunked streaming; scanner.rs:40-68 analog).

    `hot_ranges`, when given, is (starts, ends): sorted, disjoint byte
    ranges containing every accepted char run (from the device scan
    passes). Windows outside them are provably finding-free and are
    skipped whole - the device->host integration point.
    """
    from ..encodings import encoding_kind, full_byte_table

    lib = get_lib()
    kind = encoding_kind(mission.encoding_name)
    code = KIND_CODE[kind]

    P32 = ctypes.POINTER(ctypes.c_int32)
    P64 = ctypes.POINTER(ctypes.c_int64)
    keepalive = []

    def p32(arr):
        keepalive.append(arr)
        return arr.ctypes.data_as(P32)

    table_ptr = pair_ptr = pair2_ptr = gbp_ptr = gbc_ptr = None
    mk_ptr = m1_ptr = m2_ptr = None
    gb_n = n_multi = 0
    if kind == "single-byte":
        table_ptr = p32(np.ascontiguousarray(
            full_byte_table(mission.encoding_name), dtype=np.int32))
    elif kind == "replacement":
        table_ptr = p32(np.full(256, -1, dtype=np.int32))
    elif kind in ("euc-kr", "shift_jis", "gb18030", "euc-jp", "iso-2022-jp",
                  "big5"):
        table_kind = {"euc-kr": "euc-kr", "shift_jis": "shift_jis",
                      "gb18030": "gb18030", "euc-jp": "euc-jp",
                      "iso-2022-jp": "euc-jp", "big5": "big5"}[kind]
        pair_ptr = p32(np.ascontiguousarray(_pair_cp_table(table_kind)))
        if kind == "euc-jp":
            pair2_ptr = p32(np.ascontiguousarray(_eucjp_0212_cp_table()))
        if kind == "big5":
            from ..engine.events_cjk import _pair_table

            _, multi = _pair_table("big5")
            keys = sorted(multi.keys())
            mk = np.array(keys, dtype=np.int32)
            m1 = np.array([multi[k][0] for k in keys], dtype=np.int32)
            m2 = np.array([multi[k][1] if len(multi[k]) > 1 else 0 for k in keys],
                          dtype=np.int32)
            keepalive += [mk, m1, m2]
            mk_ptr = mk.ctypes.data_as(P32)
            m1_ptr = m1.ctypes.data_as(P32)
            m2_ptr = m2.ctypes.data_as(P32)
            n_multi = len(keys)
        if kind == "gb18030":
            gp, gc = _gb18030_ranges()
            gp = np.ascontiguousarray(gp)
            gc = np.ascontiguousarray(gc)
            keepalive += [gp, gc]
            gbp_ptr = gp.ctypes.data_as(P64)
            gbc_ptr = gc.ctypes.data_as(P32)
            gb_n = len(gp)

    f = mission.filter
    sm = _SeMission(
        af_lo=f.af & 0xFFFFFFFFFFFFFFFF,
        af_hi=(f.af >> 64) & 0xFFFFFFFFFFFFFFFF,
        ubf=f.ubf,
        grep_char=-1 if f.grep_char is None else f.grep_char,
        chars_min_nb=mission.chars_min_nb,
        line_max=mission.output_line_char_nb_max,
        same_block=1 if mission.require_same_unicode_block else 0,
        counter_offset=mission.counter_offset,
        kind=code,
        table256=table_ptr,
        pair_cp=pair_ptr,
        pair_cp2=pair2_ptr,
        gb_ptrs=gbp_ptr,
        gb_cps=gbc_ptr,
        gb_nranges=gb_n,
        multi_keys=mk_ptr,
        multi_cp1=m1_ptr,
        multi_cp2=m2_ptr,
        n_multi=n_multi,
        input_refs=1 if input_refs else 0,
    )

    data = np.ascontiguousarray(data, dtype=np.uint8)
    slice_starts = np.ascontiguousarray(slice_starts, dtype=np.int64)
    slice_lens = np.ascontiguousarray(slice_lens, dtype=np.int32)
    slice_file_ids = np.ascontiguousarray(slice_file_ids, dtype=np.int32)
    slice_is_last = np.ascontiguousarray(slice_is_last, dtype=np.uint8)

    state_arr = None
    leftover_arr = None
    leftover_len = None
    leftover_cap = 0
    if state is not None:
        state_arr = np.array(
            [
                state.get("consumed", mission.counter_offset),
                state.get("cursor", 0),
                1 if state.get("printed_maybe_cut") else 0,
                state.get("dec_mode", 0),
                1 if state.get("dec_output_flag") else 0,
            ],
            dtype=np.int64,
        )
        leftover_cap = max(mission.output_line_char_nb_max + 4, 64)
        leftover_arr = np.zeros(leftover_cap, np.int32)
        lo = state.get("leftover_cps", [])
        leftover_arr[: len(lo)] = lo
        leftover_len = ctypes.c_int32(len(lo))

    hot_s = hot_e = None
    if hot_ranges is not None:
        hot_s = np.ascontiguousarray(hot_ranges[0], dtype=np.int64)
        hot_e = np.ascontiguousarray(hot_ranges[1], dtype=np.int64)

    ft = [None] * 6
    n_ft = 0
    if runtable_feed is not None:
        rs, re, cb, co, ip, pay = runtable_feed
        ft = [
            np.ascontiguousarray(rs, np.int64),
            np.ascontiguousarray(re, np.int64),
            np.ascontiguousarray(cb, np.int64),
            np.ascontiguousarray(co, np.int64),
            np.ascontiguousarray(ip, np.int64),
            # payload None = the input buffer (UTF-8 zero-copy)
            None if pay is None else np.ascontiguousarray(pay, np.uint8),
        ]
        keepalive += [a for a in ft if a is not None]
        n_ft = len(ft[0])

    P = ctypes.POINTER
    count = ctypes.c_int64()
    p_pos = P(ctypes.c_uint64)()
    p_prec = P(ctypes.c_int8)()
    p_comp = P(ctypes.c_uint8)()
    p_fid = P(ctypes.c_int32)()
    p_soff = P(ctypes.c_uint64)()
    p_slen = P(ctypes.c_uint32)()
    p_sbuf = P(ctypes.c_uint8)()
    sbuf_len = ctypes.c_int64()

    handle = lib.se_scan(
        data.ctypes.data,
        len(data),
        slice_starts.ctypes.data,
        slice_lens.ctypes.data,
        slice_file_ids.ctypes.data,
        slice_is_last.ctypes.data,
        len(slice_lens),
        ctypes.byref(sm),
        state_arr.ctypes.data if state_arr is not None else None,
        leftover_arr.ctypes.data if leftover_arr is not None else None,
        ctypes.addressof(leftover_len) if leftover_len is not None else None,
        leftover_cap,
        hot_s.ctypes.data if hot_s is not None else None,
        hot_e.ctypes.data if hot_e is not None else None,
        0 if hot_s is None else len(hot_s),
        ft[0].ctypes.data if n_ft else None,
        ft[1].ctypes.data if n_ft else None,
        ft[2].ctypes.data if n_ft else None,
        ft[3].ctypes.data if n_ft else None,
        ft[4].ctypes.data if n_ft else None,
        (data.ctypes.data if ft[5] is None else ft[5].ctypes.data)
        if n_ft else None,
        n_ft,
        ctypes.byref(count),
        ctypes.byref(p_pos),
        ctypes.byref(p_prec),
        ctypes.byref(p_comp),
        ctypes.byref(p_fid),
        ctypes.byref(p_soff),
        ctypes.byref(p_slen),
        ctypes.byref(p_sbuf),
        ctypes.byref(sbuf_len),
    )
    n = count.value
    # Zero-copy marshaling: the result arrays are VIEWS over the C
    # Output buffers; a shared owner frees the handle (se_free) when
    # the last view dies. Copying these out cost ~0.25 s per 128 MiB
    # on text-dense scans (strbuf is input-sized there) - a full extra
    # pass the views avoid. Consumers never mutate the columns (masks,
    # concatenates, and slices all allocate fresh arrays).
    owner = _NativeOwner(lib, handle)

    def arr(ptr, dtype):
        if n == 0:
            return np.zeros(0, dtype)
        return _owned_view(ptr, n, dtype, owner)

    res = {
        "position": arr(p_pos, np.uint64),
        "precision": arr(p_prec, np.int8),
        "completes": arr(p_comp, np.uint8),
        "file_id": arr(p_fid, np.int32),
        "str_off": arr(p_soff, np.uint64),
        "str_len": arr(p_slen, np.uint32),
    }
    # memoryview: compares/slices/joins like bytes (content semantics)
    # while keeping the owner alive through .obj -> _OwnedArray.
    sb = (
        memoryview(_owned_view(p_sbuf, sbuf_len.value, np.uint8, owner))
        if sbuf_len.value
        else b""
    )
    if state is not None:
        state["consumed"] = int(state_arr[0])
        state["cursor"] = int(state_arr[1])
        state["printed_maybe_cut"] = bool(state_arr[2])
        state["dec_mode"] = int(state_arr[3])
        state["dec_output_flag"] = bool(state_arr[4])
        state["leftover_cps"] = leftover_arr[: leftover_len.value].tolist()
    return res, sb
