"""Exact decode-event generation using the device classification lanes.

Bridges the device passes (ops/classify.py, ops/classify_cjk.py) to the
host emission automaton: lanes are computed on device, transferred, and
compacted to the same `Events` struct the numpy generators produce -
and, for the run-table feed, to exact accepted-char run tables plus the
device-decoded UTF-8 payload that the native emitter consumes instead
of re-walking bytes (docs/KERNELS.md design 1; the on-device analog of
the reference's decode loop, finding_collection.rs:84-342).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..encodings import (
    KIND_SINGLE_BYTE,
    KIND_UTF16BE,
    KIND_UTF16LE,
    KIND_UTF8,
    encoding_kind,
    full_byte_table,
)
from ..engine.events import Events, generate_events
from . import classify

# Kinds with an exact device classification kernel (the run-table feed
# engages for ALL of them, modal ISO-2022-JP included: its global mode
# chain is a device prefix scan - see ops/classify_iso2022.py).
FEED_KINDS = (
    KIND_UTF8, KIND_UTF16LE, KIND_UTF16BE, KIND_SINGLE_BYTE,
    "big5", "euc-jp", "euc-kr", "gb18030", "shift_jis", "iso-2022-jp",
)


def lanes_to_events(lanes, base: int = 0) -> Events:
    """Compact per-byte lanes into an event list (host side)."""
    start = np.asarray(lanes.start)
    pending = np.asarray(lanes.pending)
    starts = np.flatnonzero(start & ~pending)
    length = np.asarray(lanes.length)[starts]
    cp = np.asarray(lanes.cp)[starts]
    report_off = np.asarray(lanes.report_off)[starts]
    pushback = np.asarray(lanes.pushback)[starts]
    pos = starts.astype(np.int64) + base
    return Events(pos, length.astype(np.int32), cp.astype(np.int32),
                  pos + report_off, pushback.astype(np.int32))


def _bucket(n: int, minimum: int = 1024) -> int:
    """Pad target: next power of two (one jit compile per bucket)."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


@functools.lru_cache(maxsize=None)
def _compact_fn():
    """Jitted device compaction of (mask, length, cp): positions ride
    a BITMASK (cap/8 bytes, packed with 8 strided slices - elementwise,
    no scatter) and per-char data rides ONE scatter of the packed word
    (cp << 3) | length (cp <= 0x10FFFF = 21 bits, length <= 4 = 3
    bits; slot `cap` is the dump slot for unset lanes). Keeps the
    feed's compaction ON DEVICE so ~n/8 + 4*chars bytes - not the full
    per-byte lanes (~9 B per input byte) - cross the device->host
    link."""

    @jax.jit
    def compact(mask, length, cp):
        cap = mask.shape[0]
        m8 = mask.astype(jnp.uint8)
        bits = jnp.zeros(cap // 8, jnp.uint8)
        for k in range(8):
            bits = bits | (
                jax.lax.slice(m8, (k,), (cap - 7 + k,), (8,)) << k)
        midx = jnp.cumsum(mask.astype(jnp.int32)) - 1
        tgt = jnp.where(mask, midx, cap)
        packed = ((cp.astype(jnp.int32) << 3)
                  | (length.astype(jnp.int32) & 7))
        out = jnp.zeros(cap + 1, jnp.int32).at[tgt].set(packed)
        return midx[-1] + 1, bits, out

    return compact


def _fetch_compact(cnt, bits, packed):
    """D2H fetch of a _compact_fn result: the full bitmask (cap/8
    bytes) + the first `cnt` packed chars, sliced on device to a
    power-of-two bucket (one compiled slice per bucket, at most ~2x
    the needed bytes - never the whole capacity). Returns
    (pos int64, length int32, cp int32)."""
    k = int(cnt)
    if k <= 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                np.zeros(0, np.int32))
    bm = np.unpackbits(np.asarray(bits), bitorder="little")
    pos = np.flatnonzero(bm).astype(np.int64)
    assert len(pos) == k, (len(pos), k)  # bitmask/count must agree
    fc = min(_bucket(k), packed.shape[0])
    pk = np.asarray(packed[:fc])[:k]
    return pos, (pk & 7).astype(np.int32), (pk >> 3).astype(np.int32)


def compute_lanes(data: np.ndarray, encoding_name: str):
    """Run the device classification kernel for one chunk, padding to a
    power-of-two bucket so each (kind, bucket) compiles once. Returns
    lanes whose arrays are bucket-sized; positions >= len(data) are
    inert. Returns None for encodings without a device kernel."""
    kind = encoding_kind(encoding_name)
    n = len(data)
    cap = _bucket(n)
    padded = np.zeros(cap, dtype=np.uint8)
    padded[:n] = data
    b = jnp.asarray(padded)
    if kind == KIND_UTF8:
        return classify.utf8_lanes(b, n)
    if kind in (KIND_UTF16LE, KIND_UTF16BE):
        return classify.utf16_lanes(b, kind == KIND_UTF16BE, n)
    if kind == KIND_SINGLE_BYTE:
        return classify.single_byte_lanes(b, encoding_name, n)
    return None


def _utf8_encode_cps(cps: np.ndarray):
    """Vectorized UTF-8 encoding of codepoints (1-4 bytes; astral cps
    come from UTF-16 surrogate pairs and gb18030 four-byte forms).
    Returns (payload_u8, co_int64) where co[k] is the payload offset of
    char k (len(cps)+1 entries)."""
    cps = cps.astype(np.int64)
    n1 = cps < 0x80
    n2 = (cps >= 0x80) & (cps < 0x800)
    n3 = (cps >= 0x800) & (cps < 0x10000)
    n4 = cps >= 0x10000
    lens = np.where(n1, 1, np.where(n2, 2, np.where(n3, 3, 4))).astype(np.int64)
    co = np.zeros(len(cps) + 1, np.int64)
    np.cumsum(lens, out=co[1:])
    out = np.empty(int(co[-1]), np.uint8)
    p = co[:-1]
    out[p[n1]] = cps[n1]
    out[p[n2]] = 0xC0 | (cps[n2] >> 6)
    out[p[n2] + 1] = 0x80 | (cps[n2] & 0x3F)
    out[p[n3]] = 0xE0 | (cps[n3] >> 12)
    out[p[n3] + 1] = 0x80 | ((cps[n3] >> 6) & 0x3F)
    out[p[n3] + 2] = 0x80 | (cps[n3] & 0x3F)
    out[p[n4]] = 0xF0 | (cps[n4] >> 18)
    out[p[n4] + 1] = 0x80 | ((cps[n4] >> 12) & 0x3F)
    out[p[n4] + 2] = 0x80 | ((cps[n4] >> 6) & 0x3F)
    out[p[n4] + 3] = 0x80 | (cps[n4] & 0x3F)
    return out, co


def _assemble_feed(cpos, clen, ccp, payload_is_input: bool):
    """Build the run-table feed arrays from the feedable accepted chars
    (ascending positions, byte lengths, codepoints).

    Runs are maximal chains of byte-contiguous chars. Slot layout: run
    r owns slots [co_base[r], co_base[r+1]) = its chars IN ORDER plus
    one SENTINEL slot; ip[slot] is the char's input byte offset
    (sentinel: the run's end), co[slot] its payload offset (sentinel:
    the run's payload end). So char k of run r spans input
    [ip[base+k], ip[base+k+1]) and payload [co[base+k], co[base+k+1]).

    `payload_is_input` (UTF-8): the decoded bytes ARE the input span,
    so co == ip and the payload buffer is the input itself (returned as
    None; the native layer passes the data pointer, enabling SE_INREF
    zero-copy emission)."""
    nch_total = len(cpos)
    if nch_total == 0:
        return None
    cpos = cpos.astype(np.int64)
    clen = clen.astype(np.int64)
    brk = np.empty(nch_total, bool)
    brk[0] = True
    np.not_equal(cpos[1:], cpos[:-1] + clen[:-1], out=brk[1:])
    run_first = np.flatnonzero(brk).astype(np.int64)
    n_runs = len(run_first)
    run_last = np.append(run_first[1:], nch_total) - 1
    rs = cpos[run_first]
    re = cpos[run_last] + clen[run_last]
    nch = run_last - run_first + 1
    co_base = np.zeros(n_runs + 1, np.int64)
    np.cumsum(nch + 1, out=co_base[1:])
    total_slots = int(co_base[-1])
    run_of_slot = np.repeat(np.arange(n_runs, dtype=np.int64), nch + 1)
    off = np.arange(total_slots, dtype=np.int64) - co_base[run_of_slot]
    cidx = run_first[run_of_slot] + off  # char index; run_last+1 at sentinel
    sent = off == nch[run_of_slot]
    ip = cpos[np.minimum(cidx, nch_total - 1)]
    ip[sent] = re[run_of_slot[sent]]
    if payload_is_input:
        return rs, re, co_base, ip, ip, None
    pay, pc = _utf8_encode_cps(ccp)
    co = pc[np.minimum(cidx, nch_total)]
    return rs, re, co_base, co, ip, pay


def _host_filter_tables(mission):
    """(af_tbl bool[128], ubf_tbl bool[64]) from the mission filter."""
    f = mission.filter
    af_tbl = np.array([bool((f.af >> c) & 1) for c in range(128)])
    ubf_tbl = np.array([bool((f.ubf >> b) & 1) for b in range(64)])
    return af_tbl, ubf_tbl


def _utf8_lead_np(cp):
    return np.where(
        cp < 0x80, cp,
        np.where(cp < 0x800, 0xC0 | (cp >> 6),
                 np.where(cp < 0x10000, 0xE0 | (cp >> 12),
                          0xF0 | (cp >> 18))))


def _feed_from_host_events(data: np.ndarray, mission, kind: str,
                           with_extras: bool):
    """jax-free twin builder: the same feed arrays from the host numpy
    event generators (used by the ASan fuzz, where jax-tracing paths
    are disabled; tests pin device == host)."""
    ev = generate_events(data, mission.encoding_name)
    n_ev = len(ev)
    if n_ev == 0:
        return None
    is_char = ev.cp >= 0
    # Multi-codepoint events (the four Big5 double-cp pairs) surface as
    # a primary row plus an in_len==0 extra at the same position; both
    # are excluded (the generic walk handles them exactly).
    extra = ev.in_len == 0
    primary_of_extra = np.zeros(n_ev, bool)
    if extra.any():
        primary_of_extra[:-1] = extra[1:] & (ev.pos[:-1] == ev.pos[1:])
    # Report-clamped chars (an earlier error's pushback inflated their
    # effective report past their own last byte) are excluded: the feed
    # lane derives reports from char contiguity.
    natural = ev.report == ev.pos + ev.in_len - 1
    af_tbl, ubf_tbl = _host_filter_tables(mission)
    cp = np.maximum(ev.cp, 0)
    acc = np.where(ev.cp < 0x80, af_tbl[np.minimum(cp, 127)],
                   ubf_tbl[_utf8_lead_np(cp) & 0x3F])
    feed = is_char & acc & natural & ~extra & ~primary_of_extra
    idx = np.flatnonzero(feed)
    ft = _assemble_feed(ev.pos[idx], ev.in_len[idx], ev.cp[idx],
                        kind == KIND_UTF8)
    if not with_extras:
        return ft
    if ft is None:
        return None
    # Hot-coverage extras: chars excluded from the feed runs but still
    # able to produce findings (multi-cp pairs regardless of filter,
    # and report-clamped accepted chars). For modal ISO-2022-JP also
    # every mode/phase-dependent byte (escape spans + LEAD-mode data):
    # the cold-window skipper requires skipped bytes to be mode- and
    # phase-neutral 1-byte events.
    ex_mask = np.zeros(len(data), bool)
    ex_i = extra | primary_of_extra | (is_char & acc & ~natural)
    np.add.at(ex_mask, ev.pos[ex_i].astype(np.int64), True)
    ex_len_at = np.ones(len(data), np.int64)
    np.maximum.at(ex_len_at, ev.pos[ex_i].astype(np.int64),
                  ev.in_len[ex_i].astype(np.int64))
    if kind == "iso-2022-jp":
        from .classify_iso2022 import iso2022_state_hot_np

        ex_mask |= iso2022_state_hot_np(data)
    ex = np.flatnonzero(ex_mask)
    return ft, (ex.astype(np.int64), ex_len_at[ex])


def runtable_feed(data: np.ndarray, mission, device: bool = True,
                  with_extras: bool = False):
    """EXACT accepted-char run tables + decoded UTF-8 payload for one
    mission - the device run-table feed of KERNELS.md design 1 (the
    on-device analog of the reference's decode loop,
    finding_collection.rs:84-342), on by default under engine=device
    (STRINGSEXT_RUNTABLE_FEED=0 turns it off).

    Covers EVERY kind: UTF-8 / UTF-16LE/BE / single-byte / Big5 /
    EUC-JP / EUC-KR / GBK / gb18030 / Shift_JIS / modal ISO-2022-JP
    (its global mode chain is a device prefix scan,
    ops/classify_iso2022.py). The classification (per-byte events +
    filter acceptance + the CJK/ISO boundary-chain orbit) AND the
    char compaction run on device (_compact_fn: position bitmask +
    one packed (cp,len) scatter, so ~n/8 + 4*chars bytes cross the
    device->host link, not full lanes); the run/slot-table assembly
    is a host numpy pass over the compacted chars. `device=False` builds the
    identical arrays from the host numpy event generators with no jax
    import. Returns (run_start, run_end, co_base, co, ip, payload) for
    native_scan's `runtable_feed` (see _assemble_feed for the slot
    layout; payload None = the input buffer itself, UTF-8), or None
    (unsupported kind / no feedable run).

    `with_extras=True` returns (feed, (extra_pos, extra_len)) instead:
    the events EXCLUDED from the feed runs that can still produce
    findings (multi-codepoint pairs and report-clamped accepted chars).
    A hot map derived from the runs must also cover these spans, or
    the window skipper would drop their findings.
    """
    kind = encoding_kind(mission.encoding_name)
    if kind not in FEED_KINDS:
        return None
    n = len(data)
    if n == 0:
        return None
    if not device:
        return _feed_from_host_events(data, mission, kind, with_extras)

    from ..utils import profiling

    with profiling.scope("device.dispatch", n), \
            profiling.scope("device.feed", n):
        return _runtable_feed_device(data, mission, kind, with_extras)


# The feed classifies the buffer in windows that each own at most
# _FEED_PIECE bytes, so device memory stays bounded at any input size
# (one 768 MiB buffer classified whole ran an 80 GB card out of
# memory). A window holds _FEED_LEFT bytes of left context (zeros
# before the stream start), its owned piece, and lookahead up to
# _FEED_MARGIN bytes in all. Classification of an owned byte needs at
# most 4 bytes of context on either side (parallel/mesh.py's halo
# rule); the decoder state that is not local - the event-chain entry
# offset of the CJK kinds, the ISO-2022-JP mode and redundant-escape
# flag, and the running maximum of event reports - is carried from
# window to window.
_FEED_PIECE = 32 << 20
_FEED_LEFT = 4
_FEED_MARGIN = 512  # left context + lookahead; keeps windows 512-aligned
_NO_REPORT = -(1 << 30)


@functools.partial(jax.jit, static_argnames=("kind", "with_extras"))
def _feed_window(b, n, hi, carry, af_w, ubf_w, table, *, kind,
                 with_extras):
    """Device half of one feed window. `b` holds the window's bytes
    (real length `n`); positions [_FEED_LEFT, hi) are owned. `carry` is
    int32[4]: the event-chain entry offset past _FEED_LEFT, the
    ISO-2022-JP (mode, flag) entry state, and the largest event report
    before the first owned byte (window-relative). `table` is the
    single-byte decode table (unused by the other kinds). Returns the
    owned feedable chars and extras as _compact_fn results, and the
    carry of the next window (whose first owned byte is `hi`)."""
    from .classify_cjk import _orbit_mask, cjk_pre_lanes
    from .classify_iso2022 import iso_pre_lanes, iso_state_transfer
    from .runs import accept_mask

    L = _FEED_LEFT
    entry_d, mode, flag, rep_in = carry[0], carry[1], carry[2], carry[3]
    idx = jnp.arange(b.shape[0], dtype=jnp.int32)
    own = (idx >= L) & (idx < hi)
    step = state_hot = None
    if kind == KIND_UTF8:
        lanes = classify.utf8_lanes(b, n)
    elif kind in (KIND_UTF16LE, KIND_UTF16BE):
        lanes = classify.utf16_lanes(b, kind == KIND_UTF16BE, n)
    elif kind == KIND_SINGLE_BYTE:
        lanes = classify.table_lanes(b, table, n)
    elif kind == "iso-2022-jp":
        lanes, step, state_hot = iso_pre_lanes(b, n, mode, flag, L)
        t = iso_state_transfer(b, n, L, hi)
        mode = jnp.where(t[0] >= 0, t[0], mode)
        flag = jnp.where(t[1] >= 0, t[1], flag)
    else:
        lanes, step = cjk_pre_lanes(b, kind, n)
    multi = None
    if step is not None:
        # The event chain from the carried entry; the next window enters
        # where the last chain step before `hi` lands.
        orbit = _orbit_mask(step, n, L + entry_d)
        lanes = lanes._replace(start=lanes.start & orbit,
                               valid=lanes.valid & orbit,
                               pending=lanes.pending & orbit)
        last = jnp.max(jnp.where(orbit & (idx < hi), idx, -1))
        land = last + jnp.take(step, jnp.maximum(last, 0))
        entry_d = jnp.clip(land - hi, 0, 3)
        if kind != "iso-2022-jp":
            multi = lanes.valid & (lanes.cp < 0) & own  # multi-cp pairs

    acc = accept_mask(lanes, af_w, ubf_w) & own
    # Effective report = running max over event reports (the emitter's
    # clock; events_cjk.generate's maximum.accumulate). A char whose
    # effective report exceeds its own last byte is excluded.
    evt = lanes.start & ~lanes.pending & (idx >= L)
    rep = jnp.where(evt, idx + lanes.report_off, _NO_REPORT)
    rep_max = jnp.maximum(jax.lax.cummax(rep), rep_in)
    feedable = acc & (rep_max == idx + lanes.length - 1)
    rep_out = jnp.max(jnp.where(idx < hi, rep_max, _NO_REPORT))
    rep_out = jnp.maximum(rep_out - (hi - L), _NO_REPORT)
    carry = jnp.stack([entry_d, mode, flag, rep_out]).astype(jnp.int32)

    compact = _compact_fn()
    chars = compact(feedable, lanes.length, lanes.cp)
    if not with_extras:
        return chars, None, carry
    ev_extra = acc & ~feedable
    if multi is not None:
        ev_extra = ev_extra | multi
    ex_mask = ev_extra
    if state_hot is not None:
        ex_mask = ex_mask | (state_hot & own)
    # Event-start extras carry their event length; state-hot-only
    # positions (mode/phase-dependent bytes, not starts) count 1.
    ex_len = jnp.where(ev_extra, jnp.maximum(lanes.length, 1), 1)
    return chars, compact(ex_mask, ex_len, ex_len), carry


def _runtable_feed_device(data, mission, kind, with_extras):
    """The device half of runtable_feed (same contract), window by
    window. Each window is launched before the previous one's compacted
    chars are fetched, so the copy back overlaps the next window."""
    from .runs import filter_words

    n = len(data)
    piece = _FEED_PIECE
    cap = min(_bucket(n + _FEED_MARGIN), piece + _FEED_MARGIN)
    af_w, ubf_w = (jnp.asarray(w) for w in filter_words(mission))
    table = jnp.asarray(full_byte_table(mission.encoding_name)
                        if kind == KIND_SINGLE_BYTE
                        else np.zeros(256, np.int32))
    window = functools.partial(_feed_window, kind=kind,
                               with_extras=with_extras)
    carry = jnp.asarray([0, 0, -1, _NO_REPORT], jnp.int32)
    chars, extras = [], []

    def collect(w0, out):
        pos, ln, cp = _fetch_compact(*out[0])
        chars.append((pos + w0, ln, cp))
        if with_extras:
            ex, ex_len, _ = _fetch_compact(*out[1])
            extras.append((ex + w0, ex_len.astype(np.int64)))

    prev = None
    for c0 in range(0, n, piece):
        w0 = c0 - _FEED_LEFT
        src0, src1 = max(w0, 0), min(n, w0 + cap)
        buf = np.zeros(cap, np.uint8)
        buf[src0 - w0:src1 - w0] = data[src0:src1]
        out = window(jnp.asarray(buf), np.int32(src1 - w0),
                     np.int32(min(c0 + piece, n) - w0), carry, af_w, ubf_w,
                     table)
        carry = out[2]
        if prev is not None:
            collect(*prev)
        prev = (w0, out)
    collect(*prev)

    cpos, clen, ccp = (np.concatenate(p) for p in zip(*chars))
    ft = _assemble_feed(cpos, clen, ccp, kind == KIND_UTF8)
    if not with_extras:
        return ft
    if ft is None:
        return None
    ex, ex_len = (np.concatenate(p) for p in zip(*extras))
    return ft, (ex, ex_len)


def generate_events_device(data: np.ndarray, encoding_name: str) -> Events:
    """Device-accelerated event generation (falls back to host numpy
    for encodings without a device kernel yet)."""
    if len(data) == 0:
        return generate_events(data, encoding_name)
    lanes = compute_lanes(data, encoding_name)
    if lanes is None:
        return generate_events(data, encoding_name)
    return lanes_to_events(lanes)
