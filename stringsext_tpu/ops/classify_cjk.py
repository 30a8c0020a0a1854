"""Device classification lanes for the CJK multi-byte encodings:
Big5, EUC-JP, EUC-KR, GBK/gb18030, Shift_JIS.

jnp port of engine/events_cjk.py (the numpy host generator, itself the
replacement for the encoding_rs CJK state machines -
/root/reference/src/finding_collection.rs:139's decoder dependency):
per-position "as-if-start" classification is pure elementwise algebra
plus pair-table gathers; the true event starts (these encodings are not
self-synchronizing) are the orbit of position 0 under `i -> i + step[i]`,
resolved with O(log n) pointer-doubling rounds on device.

The decoded codepoints come from the same vendored WHATWG index corpus
(encodings/whatwg_data.npz) as the host generators, uploaded once per
kind as 256x256 gather tables. These lanes power the CJK run-table feed
(ops/device_events.runtable_feed): exact accepted-char runs plus the
device-decoded payload, so the host emitter consumes (run, payload)
memcpys instead of re-walking pairs (docs/KERNELS.md design 1).

Correctness notes mirrored from the host generator:
  - WHATWG error pushback: a bad pair with an ASCII trail consumes only
    the lead (pushback=1); gb18030 bad four-byte forms push back 2-3
    lookahead bytes.
  - A truncated (pending) sequence at the chunk end consumes every
    remaining byte, so the orbit cannot emit phantom events from its
    tail.
  - Report clamping (`np.maximum.accumulate` in events_cjk.generate) is
    NOT applied here; the feed builder derives it from the lanes
    (cummax over event reports) and excludes the few chars whose
    effective report a preceding error inflates.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..encodings import (
    KIND_BIG5,
    KIND_EUC_JP,
    KIND_EUC_KR,
    KIND_GB18030,
    KIND_SHIFT_JIS,
)
from .classify import Lanes, _shift_left

CJK_KINDS = (KIND_BIG5, KIND_EUC_JP, KIND_EUC_KR, KIND_GB18030,
             KIND_SHIFT_JIS)


@functools.lru_cache(maxsize=None)
def _pair_cp_np(kind: str) -> np.ndarray:
    """(256,256) int32 pair codepoint table (-1 = invalid). Multi-cp
    pairs (the four Big5 double-codepoint pointers) are left at -1 here
    and tracked by `multi_pair_mask`; the feed path excludes them."""
    from ..encodings import whatwg

    return np.ascontiguousarray(whatwg.pair_cp(kind), dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _multi_pair_np(kind: str) -> np.ndarray:
    """(256,256) bool: pairs that decode to MORE than one codepoint."""
    from ..encodings import whatwg

    m = np.zeros((256, 256), dtype=bool)
    for key in whatwg.pair_multi(kind):
        m[key // 256, key % 256] = True
    return m


@functools.lru_cache(maxsize=None)
def _jis0212_np() -> np.ndarray:
    from ..encodings import whatwg

    return np.ascontiguousarray(whatwg.jis0212_cp(), dtype=np.int32)


def _gather2(table: jax.Array, b: jax.Array, t: jax.Array) -> jax.Array:
    """table[b, t] as a flat 65536-entry gather."""
    return jnp.take(table.reshape(-1), b * 256 + t)


_ORBIT_BLOCK = 512  # blocked-resolve lane width
_ORBIT_DEAD = 4  # transfer state: the chain ended (pending/stream end)
_ORBIT_FAR = 1 << 20  # local "chain gone" sentinel (>> block + max step)


def _orbit_mask_blocked(step: jax.Array, n: jax.Array, start) -> jax.Array:
    """Blocked event-chain resolution - the gather-free rewrite of the
    pointer-doubling orbit (which costs ~24 rounds of full-length
    gathers+scatters). Same mesh algebra applied WITHIN the chunk:

      1. per 512-byte block, a `lax.scan` over the 512 offsets carries
         the chain cursor for every block in parallel - pure
         elementwise work on (nb,) lanes, no gathers;
      2. each block's entry->exit transfer (entry offset 0..3 -> exit
         offset into the next block, or DEAD) is read off the same
         scan run with 4 seeds, plus one extra seed for the start
         block's real entry (which may exceed 3 on the mesh path);
      3. an `associative_scan` over the tiny [nb, 5] transfer tables
         composes the true entry offset of every block, and a second
         512-step scan from those entries emits the orbit mask.

    Mid-chunk steps are 1..4 (max char span), so cross-block entries
    fit {0..3}; claim-rest steps (pending at the true end) leave the
    block with a FAR value and kill the chain (DEAD). Equivalent to
    the doubling version by construction (pinned by
    tests/test_device.py's host-equality suite and a direct
    old-vs-new property test)."""
    cap = step.shape[0]
    B = _ORBIT_BLOCK
    pad = (-cap) % B
    step_p = jnp.concatenate(
        [jnp.maximum(step, 1),
         jnp.ones(pad, jnp.int32)]) if pad else jnp.maximum(step, 1)
    capp = cap + pad
    nb = capp // B
    idx = jnp.arange(capp, dtype=jnp.int32)
    # chains stop at n: stepping to >= n sends the cursor FAR
    nxt_off = (idx % B) + jnp.where(idx + step_p <= n, step_p, _ORBIT_FAR)
    cols = nxt_off.reshape(nb, B).T  # (B, nb): scan rows are offsets
    in_n = (idx < n).reshape(nb, B).T
    start = jnp.asarray(start, jnp.int32)

    # pass 1: transfers for entries {0,1,2,3} + the start block's real
    # entry (seed FAR in every other block so it stays inert there).
    kidx = jnp.arange(nb, dtype=jnp.int32)
    sb = start // B
    seeds = jnp.stack(
        [jnp.full(nb, s, jnp.int32) for s in range(4)]
        + [jnp.where(kidx == sb, start % B, _ORBIT_FAR)]
    )  # (5, nb)

    js = jnp.arange(B, dtype=jnp.int32)

    def t_step(r, xs):
        col, ok, j = xs  # (nb,), (nb,), scalar
        on = (r == j) & ok  # broadcasts over the seed axis
        return jnp.where(on, jnp.minimum(col, _ORBIT_FAR), r), None

    exit_r, _ = jax.lax.scan(t_step, seeds, (cols, in_n, js))
    # exit_r: (5, nb). Values in [B, B+3] exit into the next block;
    # anything else is a dead chain - larger means claim-rest/FAR, and
    # SMALLER means the chain froze at an offset past the real end `n`
    # (it landed exactly at n, whose in_n gate never matches).
    def _exit_state(r):
        return jnp.where((r >= B) & (r < B + 4), r - B,
                         _ORBIT_DEAD).astype(jnp.int32)

    T = _exit_state(exit_r[:4]).T  # (nb, 4)
    T = jnp.concatenate(
        [T, jnp.full((nb, 1), _ORBIT_DEAD, jnp.int32)], axis=1)
    e0 = _exit_state(exit_r[4, sb])

    def compose(a, b):  # (..., 5) tables; a applied first, then b
        return jnp.take_along_axis(b, a, axis=-1)

    # entry of block k > sb = (T[sb+1] o ... o T[k-1])(e0); blocks at
    # or before sb become identity so one prefix scan covers any sb.
    ident = jnp.arange(5, dtype=jnp.int32)
    Tshift = jnp.where(kidx[:, None] > sb, T, ident[None, :])
    pfx = jax.lax.associative_scan(compose, Tshift, axis=0)
    prev = jnp.concatenate([ident[None, :], pfx[:-1]], axis=0)
    entry = jnp.take_along_axis(
        prev, jnp.broadcast_to(e0[None, None], (nb, 1)), axis=-1
    )[:, 0]  # (nb,)
    # dead-state remap FIRST: the start block's literal entry offset
    # may equal the DEAD sentinel (start % B == 4)
    entry = jnp.where(entry == _ORBIT_DEAD, _ORBIT_FAR, entry)
    entry = jnp.where(kidx == sb, start % B, entry)
    entry = jnp.where(kidx < sb, _ORBIT_FAR, entry)

    # pass 2: the orbit mask from each block's true entry.
    def m_step(r, xs):
        col, ok, j = xs
        on = (r == j) & ok
        return jnp.where(on, jnp.minimum(col, _ORBIT_FAR), r), on

    _, marks = jax.lax.scan(m_step, entry, (cols, in_n, js))
    out = marks.T.reshape(capp)  # (nb, B) -> flat
    return out[:cap]


def _orbit_masks_block0(step: jax.Array, n, starts: jax.Array) -> jax.Array:
    """Multi-start blocked chain resolve: bool[S, cap] orbit masks for
    S start offsets that ALL lie in block 0 (start < _ORBIT_BLOCK -
    asserted by construction at the call sites: the mesh enters at
    LEFT_CTX + delta <= 7). ONE pass-1 scan computes the shared
    per-block transfers plus every start's block-0 exit, one prefix
    composition and one pass-2 scan emit all S masks - mesh stage C
    reads its 4 exit-delta probes and the final orbit from two calls
    instead of five independent resolves."""
    cap = step.shape[0]
    B = _ORBIT_BLOCK
    pad = (-cap) % B
    step_p = jnp.concatenate(
        [jnp.maximum(step, 1),
         jnp.ones(pad, jnp.int32)]) if pad else jnp.maximum(step, 1)
    capp = cap + pad
    nb = capp // B
    idx = jnp.arange(capp, dtype=jnp.int32)
    n = jnp.asarray(n, jnp.int32)
    nxt_off = (idx % B) + jnp.where(idx + step_p <= n, step_p, _ORBIT_FAR)
    cols = nxt_off.reshape(nb, B).T
    in_n = (idx < n).reshape(nb, B).T
    starts = jnp.asarray(starts, jnp.int32)  # (S,)
    S = starts.shape[0]
    kidx = jnp.arange(nb, dtype=jnp.int32)
    js = jnp.arange(B, dtype=jnp.int32)

    seeds = jnp.concatenate([
        jnp.stack([jnp.full(nb, s, jnp.int32) for s in range(4)]),
        jnp.where(kidx[None, :] == 0, starts[:, None], _ORBIT_FAR),
    ])  # (4+S, nb)

    def t_step(r, xs):
        col, ok, j = xs
        on = (r == j) & ok
        return jnp.where(on, jnp.minimum(col, _ORBIT_FAR), r), None

    exit_r, _ = jax.lax.scan(t_step, seeds, (cols, in_n, js))

    def _exit_state(r):
        return jnp.where((r >= B) & (r < B + 4), r - B,
                         _ORBIT_DEAD).astype(jnp.int32)

    T = _exit_state(exit_r[:4]).T  # (nb, 4)
    T = jnp.concatenate(
        [T, jnp.full((nb, 1), _ORBIT_DEAD, jnp.int32)], axis=1)
    e0s = _exit_state(exit_r[4:, 0])  # (S,)

    def compose(a, b):
        return jnp.take_along_axis(b, a, axis=-1)

    ident = jnp.arange(5, dtype=jnp.int32)
    Tshift = jnp.where(kidx[:, None] > 0, T, ident[None, :])
    pfx = jax.lax.associative_scan(compose, Tshift, axis=0)
    prev = jnp.concatenate([ident[None, :], pfx[:-1]], axis=0)  # (nb, 5)
    entry = jnp.take(prev, e0s, axis=1).T  # (S, nb)
    entry = jnp.where(entry == _ORBIT_DEAD, _ORBIT_FAR, entry)
    entry = jnp.where(kidx[None, :] == 0, starts[:, None], entry)

    def m_step(r, xs):
        col, ok, j = xs
        on = (r == j) & ok
        return jnp.where(on, jnp.minimum(col, _ORBIT_FAR), r), on

    _, marks = jax.lax.scan(m_step, entry, (cols, in_n, js))
    # marks: (B, S, nb) -> (S, nb, B) -> (S, capp)
    out = jnp.transpose(marks, (1, 2, 0)).reshape(S, capp)
    return out[:, :cap]


def _orbit_mask(step: jax.Array, n: jax.Array, start=0) -> jax.Array:
    """bool[cap]: position is reachable from `start` under
    i -> i+step[i] (i.e. a true event start). Large chunks use the
    blocked scan+transfer resolution (_orbit_mask_blocked, gather-free);
    small ones keep the original pointer doubling: after round k the
    mark set is closed under 2^k applications, so ceil(log2(cap))
    rounds reach the fixpoint; positions >= n funnel into a dump slot.
    `start` may be traced (the mesh path enters each shard at its
    composed cross-shard phase, parallel/mesh.py)."""
    cap = step.shape[0]
    if cap >= 4 * _ORBIT_BLOCK:
        return _orbit_mask_blocked(step, jnp.asarray(n, jnp.int32), start)
    idx = jnp.arange(cap, dtype=jnp.int32)
    nxt = jnp.minimum(idx + jnp.maximum(step, 1), cap)
    # positions at/after the real end self-trap in the dump slot `cap`
    nxt = jnp.where(idx < n, nxt, cap)
    J = jnp.concatenate([nxt, jnp.array([cap], jnp.int32)])
    marked = jnp.zeros(cap + 1, bool).at[start].set(True)

    rounds = max(1, int(np.ceil(np.log2(max(cap, 2)))) + 1)

    def body(_, carry):
        marked, J = carry
        tgt = jnp.where(marked, J, cap)
        marked = marked.at[tgt].set(True)
        return marked, jnp.take(J, J)

    marked, _ = jax.lax.fori_loop(0, rounds, body, (marked, J))
    return marked[:cap] & (idx < n)


class _C:
    """As-if-start classification accumulator (mirrors
    events_cjk._Classified, but with jnp arrays and report as an
    OFFSET from the position)."""

    def __init__(self, cap: int):
        self.step = jnp.ones(cap, jnp.int32)
        self.cp = jnp.full(cap, -1, jnp.int32)
        self.pending = jnp.zeros(cap, bool)
        self.report_off = jnp.zeros(cap, jnp.int32)
        self.pushback = jnp.zeros(cap, jnp.int32)
        self.in_len = jnp.ones(cap, jnp.int32)
        self.multi = jnp.zeros(cap, bool)

    def set(self, mask, *, step=None, cp=None, report_off=None,
            pushback=None, in_len=None):
        if step is not None:
            self.step = jnp.where(mask, step, self.step)
        if cp is not None:
            self.cp = jnp.where(mask, cp, self.cp)
        if report_off is not None:
            self.report_off = jnp.where(mask, report_off, self.report_off)
        if pushback is not None:
            self.pushback = jnp.where(mask, pushback, self.pushback)
        if in_len is not None:
            self.in_len = jnp.where(mask, in_len, self.in_len)


def _classify_two_byte(b, have1, kind: str) -> _C:
    """Big5 / EUC-KR / Shift_JIS (events_cjk._classify_two_byte)."""
    cap = b.shape[0]
    c = _C(cap)
    pair_cp = jnp.asarray(_pair_cp_np(kind))

    if kind == KIND_SHIFT_JIS:
        single = b <= 0x80
        kana = (b >= 0xA1) & (b <= 0xDF)
        lead = ((b >= 0x81) & (b <= 0x9F)) | ((b >= 0xE0) & (b <= 0xFC))
    else:
        single = b < 0x80
        kana = jnp.zeros(cap, bool)
        lead = (b >= 0x81) & (b <= 0xFE)

    c.set(single, cp=b)
    if kind == KIND_SHIFT_JIS:
        c.set(kana, cp=0xFF61 - 0xA1 + b)

    t = _shift_left(b, 1, 0)
    pcp = _gather2(pair_cp, b, t)
    # Multi-codepoint pairs: only Big5 has any (4 double-cp pointers) -
    # a handful of equality tests beats a second 65536-entry gather
    # (arbitrary gathers are the dominant cost of this pass).
    multi_keys = sorted(int(k) for k in np.flatnonzero(
        _multi_pair_np(kind).reshape(-1)))
    if multi_keys:
        key = b * 256 + t
        is_multi = jnp.zeros(cap, bool)
        for mk in multi_keys:
            is_multi = is_multi | (key == mk)
    else:
        is_multi = jnp.zeros(cap, bool)
    pair_ok = lead & have1 & ((pcp >= 0) | is_multi)
    c.set(pair_ok, step=2, in_len=2, report_off=1, cp=pcp)
    c.multi = pair_ok & is_multi

    bad_pair = lead & have1 & ~pair_ok
    trail_ascii = t < 0x80
    c.set(bad_pair & trail_ascii, report_off=1, pushback=1)
    c.set(bad_pair & ~trail_ascii, step=2, in_len=2, report_off=1)

    c.pending = lead & ~have1
    return c


def _classify_eucjp(b, have1, have2, n) -> _C:
    cap = b.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    c = _C(cap)
    pair_cp = jnp.asarray(_pair_cp_np(KIND_EUC_JP))
    t0212 = jnp.asarray(_jis0212_np())
    t1 = _shift_left(b, 1, 0)
    t2 = _shift_left(b, 2, 0)

    ascii_ = b < 0x80
    c.set(ascii_, cp=b)

    is8e = b == 0x8E
    kana_ok = is8e & have1 & (t1 >= 0xA1) & (t1 <= 0xDF)
    c.set(kana_ok, cp=0xFF61 - 0xA1 + t1, step=2, in_len=2, report_off=1)
    bad8e = is8e & have1 & ~((t1 >= 0xA1) & (t1 <= 0xDF))
    c.set(bad8e & (t1 < 0x80), report_off=1, pushback=1)
    c.set(bad8e & ~(t1 < 0x80), step=2, in_len=2, report_off=1)
    pend8e = is8e & ~have1

    lead = (b >= 0xA1) & (b <= 0xFE)
    pcp = _gather2(pair_cp, b, t1)
    pair_ok = lead & have1 & (pcp >= 0)
    c.set(pair_ok, cp=pcp, step=2, in_len=2, report_off=1)
    bad_pair = lead & have1 & ~pair_ok
    c.set(bad_pair & (t1 < 0x80), report_off=1, pushback=1)
    c.set(bad_pair & ~(t1 < 0x80), step=2, in_len=2, report_off=1)
    pend_lead = lead & ~have1

    is8f = b == 0x8F
    second_ok = is8f & have1 & (t1 >= 0xA1) & (t1 <= 0xFE)
    tcp = _gather2(t0212, t1, t2)
    tri_ok = second_ok & have2 & (tcp >= 0)
    c.set(tri_ok, cp=tcp, step=3, in_len=3, report_off=2)
    bad3 = second_ok & have2 & ~(tcp >= 0)
    c.set(bad3 & (t2 < 0x80), step=2, in_len=2, report_off=2, pushback=1)
    c.set(bad3 & ~(t2 < 0x80), step=3, in_len=3, report_off=2)
    bad2 = is8f & have1 & ~((t1 >= 0xA1) & (t1 <= 0xFE))
    c.set(bad2 & (t1 < 0x80), report_off=1, pushback=1)
    c.set(bad2 & ~(t1 < 0x80), step=2, in_len=2, report_off=1)
    pend8f = (is8f & ~have1) | (second_ok & ~have2)

    c.pending = pend8e | pend_lead | pend8f
    c.step = jnp.where(c.pending, jnp.maximum(n - idx, 1), c.step)
    return c


def _classify_gb18030(b, have1, have2, have3, n) -> _C:
    cap = b.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    c = _C(cap)
    from ..encodings import whatwg

    pair_cp = jnp.asarray(_pair_cp_np(KIND_GB18030))
    rp_np, rc_np = whatwg.gb18030_ranges()
    rp_np = np.asarray(rp_np, np.int64)
    rc_np = np.asarray(rc_np, np.int64)
    t1 = _shift_left(b, 1, 0)
    t2 = _shift_left(b, 2, 0)
    t3 = _shift_left(b, 3, 0)

    ascii_ = b < 0x80
    c.set(ascii_, cp=b)
    # WHATWG gb18030 decoder step 7 (the GBK euro quirk): 0x80 is a
    # valid 1-byte U+20AC, not an error.
    c.set(b == 0x80, cp=0x20AC)

    lead = (b >= 0x81) & (b <= 0xFE)
    digit1 = (t1 >= 0x30) & (t1 <= 0x39)
    two_range = (t1 >= 0x40) & (t1 <= 0xFE) & (t1 != 0x7F)

    pcp = _gather2(pair_cp, b, t1)
    pair_ok = lead & have1 & two_range & (pcp >= 0)
    c.set(pair_ok, cp=pcp, step=2, in_len=2, report_off=1)
    bad_pair = lead & have1 & two_range & ~(pcp >= 0)
    c.set(bad_pair & (t1 < 0x80), report_off=1, pushback=1)
    c.set(bad_pair & ~(t1 < 0x80), step=2, in_len=2, report_off=1)

    bad2 = lead & have1 & ~digit1 & ~two_range
    c.set(bad2 & (t1 < 0x80), report_off=1, pushback=1)
    c.set(bad2 & ~(t1 < 0x80), step=2, in_len=2, report_off=1)

    four_start = lead & have1 & digit1
    third_ok = (t2 >= 0x81) & (t2 <= 0xFE)
    fourth_ok = (t3 >= 0x30) & (t3 <= 0x39)
    f_all = four_start & have3 & third_ok & fourth_ok
    p = ((b - 0x81) * 12600 + (t1 - 0x30) * 1260 + (t2 - 0x81) * 10
         + (t3 - 0x30))
    p_ok = (p <= 39419) | ((p >= 189000) & (p <= 1237575))
    quad_ok = f_all & p_ok
    # Ranges mapping as a TELESCOPING compare-sum instead of
    # searchsorted + two table takes (log-rounds of 16M-element
    # gathers; ~200 elementwise compare-mul-adds are cheap): with
    # d[j] = rc[j] - rp[j], the mapped codepoint is
    # cp = p + d[k] = p + d[0] + sum_{j>=1} [rp[j] <= p] * (d[j]-d[j-1])
    # (rp is sorted, so the indicator telescopes to d[k]).
    d_np = rc_np - rp_np
    dsum = jnp.zeros(cap, jnp.int32)
    for j in range(1, len(rp_np)):
        dd = int(d_np[j] - d_np[j - 1])
        if dd:
            dsum = dsum + jnp.where(p >= int(rp_np[j]),
                                    jnp.int32(dd), jnp.int32(0))
    qcp = p + jnp.int32(int(d_np[0])) + dsum
    c.set(quad_ok, cp=qcp, step=4, in_len=4, report_off=3)
    c.set(f_all & ~p_ok, step=4, in_len=4, report_off=3)
    third_bad = four_start & have2 & ~third_ok
    c.set(third_bad, report_off=2, pushback=2)
    fourth_bad = four_start & have3 & third_ok & ~fourth_ok
    c.set(fourth_bad, report_off=3, pushback=3)

    c.pending = ((lead & ~have1) | (four_start & ~have2)
                 | (four_start & have2 & third_ok & ~have3))
    c.step = jnp.where(c.pending, jnp.maximum(n - idx, 1), c.step)
    return c



def _cjk_classified(b: jax.Array, kind: str, n) -> _C:
    """Shared as-if-start classification (orbit-free)."""
    b = b.astype(jnp.int32)
    cap = b.shape[0]
    if n is None:
        n = cap
    n = jnp.asarray(n, jnp.int32)
    idx = jnp.arange(cap, dtype=jnp.int32)
    have1 = idx < n - 1
    have2 = idx < n - 2
    have3 = idx < n - 3

    if kind == KIND_EUC_JP:
        return _classify_eucjp(b, have1, have2, n)
    if kind == KIND_GB18030:
        return _classify_gb18030(b, have1, have2, have3, n)
    return _classify_two_byte(b, have1, kind)


def cjk_pre_lanes(b: jax.Array, kind: str, n):
    """Orbit-FREE per-byte lanes + the step array, for callers that
    resolve the event chain themselves (the sharded mesh scan composes
    entry phases across shards and runs _orbit_mask from the composed
    entry). `lanes & orbit` (start/valid/pending each AND-ed with the
    orbit mask) reproduces cjk_lanes exactly."""
    c = _cjk_classified(b, kind, n)
    pre_start = ~c.pending
    lanes = Lanes(
        start=pre_start,
        valid=pre_start & ((c.cp >= 0) | c.multi),
        length=c.in_len,
        cp=jnp.where(c.multi, -1, c.cp),
        report_off=c.report_off,
        pushback=c.pushback,
        pending=c.pending,
    )
    return lanes, c.step


@functools.partial(jax.jit, static_argnames=("kind",))
def cjk_lanes(b: jax.Array, kind: str, n: jax.Array | None = None):
    """Per-byte event lanes for a CJK chunk (padded to `b.shape[0]`;
    `n` is the real length). Returns (Lanes, multi) where `multi` marks
    events that decode to more than one codepoint (their cp lane is -1;
    the feed path excludes them and the exact host walk handles them).

    Unlike the UTF-8/UTF-16 lanes, `start` here is the resolved event
    chain (orbit of 0), so consumers must NOT treat non-start positions
    as meaningful."""
    b = b.astype(jnp.int32)
    cap = b.shape[0]
    if n is None:
        n = cap
    n = jnp.asarray(n, jnp.int32)
    c = _cjk_classified(b, kind, n)

    start = _orbit_mask(c.step, n)
    valid = start & ~c.pending & ((c.cp >= 0) | c.multi)
    lanes = Lanes(
        start=start & ~c.pending,
        valid=valid,
        length=c.in_len,
        cp=jnp.where(c.multi, -1, c.cp),
        report_off=c.report_off,
        pushback=c.pushback,
        pending=c.pending & start,
    )
    return lanes, c.multi & start
