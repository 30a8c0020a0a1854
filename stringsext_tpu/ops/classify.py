"""Per-byte classification lanes on device (jnp, jittable).

Device-side mirror of the vectorized decoders in engine/events.py: for
each byte of a chunk compute whether an event (char / malformed
sequence) starts there, its length, decoded codepoint, report offset
and pushback. The lanes are bit-exact with the numpy generators (tested
in tests/test_device.py) and are what the finding-extraction kernels
(ops/runs.py) and the exact event path (ops/device_events.py) consume.

Shapes are static (callers pad chunks to bucket sizes; `n` is the
traced real length) so each kernel compiles once per bucket. Layout:
one lane element per input byte, 1-D. All ops are elementwise / small-shift / cummax - no gathers in
the UTF-8 path (cf. the shift-based DFA of Keiser/Lemire, PAPERS.md,
which this generalizes).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..encodings import full_byte_table


class Lanes(NamedTuple):
    """Per-byte event lanes (device arrays; NamedTuple = jax pytree).

    Positions >= the real length have start=False and contribute
    nothing downstream.
    """

    start: jax.Array  # bool: an event starts here
    valid: jax.Array  # bool: ... and it is a char
    length: jax.Array  # int32: event input length (1..4)
    cp: jax.Array  # int32: codepoint (valid chars; else -1)
    report_off: jax.Array  # int32: report = pos + report_off
    pushback: jax.Array  # int32
    pending: jax.Array  # bool: truncated at chunk end (no event)


def _shift_left(x, k, fill):
    """x[i+k] with `fill` beyond the end (lookahead)."""
    return jnp.concatenate([x[k:], jnp.full((k,), fill, x.dtype)])[: x.shape[0]]


@jax.jit
def utf8_lanes(b: jax.Array, n: jax.Array | None = None) -> Lanes:
    """UTF-8 validity DFA over a (padded) byte chunk; `n` is the real
    length (mirror of engine/events.py:_utf8_events)."""
    b = b.astype(jnp.int32)
    cap = b.shape[0]
    if n is None:
        n = cap
    n = jnp.asarray(n, jnp.int32)
    b1 = _shift_left(b, 1, 0)
    b2 = _shift_left(b, 2, 0)
    b3 = _shift_left(b, 3, 0)
    idx = jnp.arange(cap, dtype=jnp.int32)
    in_n = idx < n
    have1 = idx < n - 1
    have2 = idx < n - 2
    have3 = idx < n - 3

    cont = (b >> 6) == 0b10
    c1 = ((b1 >> 6) == 0b10) & have1
    c2 = ((b2 >> 6) == 0b10) & have2
    c3 = ((b3 >> 6) == 0b10) & have3

    lead1 = b < 0x80
    lead2 = (b >= 0xC2) & (b <= 0xDF)
    lead3 = (b >= 0xE0) & (b <= 0xEF)
    lead4 = (b >= 0xF0) & (b <= 0xF4)

    c1ok3 = c1 & jnp.where(b == 0xE0, b1 >= 0xA0, jnp.where(b == 0xED, b1 <= 0x9F, True))
    c1ok4 = c1 & jnp.where(b == 0xF0, b1 >= 0x90, jnp.where(b == 0xF4, b1 <= 0x8F, True))

    valid2 = lead2 & c1
    valid3 = lead3 & c1ok3 & c2
    valid4 = lead4 & c1ok4 & c2 & c3
    ev_valid = lead1 | valid2 | valid3 | valid4

    ev_len = jnp.where(valid2, 2, 1)
    ev_len = jnp.where(valid3, 3, ev_len)
    ev_len = jnp.where(valid4, 4, ev_len)

    bad_len = jnp.where(lead3 & c1ok3 & ~c2, 2, 1)
    bad_len = jnp.where(lead4 & c1ok4 & ~c2, 2, bad_len)
    bad_len = jnp.where(lead4 & c1ok4 & c2 & ~c3, 3, bad_len)

    trunc = (lead2 & ~c1) | (lead3 & ~(c1ok3 & c2)) | (lead4 & ~(c1ok4 & c2 & c3))
    report_off = jnp.where(ev_valid, ev_len - 1, 0)
    report_off = jnp.where(~ev_valid & trunc, bad_len, report_off)

    pend2 = lead2 & ~have1
    pend3 = lead3 & (~have1 | (c1ok3 & ~have2))
    pend4 = lead4 & (~have1 | (c1ok4 & c1 & ~have2) | (c1ok4 & c2 & ~have3))
    pending = (pend2 | pend3 | pend4) & ~ev_valid & in_n

    ev_len = jnp.where(ev_valid, ev_len, bad_len)

    # True starts: non-cont bytes always; a cont byte iff no event
    # starting 1..3 bytes back claims it. Claiming events only start at
    # non-cont bytes, so this is purely local - shifts, no gather (a
    # gather here gets duplicated per consumer by XLA fusion and
    # dominated the profile).
    claim_len = jnp.where(pending, 4, ev_len)
    claimed = jnp.zeros_like(cont)
    for k in (1, 2, 3):
        nck = jnp.concatenate([jnp.zeros(k, bool), (~cont)[: cap - k]])
        clk = jnp.concatenate([jnp.zeros(k, claim_len.dtype), claim_len[: cap - k]])
        claimed = claimed | (nck & (clk > k))
    is_start = ((~cont) | ~claimed) & in_n

    cp = jnp.where(
        ev_len == 1,
        b,
        jnp.where(
            ev_len == 2,
            ((b & 0x1F) << 6) | (b1 & 0x3F),
            jnp.where(
                ev_len == 3,
                ((b & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F),
                ((b & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6) | (b3 & 0x3F),
            ),
        ),
    )
    cp = jnp.where(ev_valid, cp, -1)

    return Lanes(
        start=is_start,
        valid=ev_valid & is_start,
        length=ev_len,
        cp=cp,
        report_off=report_off,
        pushback=jnp.zeros_like(b),
        pending=pending,
    )


@functools.partial(jax.jit, static_argnames=("big_endian",))
def utf16_lanes(b: jax.Array, big_endian: bool, n: jax.Array | None = None) -> Lanes:
    """UTF-16 LE/BE lanes (unit logic expanded to byte positions;
    mirror of engine/events.py:_utf16_events). The odd trailing byte
    (if any) is pending. `b` may be padded; `n` is the real length and
    the pad must keep `b.shape[0]` even."""
    cap = b.shape[0]
    assert cap % 2 == 0, "pad UTF-16 chunks to an even capacity"
    if n is None:
        n = cap
    n = jnp.asarray(n, jnp.int32)
    nu_cap = cap // 2
    nu = n // 2  # complete units
    # 1-D strided slices, NOT a (nu, 2) reshape with a minor dim of 2.
    bi = b.astype(jnp.int32)
    b_even = jax.lax.slice(bi, (0,), (cap,), (2,))
    b_odd = jax.lax.slice(bi, (1,), (cap,), (2,))
    units = (b_even << 8) | b_odd if big_endian else (b_odd << 8) | b_even

    uidx = jnp.arange(nu_cap, dtype=jnp.int32)
    u_in = uidx < nu
    high = (units >= 0xD800) & (units <= 0xDBFF)
    low = (units >= 0xDC00) & (units <= 0xDFFF)
    low_next = _shift_left(low, 1, False)
    have_next = uidx < nu - 1
    nxt = _shift_left(units, 1, 0)

    pair_start = high & low_next & have_next
    pair_trail = jnp.concatenate([jnp.array([False]), pair_start[:-1]])
    lone_high = high & ~(low_next & have_next) & have_next
    pend_high = high & ~(low_next & have_next) & ~have_next
    lone_low = low & ~pair_trail
    bmp = ~high & ~low

    u_start = (bmp | pair_start | lone_high | lone_low) & u_in
    u_valid = (bmp | pair_start) & u_in
    u_len = jnp.where(pair_start, 4, 2)
    astral = 0x10000 + ((units & 0x3FF) << 10) + (nxt & 0x3FF)
    u_cp = jnp.where(pair_start, astral, units)
    u_cp = jnp.where(u_valid, u_cp, -1)
    u_report = jnp.where(pair_start | lone_high, 3, 1)
    u_pushback = jnp.where(lone_high, 2, 0)
    u_pending = pend_high & u_in

    idxb = jnp.arange(cap, dtype=jnp.int32)
    even_byte = (idxb & 1) == 0

    def expand(x, fill):
        """unit lanes -> byte lanes (value at unit's first byte).
        jnp.repeat keeps everything 1-D (no lane-padded minor dim)."""
        rep = jnp.repeat(x, 2, total_repeat_length=cap)
        fill_arr = jnp.full((cap,), fill, rep.dtype)
        return jnp.where(even_byte, rep, fill_arr)
    odd_last = (n % 2 == 1) & (idxb == n - 1)  # trailing half unit
    start = expand(u_start, False) | odd_last
    pending = expand(u_pending, False) | odd_last

    return Lanes(
        start=start,
        valid=expand(u_valid, False),
        length=expand(u_len, 1),
        cp=expand(u_cp, -1),
        report_off=expand(u_report, 0),
        pushback=expand(u_pushback, 0),
        pending=pending,
    )


@functools.partial(jax.jit, static_argnames=("encoding_name",))
def single_byte_lanes(b: jax.Array, encoding_name: str, n: jax.Array | None = None) -> Lanes:
    """Single-byte encodings: a 256-entry table gather."""
    return table_lanes(b, jnp.asarray(full_byte_table(encoding_name)), n)


def table_lanes(b: jax.Array, table: jax.Array,
                n: jax.Array | None = None) -> Lanes:
    """single_byte_lanes with the decode table (int32[256], -1 for
    undefined bytes) as an argument, so one compiled program serves
    every single-byte encoding."""
    cap = b.shape[0]
    if n is None:
        n = cap
    n = jnp.asarray(n, jnp.int32)
    cp = jnp.take(table, b.astype(jnp.int32))
    idx = jnp.arange(cap, dtype=jnp.int32)
    in_n = idx < n
    ones = jnp.ones(cap, jnp.int32)
    zeros = jnp.zeros(cap, jnp.int32)
    return Lanes(
        start=in_n,
        valid=(cp >= 0) & in_n,
        length=ones,
        cp=cp,
        report_off=zeros,
        pushback=zeros,
        pending=jnp.zeros(cap, bool),
    )
