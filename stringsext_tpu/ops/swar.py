"""SWAR mission scan: 4 stream bytes per int32 word, plain jnp/lax.

The packed words are the input's natural memory layout. Everything is
computed with SIMD-within-register bit tricks, 4 bytes (UTF-8) / 2
code units (UTF-16) per word op:

- per-byte range tests run in two 16-bit channels with a carry-guard
  bias (~6 ops per channel for all 4 bytes at once);
- all boolean structure (continuation chains, maximal-subpart lengths,
  claim/start logic) is mask algebra on 0x01-per-byte words;
- AF/UBF filters are decomposed on the host into byte/codepoint
  intervals (ops/specs.py; the standard filters are 1-3 intervals,
  filters that decompose into too many go to the jnp lanes instead).

The whole pass is integer elementwise work followed by one sum per
512-byte block. XLA fuses it on every backend: a neighbour word is an
offset read of the same flat array, so no kernel language is needed.

Field word formats (one int32 word per 4 input bytes):
  UTF-8  word: 4 x 8-bit per-byte fields (bit layout below)
  UTF-16 word: unit fields at bits 0-7 (unit 0 = bytes 0-1) and 16-23

Per-byte field bits: accept (0), event length (1-3, at event starts),
grep match (4), event start (5), valid char (6).

Stream order is little-endian: byte 4*i+j is bits 8j..8j+7 of flat
word i. Stream edges behave as if surrounded by zero bytes, so
zero-padded and unpadded inputs give identical results.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

LANE = 128  # words per 512-byte block: one row of a (rows, 128) panel

ACCEPT_BIT = 1
LEN_SHIFT = 1
GREP_BIT = 1 << 4
START_BIT = 1 << 5
VALID_BIT = 1 << 6

# Word rows of context each mesh shard takes from each neighbour
# (parallel/mesh.build_sharded_counts). The counts need two words of
# context each side, so one 512-byte row suffices.
HALO_ROWS = 1

L16 = 0x00010001  # per-16-bit-slot one
G16 = 0x01000100  # per-slot carry guard (bit 8 of each slot)
M01 = 0x01010101  # 0x01 per byte
MFF_EVEN = 0x00FF00FF


def _lsr(x, k):
    """Logical shift right on int32 (mask off arithmetic sign fill)."""
    return (x >> k) & ((1 << (32 - k)) - 1) if k else x


def _range_mask(w, lo, hi):
    """0x01-per-byte mask: byte in [lo, hi] (constants 0..255).

    16-bit-channel trick: bias each slot with guard bit 8 so the
    subtraction cannot borrow across slots; the guard bit then holds
    the per-slot comparison result.
    """
    xe = w & MFF_EVEN
    xo = _lsr(w, 8) & MFF_EVEN

    def ge(x, c):  # slot value >= c
        return ((x | G16) - c * L16) & G16

    def le(x, c):  # slot value <= c
        return ((c * L16 | G16) - x) & G16

    if lo <= 0 and hi >= 255:
        return jnp.full_like(w, M01)
    if lo == hi:  # equality: XOR + guard-subtract zero test (3 ops)
        me = (G16 - (xe ^ (lo * L16))) & G16
        mo = (G16 - (xo ^ (lo * L16))) & G16
    elif hi >= 255:  # bytes are <= 255: the le test is a no-op
        me, mo = ge(xe, lo), ge(xo, lo)
    elif lo <= 0:
        me, mo = le(xe, hi), le(xo, hi)
    else:
        me = ge(xe, lo) & le(xe, hi)
        mo = ge(xo, lo) & le(xo, hi)
    return (_lsr(me, 8) | mo) & M01


def _eq_mask(w, c):
    return _range_mask(w, c, c)


class _Panel:
    """Byte-shift helpers over (K, m) word slabs whose ROWS are
    independent windows of the stream, with zero bytes outside each
    row. A whole stream is one (1, n_words) row; the stage-3 slab
    re-derivation in ops/runs.py (extract_runs_swar_blocks) passes K
    gathered windows, whose derived mission fields are only valid at
    columns [1, m-1) and run-boundary flags at [2, m-2)."""

    def __init__(self, W):
        self.W = W
        self.Wn = self.fwd_elem(W)

    def fwd(self, kb):
        """Panel shifted forward (lookahead) by kb bytes (1..3)."""
        return _lsr(self.W, 8 * kb) | (self.Wn << (32 - 8 * kb))

    def back_elem(self, x):
        """Array shifted back (lookback) by one WORD (4 bytes)."""
        return jnp.concatenate([jnp.zeros_like(x[:, :1]), x[:, :-1]], axis=1)

    def fwd_elem(self, x):
        """Array shifted forward (lookahead) by one WORD (4 bytes)."""
        return jnp.concatenate([x[:, 1:], jnp.zeros_like(x[:, :1])], axis=1)


def _utf8_structure(P, extra_back_pack=None):
    """Filter-INDEPENDENT per-byte UTF-8 structure of the panel:
    byte-bit masks, lead/continuation classes, validity, claim logic
    and char starts. Shared by every UTF-8 mission in a spec set (the
    filters only differ in the cheap `passes` mask on top).

    `extra_back_pack` (optional word) lets callers batch additional
    back-shifted bits onto the claim lookback's word shift: its bits
    ride the same P.back_elem and come back as `extra_back`. Only WORD
    bits 3-7 are safe (the claim pack uses per-byte bits 0-2, i.e.
    word bits 0-2/8-10/16-18/24-26, and the claimed-mask shifts below
    never move bits 3-7 onto a bit kept by the final & M01)."""
    W = P.W
    b1 = P.fwd(1)
    b2 = P.fwd(2)
    b3 = P.fwd(3)

    def bit(x, k):  # bit k of each byte as a 0x01 mask
        return (x >> k) & M01

    def contm(x):  # byte is 0b10xxxxxx: bit7 & ~bit6 in one masked
        # expression (bit6 reaches bit7 via x<<1 without leaving its
        # byte; arithmetic >>7 sign fill stays above M01's bit 24)
        return ((x & ~(x << 1)) >> 7) & M01

    cont = contm(W)
    cont1 = contm(b1)
    cont2 = contm(b2)
    cont3 = contm(b3)

    t7, t6, t5, t4 = bit(W, 7), bit(W, 6), bit(W, 5), bit(W, 4)
    k0, k1, k2, k3 = bit(W, 0), bit(W, 1), bit(W, 2), bit(W, 3)

    lead1 = ~t7 & M01
    # 0xC2-0xDF: top bits 110, low 5 bits >= 2
    lead2 = t7 & t6 & ~t5 & (k1 | k2 | k3 | t4) & M01
    top3 = t7 & t6 & t5
    lead3 = top3 & ~t4 & M01  # 0xE0-0xEF: top nibble 1110
    top4 = top3 & t4
    # 0xF0-0xF4: top nibble 1111, low nibble <= 4 - i.e. NOT k3 and
    # NOT (k2 with any of k1/k0); one OR of violations
    lead4 = top4 & ((k3 | (k2 & (k1 | k0))) ^ M01)

    low4_zero = ~(k0 | k1 | k2 | k3) & M01
    e0 = lead3 & low4_zero
    ed = lead3 & k0 & ~k1 & k2 & k3 & M01  # low nibble 1101
    f0 = top4 & low4_zero
    f4 = top4 & ~k0 & ~k1 & k2 & ~k3 & M01  # low nibble 0100

    # Second-byte ranges, all within continuation space (0b10xxxxxx),
    # reduce to bits 5/4 of the following byte. Inside the cont1 gate
    # the two special-lead exclusions are one OR of violations:
    # E0 needs b1 >= 0xA0 (n5), ED needs b1 <= 0x9F (~n5); F0 needs
    # b1 >= 0x90 (n45), F4 needs b1 <= 0x8F (~n45).
    n5 = bit(b1, 5)
    n45 = (n5 | bit(b1, 4)) & M01

    c1ok3 = cont1 & (((e0 & (n5 ^ M01)) | (ed & n5)) ^ M01)
    c1ok4 = cont1 & (((f0 & (n45 ^ M01)) | (f4 & n45)) ^ M01)

    valid2 = lead2 & cont1
    valid3 = lead3 & c1ok3 & cont2
    valid4 = lead4 & c1ok4 & cont2 & cont3
    ev_valid = lead1 | valid2 | valid3 | valid4

    nc2 = cont2 ^ M01  # ~cont2 as 0x01 mask
    nc3 = cont3 ^ M01
    bad2 = (lead3 & c1ok3 & nc2) | (lead4 & c1ok4 & nc2)
    bad3 = lead4 & c1ok4 & cont2 & nc3

    ge2 = valid2 | valid3 | valid4 | bad2 | bad3  # claim length >= 2
    ge3 = valid3 | valid4 | bad3
    ge4 = valid4

    noncont = cont ^ M01
    # The three claim lookbacks (1-3 bytes) ride ONE word shift:
    # pack the claim masks into bits 0-2 per byte, shift the packed
    # word back once, then extract each lookback distance's bit.
    C = (noncont & ge2) | ((noncont & ge3) << 1) | ((noncont & ge4) << 2)
    if extra_back_pack is not None:
        C = C | extra_back_pack
    Cp = P.back_elem(C)
    claimed = (
        ((C << 8) | _lsr(Cp, 24))
        | _lsr((C << 16) | _lsr(Cp, 16), 1)
        | _lsr((C << 24) | _lsr(Cp, 8), 2)
    ) & M01
    # noncont | (cont & ~claimed) == ~(cont & claimed) on 0x01 masks
    is_start = (cont & claimed) ^ M01

    return dict(
        is_start=is_start,
        ev_valid=ev_valid,
        valid2=valid2,
        valid3=valid3,
        valid4=valid4,
        bad2=bad2,
        bad3=bad3,
        lead2=lead2,
        lead3=lead3,
        lead4=lead4,
        t7=t7, t6=t6, t5=t5, t4=t4, k0=k0, k1=k1, k2=k2, k3=k3,
        extra_back=Cp,
    )


# UBF intervals that coincide with the structural lead-class masks:
# substituting the already-computed masks skips a ~12-op range test.
_LEAD_CLASS_IV = {
    (0xC2, 0xDF): ("lead2",),
    (0xE0, 0xEF): ("lead3",),
    (0xF0, 0xF4): ("lead4",),
    (0xC2, 0xEF): ("lead2", "lead3"),
    (0xE0, 0xF4): ("lead3", "lead4"),
    (0xC2, 0xF4): ("lead2", "lead3", "lead4"),
}


def _utf8_masks(P, af_iv, ubf_iv, grep_char: int, struct=None):
    """All per-byte UTF-8 mission masks (0x01-per-byte words) for the
    panel: accept/grep/is_start/ev_valid plus the length-class masks.

    The UTF-8 byte classes are bit PATTERNS, not arbitrary ranges, so
    they are computed with per-byte-bit algebra (2-6 ops each) instead
    of the 16-bit-channel range test (~12 ops): continuation = top bits
    10, 3-byte lead = top nibble 1110, and the second-byte special
    ranges (0xA0-0xBF etc.) reduce to single bit tests once gated on
    continuation. Caller filter intervals reuse the structural masks
    when they coincide with a lead class or the full printable-ASCII
    range; only the remaining intervals and the grep byte use the
    generic range test.

    `struct` (optional) supplies a precomputed `_utf8_structure(P)` so
    several UTF-8 missions in one pass share the structural work."""
    W = P.W
    m = _utf8_structure(P) if struct is None else struct

    passes = jnp.zeros_like(W)
    for lo, hi in af_iv:
        if (lo, hi) == (0x20, 0x7E):
            # printable ASCII from the structural byte bits:
            # [0x20,0x7F] = ~t7 & (t6|t5), minus 0x7F (all low bits set)
            passes = passes | (
                (m["t7"] ^ M01) & (m["t6"] | m["t5"])
                & ((m["t6"] & m["t5"] & m["t4"] & m["k3"] & m["k2"]
                    & m["k1"] & m["k0"]) ^ M01)
            )
        else:
            passes = passes | _range_mask(W, lo, hi)
    for lo, hi in ubf_iv:
        names = _LEAD_CLASS_IV.get((lo, hi))
        if names is not None:
            for nm in names:
                passes = passes | m[nm]
        else:
            passes = passes | _range_mask(W, lo, hi)

    accept = m["is_start"] & m["ev_valid"] & passes
    grep = accept & _eq_mask(W, grep_char) if grep_char >= 0 else jnp.zeros_like(W)

    return dict(
        accept=accept,
        grep=grep,
        is_start=m["is_start"],
        ev_valid=m["ev_valid"],
        valid2=m["valid2"],
        valid3=m["valid3"],
        valid4=m["valid4"],
        bad2=m["bad2"],
        bad3=m["bad3"],
    )


def swar_utf8_panel(P: _Panel, af_iv, ubf_iv, grep_char: int):
    """Packed 4x8-bit UTF-8 mission fields for the panel."""
    m = _utf8_masks(P, af_iv, ubf_iv, grep_char)
    accept, grep, is_start = m["accept"], m["grep"], m["is_start"]
    # per-byte 3-bit length: 1 + v2 + 2*v3 + 3*v4 + bad2 + 2*bad3
    # (exactly one of v2/v3/v4/bad2/bad3 per byte; max value 4, no
    # cross-byte carries). Zeroed at non-starts via a 0x07-per-start
    # mask (0x01-mask * 7 cannot carry).
    ln = (
        M01 + m["valid2"] + (m["valid3"] << 1) + m["valid4"]
        + (m["valid4"] << 1) + m["bad2"] + (m["bad3"] << 1)
    )
    len_bits = (ln << LEN_SHIFT) & ((is_start * 0x07) << LEN_SHIFT)

    packed = (
        accept * ACCEPT_BIT
        | len_bits
        | (grep << 4)
        | (is_start << 5)
        | ((is_start & m["ev_valid"]) << 6)
    )
    return packed


def _utf8_len_masks(m):
    """is_start-gated length-class masks s1..s4 from _utf8_masks output
    (sL == "byte starts a char whose decoded field length is L", the
    exact per-byte values of the packed lf field)."""
    s2 = m["valid2"] | m["bad2"]
    s3 = m["valid3"] | m["bad3"]
    s4 = m["valid4"]
    s1 = (s2 | s3 | s4) ^ M01  # everything else decodes as length 1
    st = m["is_start"]
    return st & s1, st & s2, st & s3, st & s4


def _byteswap16(x):
    """Swap the two bytes of each 16-bit half of every int32 word."""
    return ((x & MFF_EVEN) << 8) | (_lsr(x, 8) & MFF_EVEN)


def _utf16_units(P, be: bool):
    """(u0, u1, u2): the panel's code units - u0 = bytes 0-1 of each
    word, u1 = bytes 2-3, u2 = bytes 0-1 of the next word."""
    W, Wn = P.W, P.Wn
    if be:
        W = _byteswap16(W)
        Wn = _byteswap16(Wn)
    return W & 0xFFFF, _lsr(W, 16), Wn & 0xFFFF


def _utf16_slot_masks(u, un, pair, h, l, l_next, trail, cp_iv, grep_char):
    """Boolean mission masks for one unit slot: accept/start/valid/grep
    (mission.rs:307-348 filter semantics on the decoded codepoint)."""
    bmp = ~h & ~l
    if any(hi >= 0x10000 or (lo <= 0xDFFF and hi >= 0xD800)
           for lo, hi in cp_iv):
        # Astral planes reachable, OR an interval covers the surrogate
        # range (utf16_cp_intervals maps UBF lead 0xED to cps
        # 0xD000-0xDFFF): a pair slot's raw u is its high surrogate, so
        # testing u there would wrongly accept pairs - compute the real
        # decoded cp.
        astral = 0x10000 + ((u & 0x3FF) << 10) + (un & 0x3FF)
        cp = jnp.where(pair, astral, u)
    else:
        # No filter interval reaches the astral planes or touches the
        # surrogate range, so pairs can never pass; testing the raw
        # unit is exact (a pair slot's u is its high surrogate
        # 0xD800-0xDBFF, outside every interval, and grep chars are
        # < 0x80). Saves the astral cp math.
        cp = u
    valid = (bmp | pair) & ~trail
    # (bmp | pair | lone_high | lone_low) & ~trail collapses to ~trail:
    # bmp|high = ~low, union lone_low gives ~(low & trail), and the
    # final & ~trail absorbs it - every non-trail unit starts an event.
    start = ~trail
    iv = tuple(sorted(cp_iv))
    if len(iv) == 2 and iv[1][0] - iv[0][1] == 2:
        # Two intervals separated by a single excluded codepoint (the
        # default filters: printable ASCII + non-ASCII BMP, gap 0x7F):
        # span test + exclusion is 2 ops cheaper than two interval
        # tests.
        passes = (cp >= iv[0][0]) & (cp <= iv[1][1]) & (cp != iv[0][1] + 1)
    else:
        passes = jnp.zeros_like(u) != 0
        for lo, hi in iv:
            passes = passes | ((cp >= lo) & (cp <= hi))
    accept = valid & passes  # valid is already start-gated (& ~trail)
    # grep_char is static: with no grep the mask is statically false,
    # so the compare/and AND the counts pass's per-row grep
    # reduction column constant-fold away.
    grep = (accept & (cp == grep_char) if grep_char >= 0
            else jnp.zeros_like(u) != 0)
    return dict(start=start, valid=valid, accept=accept, grep=grep)


def _utf16_pair_structure(P, be: bool):
    """Surrogate structure of the panel (everything except the
    pair1-lookback, which callers batch into one word shift)."""
    u0, u1, u2 = _utf16_units(P, be)

    # u in [0xD800,0xDBFF] <=> u>>10 == 0x36 (and 0x37 for lows): one
    # shared shift + equality instead of two compares + and per test.
    s0, s1, s2 = u0 >> 10, u1 >> 10, u2 >> 10
    h0, h1 = s0 == 0x36, s1 == 0x36
    l0, l1 = s0 == 0x37, s1 == 0x37
    l2 = s2 == 0x37
    return dict(
        u0=u0, u1=u1, u2=u2, h0=h0, h1=h1, l0=l0, l1=l1, l2=l2,
        pair0=h0 & l1, pair1=h1 & l2,
    )


def _utf16_mission_masks(P, s, trail0, cp_iv, grep_char: int):
    """Per-slot mission masks from pair structure `s` + the
    previous-word trail flag."""
    m0 = _utf16_slot_masks(
        s["u0"], s["u1"], s["pair0"], s["h0"], s["l0"], s["l1"], trail0,
        cp_iv, grep_char,
    )
    m1 = _utf16_slot_masks(
        s["u1"], s["u2"], s["pair1"], s["h1"], s["l1"], s["l2"], s["pair0"],
        cp_iv, grep_char,
    )
    return m0, m1


def swar_utf16_panel(P: _Panel, cp_iv, grep_char: int, be: bool):
    """UTF-16 mission field word: unit0 field at bits 0-7, unit1 at
    bits 16-23 (units are 2 bytes; fields sit at the unit's first
    byte)."""
    s = _utf16_pair_structure(P, be)
    trail0 = P.back_elem(s["pair1"].astype(jnp.int32)) != 0
    m0, m1 = _utf16_mission_masks(P, s, trail0, cp_iv, grep_char)

    def field(m, pair):
        start = m["start"]
        ln = jnp.where(pair, 4, 2)
        return (
            m["accept"].astype(jnp.int32) * ACCEPT_BIT
            | (jnp.where(start, ln, 0) << LEN_SHIFT)
            | m["grep"].astype(jnp.int32) * GREP_BIT
            | start.astype(jnp.int32) * START_BIT
            | (start & m["valid"]).astype(jnp.int32) * VALID_BIT
        )

    f0 = field(m0, s["pair0"])
    f1 = field(m1, s["pair1"])
    return f0 | (f1 << 16)


def _sbyte_masks(P, acc_iv, grep_iv):
    """(accept, grep) 0x01-per-byte masks for a single-byte-encoding
    mission: the decoded-codepoint filter collapses to byte intervals
    computed on the host from the WHATWG index table (undefined bytes
    are simply absent from acc_iv - malformed and filter-rejected bytes
    break runs identically)."""
    W = P.W
    acc = jnp.zeros_like(W)
    for lo, hi in acc_iv:
        acc = acc | _range_mask(W, lo, hi)
    gf = jnp.zeros_like(W)
    for lo, hi in grep_iv:
        gf = gf | _range_mask(W, lo, hi)
    return acc, acc & gf


def swar_sbyte_panel(P, acc_iv, grep_iv):
    """Packed field words for a single-byte mission (slab re-derivation
    form): every byte is a length-1 char start."""
    acc, gf = _sbyte_masks(P, acc_iv, grep_iv)
    return acc * ACCEPT_BIT | (M01 << LEN_SHIFT) | (gf << 4) | (M01 << 5)


def swar_flags(w, w_prev, w_next):
    """Derive (acc, lf, gf, run_start, run_end) 0x01/byte-field words
    from packed-lane field words, with one word of context each side.
    Works on any array shape (context arrays same shape).

    The run-boundary rules are the word-packed form of the reference's
    run adjacency (chars are 1-4 bytes, so <=4 static byte shifts
    decide whether an accepted char continues a run or starts one)."""

    def lsr(x, k):
        return (x >> k) & ((1 << (32 - k)) - 1) if k else x

    m80 = jnp.int32(0x80808080 - (1 << 32))
    acc = w & M01
    lf = lsr(w, 1) & (7 * M01)
    gf = lsr(w, 4) & M01
    acc_p = w_prev & M01
    lf_p = lsr(w_prev, 1) & (7 * M01)
    acc_n = w_next & M01

    def zero_bytes(y):
        return lsr((y - M01) & ~y & m80, 7)

    cont_prev = jnp.zeros_like(w)
    joins_next = jnp.zeros_like(w)
    for L in (1, 2, 3, 4):
        eL = zero_bytes(lf ^ (L * M01)) & acc
        eL_p = zero_bytes(lf_p ^ (L * M01)) & acc_p
        # byte-slot shift toward higher positions (lookback by L)
        cont_prev |= ((eL << (8 * L)) | lsr(eL_p, 32 - 8 * L)) & M01
        # accept L bytes ahead (lookahead by L)
        acc_fwd = (lsr(acc, 8 * L) | (acc_n << (32 - 8 * L))) & M01
        joins_next |= zero_bytes(lf ^ (L * M01)) & acc_fwd
    run_start = acc & ~cont_prev & M01
    run_end = acc & ~joins_next & M01
    return acc, lf, gf, run_start, run_end


def _swar_boundary_masks(P, specs, hot_only: bool = False):
    """(rs, re, acc, gf) 0x01-per-byte mask words for each mission in
    `specs`, computed at mask level (no packed field words).

    `specs` is a tuple of static mission specs:
      ("utf8", af_iv, ubf_iv, grep)   - 4 length-class bits
      ("utf16", be, cp_iv, grep)      - 2 length-class bits
      ("sbyte", acc_iv, grep_iv)      - 1 length-class bit
    The per-byte bit budget is 8 length-class bits and 8 accept bits,
    so any combination with sum(bits) <= 8 fits one pass (e.g. the
    flagship utf8 + 2x utf16 uses exactly 8).

    Every cross-word lookback/lookahead is BATCHED: all UTF-16
    missions' pair trails share one word shift, and every mission's
    length-class masks (for run starts) and accept masks (for run
    ends) ride one packed back-shift and one packed forward-shift."""

    def slots(a0, a1):  # two unit-slot bools -> byte-slot 0x01 word
        return a0.astype(jnp.int32) | (a1.astype(jnp.int32) << 16)

    # Phase 1: per-mission structure; batch the utf16 pair trails.
    u16 = {}  # spec index -> (trail bit, pair structure)
    for i, sp in enumerate(specs):
        if sp[0] == "utf16":
            u16[i] = (len(u16), _utf16_pair_structure(P, sp[1]))
    pair_pack = None
    if u16:
        pair_pack = jnp.zeros_like(P.W)
        for j, s in u16.values():
            pair_pack = pair_pack | (s["pair1"].astype(jnp.int32) << j)

    # The UTF-8 structural masks are filter-independent: compute them
    # once for all UTF-8 missions, and ride the utf16 pair trails on
    # the claim lookback's word shift (word bits 3-6; see
    # _utf8_structure) - one word shift instead of two. Only the
    # first 4 UTF-16 missions fit those bits (bit 7+ would collide
    # with byte 1's claim bits after the <<8 in the claimed mask), so
    # larger mission sets - possible in hot_only mode, where the
    # 8-length-bit budget does not apply - keep the separate shift.
    u8s = None
    pair_on_claim = pair_pack is not None and len(u16) <= 4
    if any(sp[0] == "utf8" for sp in specs):
        u8s = _utf8_structure(
            P, pair_pack << 3 if pair_on_claim else None
        )
    if pair_pack is not None:
        if pair_on_claim and u8s is not None:
            pp = _lsr(u8s["extra_back"], 3)
        else:
            pp = P.back_elem(pair_pack)

    def iv_hits(iv, lo, hi):
        return any(a <= hi and b >= lo for a, b in iv)

    # Phase 2: mission masks + (acc, gf, length-class masks) per spec.
    # Length classes the filters can never accept are pruned: their
    # accept bit is statically zero, so they contribute nothing to the
    # run-boundary algebra (E = acc & sL, joins gated on the accept
    # bit) - this skips their packed-shift extraction entirely (the
    # flagship default accepts only 1- and 2-byte UTF-8 and BMP UTF-16,
    # so half the length classes vanish).
    per = []  # (acc, gf, [(L, sL)])
    for i, sp in enumerate(specs):
        if sp[0] == "utf8":
            _kind, af_iv, ubf_iv, grep = sp
            m8 = _utf8_masks(P, af_iv, ubf_iv, grep, struct=u8s)
            s1, s2, s3, s4 = _utf8_len_masks(m8)
            lens = [(1, s1)] if af_iv else []
            for L, sL, lo, hi in ((2, s2, 0xC2, 0xDF), (3, s3, 0xE0, 0xEF),
                                  (4, s4, 0xF0, 0xF4)):
                if iv_hits(ubf_iv, lo, hi):
                    lens.append((L, sL))
            per.append((m8["accept"], m8["grep"], lens))
        elif sp[0] == "sbyte":
            acc, gf = _sbyte_masks(P, sp[1], sp[2])
            per.append((acc, gf, [(1, jnp.full_like(P.W, M01))]))
        else:
            _kind, be, cp_iv, grep = sp
            j, s = u16[i]
            trail0 = ((pp >> j) & 1) != 0
            m0, m1 = _utf16_mission_masks(P, s, trail0, cp_iv, grep)
            acc = slots(m0["accept"], m1["accept"])
            gf = slots(m0["grep"], m1["grep"])
            s2u = slots(m0["start"] & ~s["pair0"], m1["start"] & ~s["pair1"])
            lens = [(2, s2u)]
            if any(hi >= 0x10000 for _lo, hi in cp_iv):  # astral passes
                s4u = slots(m0["start"] & s["pair0"], m1["start"] & s["pair1"])
                lens.append((4, s4u))
            per.append((acc, gf, lens))

    if hot_only:
        # Hot/cold mapping needs only the accept/grep masks - the run
        # boundary algebra (phase 3's packed shifts, ~20% of the pass)
        # is skipped, and the 8-length-class-bit budget does not apply
        # (missions never share packed words here).
        z = jnp.zeros_like(P.W)
        return [(z, z, acc, gf) for acc, gf, _lens in per]

    # Phase 3: packed boundary shifts shared across missions.
    # E: accepted char of length L ends L bytes later; S: char of
    # length L starts here (is_start-gated, matching the packed lf
    # field); A: accept bits.
    E = jnp.zeros_like(P.W)
    S = jnp.zeros_like(P.W)
    A = jnp.zeros_like(P.W)
    bitmap = []  # per mission: (abit, [(L, ebit)])
    nbit = 0
    for mi, (acc, _gf, lens) in enumerate(per):
        ebits = []
        for L, sL in lens:
            E = E | ((acc & sL) << nbit)
            S = S | (sL << nbit)
            ebits.append((L, nbit))
            nbit += 1
        A = A | (acc << mi)
        bitmap.append((mi, ebits))
    assert nbit <= 8, "mission set exceeds the 8-bit length-class budget"
    Ep = P.back_elem(E)
    An = P.fwd_elem(A)

    lengths = sorted({L for _mi, eb in bitmap for L, _b in eb})
    E_back = {L: (E << (8 * L)) | _lsr(Ep, 32 - 8 * L) for L in lengths}
    A_fwd = {L: _lsr(A, 8 * L) | (An << (32 - 8 * L)) for L in lengths}

    def bit(x, k):
        # arithmetic >> is safe: k <= 7, sign fill stays above bit 24
        return (x >> k) & M01 if k else x & M01

    out = []
    for (acc, gf, _lens), (abit, ebits) in zip(per, bitmap):
        cont = jnp.zeros_like(acc)
        joins = jnp.zeros_like(acc)
        for L, ebit in ebits:
            cont = cont | bit(E_back[L], ebit)
            joins = joins | (bit(S, ebit) & bit(A_fwd[L], abit))
        rs = acc & ~cont & M01
        re = acc & ~joins & M01
        out.append((rs, re, acc, gf))
    return out


@functools.partial(jax.jit, static_argnames=("specs", "hot_only"))
def swar_counts(
    words_2d: jax.Array,  # (rows, 128) int32: packed little-endian bytes
    specs: tuple,  # mission specs, see _swar_boundary_masks
    hot_only: bool = False,
    xor_word: jax.Array | None = None,  # int32 scalar: XOR the stream
):
    """Mission scans fused with run-compaction stage 1: one SWAR pass
    computes the mission masks, derives the run-boundary flags and
    reduces them to per-512-byte-block counts, so only the count panel
    (1/64th of the input) is written back.

    Returns int32[2 * len(specs), rows]: rows 2*m / 2*m+1 are mission
    m's packed block counts (run_start | run_end<<10 | accept<<20) and
    grep counts. Consumed by ops/runs.py:extract_runs_swar_blocks
    (stages 2-3) or used directly as a hot-block map (accept>0) by the
    device engine. `hot_only` skips the run-boundary algebra: the
    run_start/run_end fields are then zero.

    Stream edges behave as if the stream were surrounded by zero bytes,
    so zero-padded and unpadded inputs give identical results; the
    stage-3 slab re-derivation replicates the zero margins so counts
    and slabs always agree. `xor_word` XORs every stream word before
    the scan (the benchmark's way to make each iteration's input
    distinct). Caveat: a filter that ACCEPTS NUL (AF bit 0) treats the
    virtual zero context as accepted chars at the edges, exactly as a
    zero-padded caller would see."""
    rows = words_2d.shape[0]
    assert words_2d.shape[1] == LANE
    with jax.named_scope("swar_counts"):
        W = words_2d.reshape(1, rows * LANE)
        if xor_word is not None:
            W = W ^ jnp.asarray(xor_word, jnp.int32)
        masks = _swar_boundary_masks(_Panel(W), specs, hot_only=hot_only)

        def blocksum(x):
            # Sum of the 4 byte slots (each <= 1 here), then one sum
            # per 512-byte block. Counts <= 512 fit 10-bit fields, so
            # three quantities ride one reduce.
            return jnp.sum(_lsr(x * M01, 24).reshape(rows, LANE), axis=1)

        cols = []
        for rs, re, acc, gf in masks:
            if hot_only:
                cols.append(blocksum(acc) << 20)
            else:
                cols.append(
                    blocksum(rs) + (blocksum(re) << 10) + (blocksum(acc) << 20)
                )
            cols.append(blocksum(gf))
        return jnp.stack(cols, axis=0)


def flagship_swar_counts(
    words_2d: jax.Array,
    af_iv: tuple,
    ubf_iv: tuple,
    cp_iv_le: tuple,
    cp_iv_be: tuple,
    greps: tuple,
    xor_word: jax.Array | None = None,
):
    """The flagship 3-mission (UTF-8 + UTF-16LE/BE) counts pass - a
    swar_counts specialization kept as the bench/entry entry point."""
    specs = (
        ("utf8", af_iv, ubf_iv, greps[0]),
        ("utf16", False, cp_iv_le, greps[1]),
        ("utf16", True, cp_iv_be, greps[2]),
    )
    return swar_counts(words_2d, specs, xor_word=xor_word)


# ------------------------------------------------------- host-side helpers


# Static mission specs live in ops/specs.py (JAX-FREE
# - the host-only paths import them without touching jax); re-exported
# here for device-side callers.
from .specs import (  # noqa: F401,E402
    cjk_hot_spec,
    decompose_intervals,
    swar_mission_spec,
    utf8_lead_intervals,
    utf16_cp_intervals,
)

def swar_params(missions):
    """Static interval parameters for flagship_swar_counts, or None when
    a filter decomposes into too many intervals to be worth it."""
    m8, mle, mbe = missions[0], missions[1], missions[2]
    af_iv, ubf_iv = utf8_lead_intervals(m8)
    cp_le = utf16_cp_intervals(mle)
    cp_be = utf16_cp_intervals(mbe)
    if len(af_iv) + len(ubf_iv) > 12 or len(cp_le) > 12 or len(cp_be) > 12:
        return None
    greps = tuple(
        -1 if m.filter.grep_char is None else int(m.filter.grep_char)
        for m in (m8, mle, mbe)
    )
    return dict(af_iv=af_iv, ubf_iv=ubf_iv, cp_iv_le=cp_le, cp_iv_be=cp_be,
                greps=greps)
