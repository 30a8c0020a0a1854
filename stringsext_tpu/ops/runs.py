"""Mission filter masks and accepted-run compaction on device.

This is the device analog of the reference's hot path (SURVEY.md section 7
steps 2-4): the per-char filter walk of SplitStr (helper.rs:237-332)
becomes per-byte boolean lanes + a segmented-run compaction, all fused
by XLA on device. The output is a fixed-capacity run table
(start, end, char_count) of maximal accepted-char runs - the sparse
summary the host emission automaton (or the native emitter) consumes
instead of raw bytes.

Filter semantics (mission.rs:307-348): a char passes iff
  cp < 0x80:  AF bit `cp` set
  cp >= 0x80: UBF bit `(utf8_lead(cp) & 0x3f)` set
The grep-char and same-block rules operate at run level and are applied
downstream; per-run grep counts are produced here so most runs can be
filtered without touching bytes again.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..mission import Mission
from .classify import Lanes
from .swar import (
    _Panel,
    _lsr,
    swar_flags,
    swar_sbyte_panel,
    swar_utf8_panel,
    swar_utf16_panel,
)


class RunTable(NamedTuple):
    """Fixed-capacity table of maximal accepted runs in a chunk."""

    start: jax.Array  # int32[K]: byte offset of run start
    end: jax.Array  # int32[K]: byte offset one past the run's last byte
    chars: jax.Array  # int32[K]: number of chars in the run
    grep_hits: jax.Array  # int32[K]: chars equal to grep_char
    count: jax.Array  # int32[]: number of valid rows
    overflow: jax.Array  # bool[]: table capacity exceeded


def utf8_lead_of_cp(cp: jax.Array) -> jax.Array:
    """UTF-8 leading byte of a codepoint (vector form of
    engine/automaton.py:utf8_lead)."""
    return jnp.where(
        cp < 0x80,
        cp,
        jnp.where(
            cp < 0x800,
            0xC0 | (cp >> 6),
            jnp.where(cp < 0x10000, 0xE0 | (cp >> 12), 0xF0 | (cp >> 18)),
        ),
    )


def accept_mask(lanes: Lanes, af_words: jax.Array, ubf_words: jax.Array) -> jax.Array:
    """Per-byte accept lane: byte starts a char that passes the AF/UBF
    filter. `af_words` is the 128-bit AF mask as uint32[4], `ubf_words`
    the 64-bit UBF mask as uint32[2].

    The bit lookup is branch-free: select the mask word with arithmetic
    (no gather), then test the bit.
    """
    cp = lanes.cp
    is_char = lanes.valid & lanes.start & (cp >= 0)

    # ASCII: bit cp of the 128-bit AF mask.
    word_idx = (cp >> 5) & 0x3  # which uint32 word
    bit = cp & 0x1F
    afw = jnp.zeros_like(cp)
    for wi in range(4):
        afw = jnp.where(word_idx == wi, af_words[wi].astype(jnp.int32), afw)
    af_pass = ((afw >> bit) & 1) != 0

    # Multibyte: bit (lead & 0x3f) of the 64-bit UBF mask.
    lead = utf8_lead_of_cp(jnp.maximum(cp, 0))
    ub = lead & 0x3F
    ubw = jnp.where((ub >> 5) == 0, ubf_words[0].astype(jnp.int32), ubf_words[1].astype(jnp.int32))
    ubf_pass = ((ubw >> (ub & 0x1F)) & 1) != 0

    passes = jnp.where(cp < 0x80, af_pass, ubf_pass)
    return is_char & passes


def filter_words(m: Mission):
    """Mission filter masks as device-friendly uint32 words."""
    af = m.filter.af
    ubf = m.filter.ubf
    af_words = np.array([(af >> (32 * i)) & 0xFFFFFFFF for i in range(4)], dtype=np.uint32)
    ubf_words = np.array([(ubf >> (32 * i)) & 0xFFFFFFFF for i in range(2)], dtype=np.uint32)
    return af_words, ubf_words


def _expand_bytes(slab_words):
    """(K, m) packed words -> (K, 4m) per-byte fields (little-endian)."""
    m = slab_words.shape[1]
    parts = [_lsr(slab_words, 8 * j) & 0xFF for j in range(4)]
    return jnp.stack(parts, axis=-1).reshape(slab_words.shape[0], m * 4)


@functools.partial(
    jax.jit,
    static_argnames=("kind", "af_iv", "ubf_iv", "cp_iv", "acc_iv",
                     "grep_iv", "grep", "be", "capacity"),
)
def extract_runs_swar_blocks(
    words: jax.Array,  # int32 packed LE words, flat or (rows, 128)
    enc_blk: jax.Array,  # int32[nb]: run_start | run_end<<10 | accept<<20
    grep_blk: jax.Array,  # int32[nb]
    *,
    kind: str,  # "utf8" | "utf16" | "sbyte"
    af_iv: tuple = (),
    ubf_iv: tuple = (),
    cp_iv: tuple = (),
    acc_iv: tuple = (),
    grep_iv: tuple = (),
    grep: int = -1,
    be: bool = False,
    capacity: int = 4096,
    xor_word: jax.Array | None = None,  # int32: XOR gathered slabs
) -> RunTable:
    """Run compaction stages 2-3 from the fused counts pass
    (swar.swar_counts): stage 1 (boundary flags + per-512-byte-block
    counts) already ran inside that pass, so no full-size lane array
    ever exists. This locates each of the
    <=capacity runs with tiny block cumsums and re-derives the boundary
    slabs from the RAW input words - a capacity-sized gather plus the
    same SWAR field math on (K, 132)-word slabs.

    Interval/grep parameters are the per-mission pieces of
    swar.swar_params (static)."""
    w = words.reshape(-1)
    nw = w.shape[0]
    nb = enc_blk.shape[0]
    bw = _BLOCK // 4
    n = nb * _BLOCK

    expand = _expand_bytes

    wm = w.reshape(nb, bw)

    def slab_flags(b):
        """Gather block b's raw words + 2 context words each side,
        recompute the mission fields on the slab, and derive the
        per-byte flag slabs (K, _BLOCK). Fields need +-1 word of raw
        context and flags +-1 word of field context, so with a 2-word
        margin the interior block columns are exact.

        The block body is one contiguous ROW gather (K x 512 B rows);
        only the 4 margin words use K-element point gathers."""
        base = b * bw
        body = wm[b]  # (K, bw) contiguous rows
        if xor_word is not None:
            body = body ^ xor_word

        def margin(off):
            idx = base + off
            # Out-of-stream margins are ZERO words, matching the
            # counts pass's stream-edge semantics (zero context AFTER
            # any XOR; see the swar_counts docstring), so slab fields
            # equal counts-pass fields at the first/last blocks.
            word = w[jnp.clip(idx, 0, nw - 1)]
            if xor_word is not None:
                word = word ^ xor_word
            return jnp.where((idx >= 0) & (idx < nw), word, 0)[:, None]

        slabW = jnp.concatenate(
            [margin(-2), margin(-1), body, margin(bw), margin(bw + 1)], axis=1
        )
        P = _Panel(slabW)
        if kind == "utf8":
            F = swar_utf8_panel(P, af_iv, ubf_iv, grep)
        elif kind == "sbyte":
            F = swar_sbyte_panel(P, acc_iv, grep_iv)
        else:
            F = swar_utf16_panel(P, cp_iv, grep, be)
        z = jnp.zeros_like(F[:, :1])
        Fp = jnp.concatenate([z, F[:, :-1]], axis=1)
        Fn = jnp.concatenate([F[:, 1:], z], axis=1)
        a, l, g, rs, re = swar_flags(F, Fp, Fn)
        return tuple(expand(x[:, 2 : 2 + bw]) for x in (a, l, g, rs, re))

    return _runs_from_block_counts(slab_flags, enc_blk, grep_blk, capacity, n)


_SB = 64  # superblock size (in blocks) for the two-level locate


def _runs_from_block_counts(slab_flags, enc_blk, grep_blk, capacity, n):
    """Shared stages 2-3: block cumsums locate each run's block, the
    caller's slab_flags(b) materializes only the selected (K, _BLOCK)
    flag slabs, and per-run aggregates come from prefix differences.

    All rank lookups are branchless compare-sums over 64-wide levels
    (two levels up to 4096 blocks = 2 MiB, three beyond) instead of a
    binary-search searchsorted over the 10^4-10^5-element block cumsum,
    which would be ~17 dependent gather rounds. The items-before prefix
    is one K-sized point gather blk_cum[b-1]."""
    nb0 = enc_blk.shape[0]
    pad = (-nb0) % _SB
    if pad:
        enc_blk = jnp.concatenate([enc_blk, jnp.zeros(pad, enc_blk.dtype)])
        grep_blk = jnp.concatenate([grep_blk, jnp.zeros(pad, grep_blk.dtype)])
    nb = enc_blk.shape[0]
    nsb = nb // _SB
    cum_start = jnp.cumsum(enc_blk & 0x3FF)
    cum_end = jnp.cumsum((enc_blk >> 10) & 0x3FF)
    cum_accept = jnp.cumsum((enc_blk >> 20) & 0x3FF)
    cum_grep = jnp.cumsum(grep_blk)
    nruns = cum_start[-1]

    k = jnp.arange(1, capacity + 1, dtype=jnp.int32)
    row_ok = k <= nruns

    def rank_lookup(blk_cum):
        """(block index, #items before that block) of the k-th item.

        b = #blocks whose cumsum is < k, found level by level; for
        valid rows (k <= total) blk_cum[b-1] is then exactly the
        items-before count (b is the first block with cum >= k).
        Masked rows (k > total) produce clamped garbage that the
        row_ok selects discard downstream."""
        c2 = blk_cum.reshape(nsb, _SB)
        sb_last = c2[:, -1]
        if nsb > _SB:
            # Third level: pad superblock tails to a _SB multiple with
            # the global total - monotone, and a total-valued entry is
            # never < k on valid rows, so padding adds no count.
            pad2 = (-nsb) % _SB
            sb_pad = (
                jnp.concatenate(
                    [sb_last, jnp.full((pad2,), blk_cum[-1], blk_cum.dtype)]
                )
                if pad2
                else sb_last
            )
            nss = sb_pad.shape[0] // _SB
            c3 = sb_pad.reshape(nss, _SB)
            ss_last = c3[:, -1]
            lt_ss = ss_last[None, :] < k[:, None]  # (K, nss)
            b_ss = jnp.minimum(jnp.sum(lt_ss.astype(jnp.int32), 1), nss - 1)
            win_sb = c3[b_ss]  # (K, SB) contiguous row gather
            pos_ss = jnp.sum((win_sb < k[:, None]).astype(jnp.int32), 1)
            b_sb = jnp.minimum(b_ss * _SB + pos_ss, nsb - 1)
        else:
            lt_sb = sb_last[None, :] < k[:, None]  # (K, nsb)
            b_sb = jnp.minimum(jnp.sum(lt_sb.astype(jnp.int32), 1), nsb - 1)
        win = c2[b_sb]  # (K, SB) contiguous row gather
        pos_sb = jnp.sum((win < k[:, None]).astype(jnp.int32), 1)
        b = jnp.minimum(b_sb * _SB + pos_sb, nb0 - 1)
        prev = jnp.where(b > 0, blk_cum[jnp.maximum(b - 1, 0)], 0)
        return b, prev

    def locate(blk_cum, which):
        b, prev = rank_lookup(blk_cum)
        local_k = k - prev
        a_e, l_e, g_e, rs_e, re_e = slab_flags(b)
        flags = {"rs": rs_e, "re": re_e}[which]
        local_cum = jnp.cumsum(flags, axis=1)
        pos = jnp.sum((local_cum < local_k[:, None]).astype(jnp.int32), axis=1)
        pos = jnp.minimum(pos, _BLOCK - 1)
        return jnp.minimum(b * _BLOCK + pos, n - 1), b, pos, (a_e, l_e, g_e)

    si_c, sb, sp, s_slabs = locate(cum_start, "rs")
    ei_c, eb, ep, e_slabs = locate(cum_end, "re")

    def pref_at(slab, blk_cum, bx, px):
        prev = jnp.where(bx > 0, blk_cum[jnp.maximum(bx - 1, 0)], 0)
        idxs = jnp.arange(_BLOCK, dtype=jnp.int32)[None, :]
        local = jnp.sum(jnp.where(idxs <= px[:, None], slab, 0), axis=1)
        return prev + local

    pc_e = pref_at(e_slabs[0], cum_accept, eb, ep)
    pc_s = pref_at(s_slabs[0], cum_accept, sb, sp)
    pg_e = pref_at(e_slabs[2], cum_grep, eb, ep)
    pg_s = pref_at(s_slabs[2], cum_grep, sb, sp)

    rowk = jnp.arange(capacity)
    len_at_e = e_slabs[1][rowk, ep]
    g_at_s = s_slabs[2][rowk, sp]

    start = jnp.where(row_ok, si_c, jnp.int32(2**31 - 1))
    end = jnp.where(row_ok, ei_c + len_at_e, 0)
    chars = jnp.where(row_ok, pc_e - pc_s + 1, 0)
    grep_hits = jnp.where(row_ok, pg_e - pg_s + g_at_s, 0)

    return RunTable(
        start=start,
        end=end,
        chars=chars,
        grep_hits=grep_hits,
        count=jnp.minimum(nruns, capacity),
        overflow=nruns > capacity,
    )


@functools.partial(jax.jit, static_argnames=("capacity",))
def extract_runs(
    lanes: Lanes,
    af_words: jax.Array,
    ubf_words: jax.Array,
    grep_char: jax.Array,
    capacity: int = 4096,
) -> RunTable:
    """Compact maximal accepted-char runs into a fixed-size table.

    A run is a maximal sequence of chars that all pass the AF/UBF
    filter (bytes inside a multi-byte char belong to their char; runs
    break at rejected chars, malformed sequences and gaps).

    Deliberately scatter-free: run adjacency is decided
    with <=4 static shifts (chars are 1-4 bytes), run boundaries are
    located with cumsum + a capacity-sized vectorized searchsorted, and
    per-run aggregates come from prefix-sum differences gathered at the
    capacity-sized boundary vectors. Everything large is elementwise,
    cumsum, or a K-sized gather - no O(n) scatter.
    """
    accept = accept_mask(lanes, af_words, ubf_words)
    gflag = accept & (lanes.cp == grep_char)
    return _compact_runs(accept, lanes.length, gflag, capacity)


_BLOCK = 512  # hierarchical compaction block (bytes)


def _compact_runs(accept, length, gflag, capacity: int) -> RunTable:
    """Hierarchical (two-level) run-boundary compaction.

    Full-length cumsums are the expensive part, so instead: (1) one fused elementwise pass derives the boundary flags
    and reduces per-512-byte-block counts (boundary+accept counts are
    bit-packed so one reduction covers three quantities); (2) tiny
    cumsums over block counts locate each of the <=capacity runs'
    blocks via binary search; (3) only the selected blocks (capacity x
    512 slabs) are gathered and locally scanned. Full-array work is a
    couple of streaming passes; everything else is K-sized.
    """
    n0 = accept.shape[0]
    n = ((n0 + _BLOCK - 1) // _BLOCK) * _BLOCK
    if n != n0:
        pad = n - n0
        accept = jnp.concatenate([accept, jnp.zeros(pad, accept.dtype)])
        length = jnp.concatenate([length, jnp.ones(pad, length.dtype)])
        gflag = jnp.concatenate([gflag, jnp.zeros(pad, gflag.dtype)])
    nb = n // _BLOCK

    def shift_right(x, k):
        return jnp.concatenate([jnp.zeros((k,), x.dtype), x[: n - k]])

    def shift_left(x, k):
        return jnp.concatenate([x[k:], jnp.zeros((k,), x.dtype)])

    # continued-from-previous: an accepted char of length L ends here.
    cont_prev = jnp.zeros(n, bool)
    joins_next = jnp.zeros(n, bool)
    for L in (1, 2, 3, 4):
        cont_prev |= shift_right(accept & (length == L), L)
        joins_next |= (length == L) & shift_left(accept, L)
    run_start = accept & ~cont_prev
    run_end = accept & ~(joins_next & accept)

    # Stage 1: per-block counts, three quantities packed in one reduce
    # (counts <= _BLOCK = 512 < 1024 fit 10-bit fields).
    enc = (
        run_start.astype(jnp.int32)
        + (run_end.astype(jnp.int32) << 10)
        + (accept.astype(jnp.int32) << 20)
    )
    blk = jnp.sum(enc.reshape(nb, _BLOCK), axis=1)
    bc_start = blk & 0x3FF
    bc_end = (blk >> 10) & 0x3FF
    bc_accept = blk >> 20
    bc_grep = jnp.sum(gflag.reshape(nb, _BLOCK).astype(jnp.int32), axis=1)

    # Stage 2: tiny block-level cumsums.
    cum_start = jnp.cumsum(bc_start)
    cum_end = jnp.cumsum(bc_end)
    cum_accept = jnp.cumsum(bc_accept)
    cum_grep = jnp.cumsum(bc_grep)
    nruns = cum_start[-1]

    k = jnp.arange(1, capacity + 1, dtype=jnp.int32)
    row_ok = k <= nruns

    def locate(flags, blk_cum):
        """Positions of the k-th set flags (1-based k)."""
        b = jnp.minimum(jnp.searchsorted(blk_cum, k, side="left"), nb - 1)
        prev = jnp.where(b > 0, blk_cum[jnp.maximum(b - 1, 0)], 0)
        local_k = k - prev
        slab = flags.reshape(nb, _BLOCK)[b].astype(jnp.int32)  # (K, B)
        local_cum = jnp.cumsum(slab, axis=1)
        pos = jax.vmap(lambda c, t: jnp.searchsorted(c, t, side="left"))(
            local_cum, local_k
        ).astype(jnp.int32)
        return jnp.minimum(b * _BLOCK + jnp.minimum(pos, _BLOCK - 1), n - 1), b

    si_c, sb = locate(run_start, cum_start)
    ei_c, eb = locate(run_end, cum_end)

    def pref_at(flags, blk_cum, x, bx):
        """#set flags in [0..x] via block cumsum + local slab sum."""
        prev = jnp.where(bx > 0, blk_cum[jnp.maximum(bx - 1, 0)], 0)
        slab = flags.reshape(nb, _BLOCK)[bx].astype(jnp.int32)  # (K, B)
        off = x - bx * _BLOCK
        idxs = jnp.arange(_BLOCK, dtype=jnp.int32)[None, :]
        local = jnp.sum(jnp.where(idxs <= off[:, None], slab, 0), axis=1)
        return prev + local

    pc_e = pref_at(accept, cum_accept, ei_c, eb)
    pc_s = pref_at(accept, cum_accept, si_c, sb)
    pg_e = pref_at(gflag, cum_grep, ei_c, eb)
    pg_s = pref_at(gflag, cum_grep, si_c, sb)

    length_at_e = length.reshape(nb, _BLOCK)[eb][
        jnp.arange(capacity), jnp.minimum(ei_c - eb * _BLOCK, _BLOCK - 1)
    ]
    g_at_s = (
        gflag.reshape(nb, _BLOCK)[sb][
            jnp.arange(capacity), jnp.minimum(si_c - sb * _BLOCK, _BLOCK - 1)
        ]
    ).astype(jnp.int32)

    start = jnp.where(row_ok, si_c, jnp.int32(2**31 - 1))
    end = jnp.where(row_ok, ei_c + length_at_e, 0)
    chars = jnp.where(row_ok, pc_e - pc_s + 1, 0)
    grep_hits = jnp.where(row_ok, pg_e - pg_s + g_at_s, 0)

    return RunTable(
        start=start,
        end=end,
        chars=chars,
        grep_hits=grep_hits,
        count=jnp.minimum(nruns, capacity),
        overflow=nruns > capacity,
    )
