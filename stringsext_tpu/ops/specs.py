"""Host-side static mission specs for the SWAR pass - JAX-FREE.

Filter decomposition into byte/codepoint intervals, the exact-count
mission specs and the conservative CJK/ISO plausible-byte hot specs.
Pure numpy/host code consumed by paths that must never import jax -
default probe segmentation, host hot maps, the distributed shard split
(cli.py contract: host scan runs touch neither jax nor the device
stack). `ops.swar` re-exports everything here for its device-side
callers.
"""

from __future__ import annotations

from typing import List, Tuple

def decompose_intervals(bits: int, nbits: int, base: int = 0) -> List[Tuple[int, int]]:
    """Set bits of a mask -> list of [lo, hi] inclusive intervals."""
    out = []
    i = 0
    while i < nbits:
        if (bits >> i) & 1:
            j = i
            while j + 1 < nbits and (bits >> (j + 1)) & 1:
                j += 1
            out.append((base + i, base + j))
            i = j + 1
        else:
            i += 1
    return out


def utf8_lead_intervals(mission):
    """(af_intervals, ubf_lead_intervals) for the SWAR UTF-8 filter."""
    af = decompose_intervals(mission.filter.af, 128)
    iv = decompose_intervals(mission.filter.ubf, 64, base=0xC0)
    iv = [
        (max(lo, 0xC2), min(hi, 0xF4)) for lo, hi in iv if hi >= 0xC2 and lo <= 0xF4
    ]
    return tuple(af), tuple(iv)


def utf16_cp_intervals(mission) -> tuple:
    """Decoded-codepoint intervals for a UTF-16 mission: AF bits map to
    cp 0..0x7F directly; each UBF lead bit maps to its codepoint span
    (2-byte leads: 64 cps, 3-byte: 4096, 4-byte: 256 Ki)."""
    out = list(decompose_intervals(mission.filter.af, 128))
    spans = []
    for bit in range(64):
        if (mission.filter.ubf >> bit) & 1:
            lead = 0xC0 + bit
            if 0xC2 <= lead <= 0xDF:
                spans.append(((lead - 0xC0) << 6, ((lead - 0xC0) << 6) | 0x3F))
            elif 0xE0 <= lead <= 0xEF:
                lo = (lead - 0xE0) << 12
                spans.append((max(lo, 0x800), lo | 0xFFF))
            elif 0xF0 <= lead <= 0xF4:
                lo = max(0x10000, (lead - 0xF0) << 18)
                hi = min(0x10FFFF, ((lead - 0xF0) << 18) | 0x3FFFF)
                if lo <= hi:
                    spans.append((lo, hi))
    spans.sort()
    for lo, hi in spans:
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return tuple(out)


def swar_mission_spec(mission):
    """Static swar_counts spec for one mission, or None when the
    encoding or its filters don't fit the SWAR kernel (too many filter
    intervals, or a non-UTF encoding)."""
    from ..encodings import encoding_kind

    kind = encoding_kind(mission.encoding_name)
    g = (
        -1 if mission.filter.grep_char is None
        else int(mission.filter.grep_char)
    )
    if kind == "utf8":
        af_iv, ubf_iv = utf8_lead_intervals(mission)
        if len(af_iv) + len(ubf_iv) > 12:
            return None
        return ("utf8", af_iv, ubf_iv, g)
    if kind in ("utf16le", "utf16be"):
        cp_iv = utf16_cp_intervals(mission)
        if len(cp_iv) > 12:
            return None
        return ("utf16", kind == "utf16be", cp_iv, g)
    if kind == "single-byte":
        from ..encodings import full_byte_table

        tbl = full_byte_table(mission.encoding_name)
        acc_bits = 0
        grep_bits = 0
        for b in range(256):
            cp = int(tbl[b])
            if cp < 0:
                continue  # undefined byte: malformed, breaks runs
            if cp < 0x80:
                ok = (mission.filter.af >> cp) & 1
            else:
                if cp < 0x800:
                    lead = 0xC0 | (cp >> 6)
                elif cp < 0x10000:
                    lead = 0xE0 | (cp >> 12)
                else:
                    lead = 0xF0 | (cp >> 18)
                ok = (mission.filter.ubf >> (lead & 0x3F)) & 1
            if ok:
                acc_bits |= 1 << b
                if g >= 0 and cp == g:
                    grep_bits |= 1 << b
        acc_iv = decompose_intervals(acc_bits, 256)
        grep_iv = decompose_intervals(grep_bits, 256)
        if len(acc_iv) > 16 or len(grep_iv) > 4:
            return None
        return ("sbyte", tuple(acc_iv), tuple(grep_iv))
    return None


def _merge_to_max(iv, cap):
    """Coarsen a sorted interval list to <= cap intervals by repeatedly
    filling the smallest gap (a conservative superset)."""
    iv = list(iv)
    while len(iv) > cap:
        gaps = [
            (iv[k + 1][0] - iv[k][1], k) for k in range(len(iv) - 1)
        ]
        _g, k = min(gaps)
        iv[k : k + 2] = [(iv[k][0], iv[k + 1][1])]
    return tuple(iv)


def _plausible_to_spec(plausible):
    """256-bool plausible-byte map -> sbyte counts spec (<= 12
    conservative intervals)."""
    import numpy as np

    bits = 0
    for b in np.flatnonzero(plausible).tolist():
        bits |= 1 << b
    if bits == 0:
        return ("sbyte", (), ())  # nothing accepted: everything cold
    return ("sbyte", _merge_to_max(decompose_intervals(bits, 256), 12), ())


def cjk_hot_spec(mission):
    """Conservative hot-block SWAR spec for a CJK multi-byte mission:
    an "sbyte"-style spec whose accept set is every byte value that can
    occur ANYWHERE inside a filter-accepted char ("plausible" bytes).
    Every byte of every finding is plausible, so a 512-byte block whose
    plausible-byte count is zero provably contains no finding byte and
    is cold. Used ONLY as a hot/cold block map (run.py engine=device) -
    never for run tables; the native emitter rescans hot ranges exactly
    (emitter.cpp align_cursor resumes the non-self-synchronizing
    decoders from a ground byte). Returns None for non-stateful
    encodings (they have exact-count specs instead).

    Modal ISO-2022-JP is included with a mode-blind plausible set: a
    byte is cold only when, in EVERY decoder mode, it is a one-byte
    event that cannot emit, cannot change the (mode, output_flag)
    state, and cannot shift the jis0208 pair phase. That leaves
    {>=0x80} u {0x0E,0x0F} u {AF-rejected controls and 0x7F}: escapes
    (0x1B), all of 0x21-0x7E (pair bytes / katakana / Roman remaps) and
    AF-accepted controls stay hot. Cold regions therefore contain no
    mode switches and no phase carriers, so the emitter may resume at
    any window edge - it additionally gates kind-9 skips on
    output_flag == false (emitter.cpp), because rejected control
    decodes in ASCII/Roman mode reset that flag."""
    import numpy as np

    from ..encodings import encoding_kind

    kind = encoding_kind(mission.encoding_name)
    if kind == "replacement":
        # The whole stream decodes to one malformed event: no finding
        # can exist, so every block is provably cold.
        return ("sbyte", (), ())
    if kind == "iso-2022-jp":
        f = mission.filter
        plausible = np.zeros(256, bool)
        plausible[0x1B] = True
        plausible[0x21:0x7F] = True
        for b in list(range(0x21)) + [0x7F]:
            if b not in (0x0E, 0x0F) and f.pass_af_filter(b):
                plausible[b] = True
        return _plausible_to_spec(plausible)
    if kind == "single-byte":
        # Reached only when the EXACT sbyte spec overflowed the SWAR
        # interval cap (swar_mission_spec returned None - e.g. the
        # scattered macintosh table under permissive filters): coarsen
        # the accepted-byte set to a conservative SUPERSET. Every
        # consumer of this function runs hot_only passes (hot/cold
        # block maps; the emitter rescans hot ranges exactly), where a
        # superset only costs extra hot blocks - without it, ONE such
        # mission in a set blocks device hot maps, host hot maps AND
        # the distributed shard split for the whole set.
        import numpy as np

        from ..encodings import full_byte_table

        tbl = full_byte_table(mission.encoding_name)
        f = mission.filter
        plausible = np.zeros(256, bool)
        for b in range(256):
            cp = int(tbl[b])
            if cp < 0:
                continue
            if cp < 0x80:
                plausible[b] = bool((f.af >> cp) & 1)
            else:
                if cp < 0x800:
                    lead = 0xC0 | (cp >> 6)
                elif cp < 0x10000:
                    lead = 0xE0 | (cp >> 12)
                else:
                    lead = 0xF0 | (cp >> 18)
                plausible[b] = bool((f.ubf >> (lead & 0x3F)) & 1)
        bits = 0
        for b in np.flatnonzero(plausible).tolist():
            bits |= 1 << b
        if bits == 0:
            return ("sbyte", (), ())
        # Tighter interval cap than the CJK plausible specs (8 vs 12):
        # this spec joins LARGE fused passes (the all-encodings sweep),
        # where every interval is one more range test per word.
        # Coarser superset = a few extra hot blocks for this mission
        # only.
        return ("sbyte", _merge_to_max(decompose_intervals(bits, 256), 8),
                ())
    if kind not in ("euc-kr", "big5", "shift_jis", "euc-jp", "gb18030"):
        return None

    f = mission.filter
    af_bits = np.array([(f.af >> i) & 1 for i in range(128)], bool)
    ubf_bits = np.array([(f.ubf >> i) & 1 for i in range(64)], bool)

    def acc(cps):
        cps = np.asarray(cps, np.int64)
        lead = np.where(
            cps < 0x800, 0xC0 | (cps >> 6),
            np.where(cps < 0x10000, 0xE0 | (cps >> 12), 0xF0 | (cps >> 18)),
        )
        ok = np.where(
            cps < 0x80,
            af_bits[np.clip(cps, 0, 127)],
            ubf_bits[np.clip(lead & 0x3F, 0, 63)],
        )
        return ok & (cps >= 0)

    plausible = np.zeros(256, bool)
    bts = np.arange(128)
    plausible[:128] |= acc(bts)  # 1-byte ASCII events (all kinds)

    from ..native import _pair_cp_table

    tbl = np.asarray(_pair_cp_table(kind))
    okm = (tbl >= 0) & acc(tbl)
    plausible |= okm.any(axis=1)  # leads of accepted pairs
    plausible |= okm.any(axis=0)  # trails of accepted pairs

    if kind == "shift_jis":  # 1-byte halfwidth katakana 0xA1-0xDF
        b = np.arange(0xA1, 0xE0)
        plausible[0xA1:0xE0] |= acc(0xFF61 - 0xA1 + b)
        plausible[0x80] |= bool(acc(np.array([0x80]))[0])
    elif kind == "euc-jp":
        # 0x8E + kana trail (2-byte) and 0x8F + jis0212 pair (3-byte)
        t = np.arange(0xA1, 0xE0)
        kana = acc(0xFF61 - 0xA1 + t)
        if kana.any():
            plausible[0x8E] = True
            plausible[0xA1:0xE0] |= kana
        from ..native import _eucjp_0212_cp_table

        t2 = np.asarray(_eucjp_0212_cp_table())
        ok2 = (t2 >= 0) & acc(t2)
        if ok2.any():
            plausible[0x8F] = True
            plausible |= ok2.any(axis=1)
            plausible |= ok2.any(axis=0)
    elif kind == "gb18030":
        # WHATWG step 7: 0x80 decodes to U+20AC (the GBK euro quirk)
        plausible[0x80] |= bool(acc(np.array([0x20AC]))[0])
        # four-byte form: enumerate the two valid pointer segments
        from ..native import _gb18030_ranges

        ptrs, cps = _gb18030_ranges()
        ptr = np.concatenate(
            [np.arange(0, 39420), np.arange(189000, 1237576)]
        )
        idx = np.searchsorted(ptrs, ptr, "right") - 1
        ok4 = acc(cps[idx] + ptr - ptrs[idx])
        if ok4.any():
            p4 = ptr[ok4]
            plausible[0x30:0x3A] = True  # b2/b4 digits
            for bvals in (0x81 + p4 // 12600, 0x81 + (p4 // 10) % 126):
                plausible[np.unique(bvals)] = True
    elif kind == "big5":  # double-codepoint pairs (either cp accepted)
        from ..engine.events_cjk import _pair_table

        _v, multi = _pair_table("big5")
        for key, cps2 in multi.items():
            if acc(np.asarray(cps2)).any():
                plausible[key >> 8] = True
                plausible[key & 0xFF] = True

    return _plausible_to_spec(plausible)


