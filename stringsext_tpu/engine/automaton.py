"""Emission automaton: replays the reference's observable chunking
semantics over the data-parallel decode-event stream.

The reference processes input as 4 KiB slices (input.rs:22) cut into
2*output_line_char_nb_max-byte decode windows
(finding_collection.rs:120-131), with three pieces of carry state
(scanner.rs:40-68): the decoder's pending bytes, a short "leftover"
string re-fed to the next batch, and a maybe-cut continuation flag. All
three are observable in the output (positions, `<`/` `/`>` precision
tags, `+` continuation tags), so this module replays them exactly:

- `split_str` is a faithful port of the `SplitStr` iterator
  (helper.rs:206-433), operating on decoded codepoints instead of raw
  UTF-8 pointers.
- `SliceScanner.scan_slice` is a faithful port of
  `FindingCollection::from` (finding_collection.rs:84-342): the window
  loop, decode-call splitting at malformed sequences, the leftover
  prepend, and the `Precision::Before` double-decode heuristic
  (finding_collection.rs:155-207).

The heavy per-byte work (validity, classification) happened earlier in
the data-parallel event generation (engine/events.py or the device passes
in ops/); this automaton touches only events, which are sparse for
binary inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np

from ..finding import Finding, PRECISION_AFTER, PRECISION_BEFORE, PRECISION_EXACT
from ..mission import Mission, Utf8Filter
from .events import Events, generate_events

# The reference's ByteCounter is u64 (input.rs:16): positions and the
# consumed counter wrap mod 2^64 in release Rust when -s pushes them
# past the max; the native engine wraps the same way in C.
_U64_MASK = (1 << 64) - 1


def utf8_lead(cp: int) -> int:
    """UTF-8 leading byte of a codepoint."""
    if cp < 0x80:
        return cp
    if cp < 0x800:
        return 0xC0 | (cp >> 6)
    if cp < 0x10000:
        return 0xE0 | (cp >> 12)
    return 0xF0 | (cp >> 18)


def utf8_len(cp: int) -> int:
    if cp < 0x80:
        return 1
    if cp < 0x800:
        return 2
    if cp < 0x10000:
        return 3
    return 4


def encode_utf8(cps) -> bytes:
    return "".join(map(chr, cps)).encode("utf-8")


@dataclasses.dataclass
class Chunk:
    """One `SplitStrResult` (helper.rs:126-168), as char-index range."""

    start: int
    end: int
    s_completes_previous_s: bool
    s_is_maybe_cut: bool
    s_is_to_be_filtered_again: bool
    s_satisfies_min_char_rule: bool
    s_satisfies_grep_char_rule: bool


def split_str(
    cps: List[int],
    chars_min_nb: int,
    require_same_unicode_block: bool,
    last_s_was_maybe_cut: bool,
    invalid_bytes_after_inp: bool,
    utf8f: Utf8Filter,
    s_char_nb_max: int,
) -> Iterator[Chunk]:
    """Port of `SplitStr::next()` (helper.rs:206-433).

    Yields chunks; a dismissal (helper.rs:410-415 returning None) ends
    the iteration - including the mid-buffer case, exactly like the
    reference's `for chunk in SplitStr` loop stopping at the first None.
    """
    n = len(cps)
    inp_start = 0  # moves to p on a line-wrap exit (helper.rs:417-420)
    p = 0
    last_maybe_cut = last_s_was_maybe_cut
    grep_char = utf8f.grep_char

    while True:
        grep_ok = grep_char is None
        ok_s_p = p
        ok_char_nb = 0
        last_multi_lead = 0

        while p < n and ok_char_nb < s_char_nb_max:
            cp = cps[p]
            if cp < 0x80:
                if not grep_ok and grep_char == cp:
                    grep_ok = True
                char_ok = utf8f.pass_af_filter(cp)
                goto_next = True
            else:
                lead = utf8_lead(cp)
                if utf8f.pass_ubf_filter(lead):
                    if (
                        not require_same_unicode_block
                        or lead == last_multi_lead
                        or last_multi_lead == 0
                    ):
                        last_multi_lead = lead
                        char_ok = True
                        goto_next = True
                    else:
                        # char is ok but in a different block: it will be
                        # re-scanned as the start of the next run
                        # (helper.rs:287-291).
                        last_multi_lead = lead
                        char_ok = False
                        goto_next = False
                else:
                    last_multi_lead = 0
                    char_ok = False
                    goto_next = True

            if char_ok:
                ok_char_nb += 1
                p += 1
            else:
                if goto_next:
                    p += 1
                # Exit 3 (left-edge completion) / exit 4 (enough chars)
                # (helper.rs:314-321).
                if (last_maybe_cut and ok_char_nb > 0 and ok_s_p == inp_start) or (
                    ok_char_nb >= chars_min_nb and grep_ok
                ):
                    break
                ok_char_nb = 0
                ok_s_p = p
                grep_ok = grep_char is None

        if ok_char_nb == 0:
            return  # empty -> None (helper.rs:343-345)

        s_touches_left = ok_s_p == inp_start
        s_touches_right = ok_s_p + ok_char_nb >= n
        s_is_maybe_cut = ok_char_nb >= s_char_nb_max or (
            s_touches_right and not invalid_bytes_after_inp
        )
        s_completes_previous_s = s_touches_left and last_maybe_cut
        s_is_to_be_filtered_again = (
            not s_completes_previous_s
            and s_touches_right
            and not invalid_bytes_after_inp
            and (ok_char_nb < s_char_nb_max or not grep_ok)
        )
        s_min_ok = ok_char_nb >= chars_min_nb
        s_grep_ok = grep_ok

        # Dismissal ends the whole iteration (helper.rs:410-415).
        if (
            not s_completes_previous_s
            and not s_is_to_be_filtered_again
            and (not s_grep_ok or not s_min_ok)
        ):
            return

        if ok_char_nb >= s_char_nb_max:
            inp_start = p
        last_maybe_cut = s_is_maybe_cut

        yield Chunk(
            ok_s_p,
            ok_s_p + ok_char_nb,
            s_completes_previous_s,
            s_is_maybe_cut,
            s_is_to_be_filtered_again,
            s_min_ok,
            s_grep_ok,
        )


class ScannerState:
    """Per-mission carry state across slices (scanner.rs:40-89)."""

    __slots__ = ("mission", "leftover_cps", "last_printed_maybe_cut", "consumed_bytes")

    def __init__(self, mission: Mission):
        self.mission = mission
        self.leftover_cps: List[int] = []
        self.last_printed_maybe_cut = False
        self.consumed_bytes = mission.counter_offset


def _fresh_decode_prefix(slice_bytes: np.ndarray, encoding_name: str, cap: int = 8) -> bytes:
    """Emulates the double-decode workaround's fresh decoder
    (finding_collection.rs:180-195): decode the slice from offset 0 into
    a `cap`-byte UTF-8 buffer, stopping at the first malformed sequence
    or when the next char would not fit."""
    prefix = slice_bytes[: min(len(slice_bytes), 64)]
    ev = generate_events(np.asarray(prefix, dtype=np.uint8), encoding_name)
    out = bytearray()
    for i in range(len(ev)):
        cp = int(ev.cp[i])
        if cp < 0:
            break
        ln = utf8_len(cp)
        if len(out) + ln > cap:
            break
        out += chr(cp).encode("utf-8")
    return bytes(out)


class SliceScanner:
    """Drives `scan_slice` over a stream's event arrays for one mission.

    Port of `FindingCollection::from` (finding_collection.rs:84-342).
    The caller feeds slices in stream order; `events` covers the whole
    stream with stream-absolute positions.
    """

    def __init__(self, mission: Mission):
        self.mission = mission
        self.state = ScannerState(mission)

    def scan_slice(
        self,
        slice_bytes: np.ndarray,
        slice_stream_start: int,
        events: Events,
        input_file_id: Optional[int],
        is_last_input_buffer: bool,
    ) -> List[Finding]:
        """Scan one input slice; returns its findings in stream order."""
        m = self.mission
        st = self.state
        slice_len = len(slice_bytes)
        findings: List[Finding] = []

        # Event range whose report point lies in this slice.
        slice_stream_end = slice_stream_start + slice_len
        ei = int(np.searchsorted(events.report, slice_stream_start, side="left"))
        ei_end = int(np.searchsorted(events.report, slice_stream_end, side="left"))

        # Carry state into local variables (finding_collection.rs:100-117).
        state = {
            "pending": st.leftover_cps if st.leftover_cps else None,
            "flag": st.last_printed_maybe_cut,
        }

        w = 2 * m.output_line_char_nb_max
        label = 0  # slice-relative decoder_input_start
        base = st.consumed_bytes  # absolute position of slice byte 0

        def process_call(call_label: int, call_chars: List[int], invalid_after: bool):
            """One decode call: precision, leftover prepend, SplitStr,
            chunk bookkeeping (finding_collection.rs:134-290)."""
            pending = state["pending"]

            # --- precision (finding_collection.rs:146-221)
            precision = PRECISION_EXACT
            if call_label == 0 and call_chars:
                first_lead = utf8_lead(call_chars[0])
                if first_lead >= 0x80:
                    # Each char encodes to >= 1 byte, so 8 chars of
                    # each source bound the 8-byte prefix.
                    ref_prefix = (
                        encode_utf8((pending or [])[:8])
                        + encode_utf8(call_chars[:8])
                    )[:8]
                    fresh = _fresh_decode_prefix(slice_bytes, m.encoding_name)
                    # The reference compares fresh[0..written] against
                    # its ZERO-INITIALIZED output buffer
                    # (finding_collection.rs:55,183,203-205), so main
                    # bytes past the decode read as NUL - a fresh
                    # decode that runs ahead into NUL chars still
                    # matches Exact.
                    ref_prefix += b"\x00" * (len(fresh) - len(ref_prefix))
                    if len(fresh) == 0 or ref_prefix[: len(fresh)] != fresh:
                        precision = PRECISION_BEFORE

            if pending is not None:
                chars = list(pending) + call_chars
                precision = PRECISION_BEFORE
                pending = None
            else:
                chars = call_chars

            continue_str = state["flag"]
            flag = False

            for chunk in split_str(
                chars,
                m.chars_min_nb,
                m.require_same_unicode_block,
                continue_str,
                invalid_after,
                m.filter,
                m.output_line_char_nb_max,
            ):
                if not chunk.s_is_to_be_filtered_again:
                    findings.append(
                        Finding(
                            input_file_id=input_file_id,
                            mission=m,
                            # ByteCounter is u64 (input.rs:16); release
                            # Rust wraps mod 2^64 when -s pushes it
                            # past the max.
                            position=(base + call_label) & _U64_MASK,
                            position_precision=precision,
                            s=encode_utf8(chars[chunk.start : chunk.end]),
                            s_completes_previous_s=chunk.s_completes_previous_s,
                        )
                    )
                    pending = None
                    flag = chunk.s_is_maybe_cut
                else:
                    pending = chars[chunk.start : chunk.end]
                    flag = False
                precision = PRECISION_AFTER

            state["pending"] = pending
            state["flag"] = flag

        ws = 0
        while ws < slice_len:
            we = min(ws + w, slice_len)
            is_last_window = we == slice_len

            while True:  # decode calls within this window
                call_label = label
                call_chars: List[int] = []
                mal: Optional[int] = None
                while ei < ei_end:
                    r = int(events.report[ei]) - slice_stream_start
                    if r >= we:
                        break
                    if int(events.cp[ei]) < 0:
                        mal = ei
                        ei += 1
                        break
                    call_chars.append(int(events.cp[ei]))
                    ei += 1

                ended_by_malformed = mal is not None
                invalid_after = ended_by_malformed or (
                    is_last_window and is_last_input_buffer
                )
                process_call(call_label, call_chars, invalid_after)

                if not ended_by_malformed:
                    break  # InputEmpty: window consumed
                # Advance the label past the malformed sequence
                # (mirrors decoder_input_start += decoder_read with the
                # rewind/pushback rules; see events.py docstring).
                e = mal
                cand = int(events.pos[e]) + int(events.in_len[e]) - slice_stream_start
                if cand >= label:
                    label = cand
                else:
                    label = max(label, cand + int(events.pushback[e]))

            label = we
            ws = we

        if is_last_input_buffer and slice_len > 0:
            # The extra flush round (finding_collection.rs:141,298-305):
            # one more decode call with `last=true`. It consumes the
            # continuation flag and re-filters any pending leftover with
            # invalid_bytes_after set.
            process_call(label, [], True)

        # Write back carry state (finding_collection.rs:329-338).
        st.leftover_cps = state["pending"] if state["pending"] is not None else []
        st.last_printed_maybe_cut = state["flag"]
        st.consumed_bytes = (st.consumed_bytes + slice_len) & _U64_MASK
        return findings
