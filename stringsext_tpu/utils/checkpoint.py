"""Checkpoint / resume for long scans.

The reference has no checkpointing; its closest feature is
`--counter-offset` (options.rs:78-80, mission.rs:388-394), i.e. manual
resume by byte offset when a huge input was split across runs. This
build gets real resume by checkpointing each mission's carry state
(SURVEY.md section 5): `(consumed_bytes, decode cursor, leftover chars,
continuation flag)` - everything the emission automaton needs to
continue mid-stream with bit-identical output.

State format: JSON, one entry per mission keyed by mission_id, plus the
stream offset where scanning should resume.
"""

from __future__ import annotations

import json
from typing import List

from ..mission import Missions


def state_to_dict(mission_states: List[dict], next_slice: int) -> dict:
    return {
        "version": 1,
        "next_slice": next_slice,
        "missions": [
            {
                "consumed": int(st["consumed"]),
                "cursor": int(st.get("cursor", 0)),
                "printed_maybe_cut": bool(st.get("printed_maybe_cut", False)),
                "dec_mode": int(st.get("dec_mode", 0)),
                "dec_output_flag": bool(st.get("dec_output_flag", False)),
                "leftover_cps": list(map(int, st.get("leftover_cps", []))),
            }
            for st in mission_states
        ],
    }


def save_checkpoint(path: str, mission_states: List[dict], next_slice: int) -> None:
    """Atomic write (temp + rename): a crash mid-dump must never
    destroy the previous good checkpoint - surviving crashes is the
    whole point of checkpointing."""
    _atomic_dump(path, state_to_dict(mission_states, next_slice))


def _atomic_dump(path: str, payload: dict) -> None:
    import os

    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_checkpoint(path: str, expected_missions: int | None = None) -> dict:
    with open(path) as f:
        d = json.load(f)
    if d.get("version") not in (1, 2):
        raise ValueError(f"unsupported checkpoint version in {path}")
    if expected_missions is not None and len(d.get("missions", [])) != expected_missions:
        raise ValueError(
            f"checkpoint {path} holds {len(d.get('missions', []))} mission "
            f"states but the current scan has {expected_missions} - resume "
            "must use the same -e mission set"
        )
    return d


# --- v2: the CLI streaming checkpoint (`--checkpoint FILE`). Besides
# the per-mission carry states it records everything the chunk loop
# holds between chunks: the absolute stream read offset, the
# unconsumed tail bytes (cursor-rebased carry), and the boundary-
# position findings held back one chunk for merge-order stability.


def _ser_held(held) -> list:
    import base64

    out = []
    for row in held:
        i, _m, res, sb = row[:4]
        strings = [
            base64.b64encode(
                sb[int(o):int(o) + int(ln)]
            ).decode("ascii")
            for o, ln in zip(res["str_off"].tolist(), res["str_len"].tolist())
        ]
        out.append({
            "mission": int(i),
            "position": [int(v) for v in res["position"]],
            "precision": [int(v) for v in res["precision"]],
            "completes": [int(v) for v in res["completes"]],
            "file_id": [int(v) for v in res["file_id"]],
            "strings": strings,
        })
    return out


def _deser_held(rows, missions):
    import base64

    import numpy as np

    held = []
    for r in rows:
        payloads = [base64.b64decode(s) for s in r["strings"]]
        sb = b"".join(payloads)
        lens = np.array([len(p) for p in payloads], np.uint32)
        offs = np.zeros(len(payloads), np.uint64)
        if len(payloads):
            offs[1:] = np.cumsum(lens.astype(np.uint64))[:-1]
        res = {
            "position": np.array(r["position"], np.uint64),
            "precision": np.array(r["precision"], np.int8),
            "completes": np.array(r["completes"], np.uint8),
            "file_id": np.array(r["file_id"], np.int32),
            "str_off": offs,
            "str_len": lens,
        }
        i = int(r["mission"])
        held.append((i, missions.v[i], res, sb, None))
    return held


def _mission_fingerprint(missions: Missions) -> list:
    """Everything that determines a mission's observable scan behavior
    (mission.rs:382-421): resuming under a DIFFERENT mission set would
    silently seed the wrong decoders with carried state."""
    return [
        {
            "encoding": m.encoding_name,
            "display": m.display_encoding_name,
            "chars_min": int(m.chars_min_nb),
            "same_block": bool(m.require_same_unicode_block),
            "af": f"{m.filter.af:#x}",
            "ubf": f"{m.filter.ubf:#x}",
            "grep": m.filter.grep_char,
            "line_max": int(m.output_line_char_nb_max),
            "counter_offset": int(m.counter_offset),
        }
        for m in missions.v
    ]


def save_stream_checkpoint(
    path: str, mission_states: List[dict], stream_pos: int,
    carry: bytes, held, missions: Missions | None = None,
    out_pos: int | None = None, out_id: list | None = None,
) -> None:
    import base64

    d = state_to_dict(mission_states, 0)
    d["version"] = 2
    del d["next_slice"]
    d["stream_pos"] = int(stream_pos)
    d["carry"] = base64.b64encode(bytes(carry)).decode("ascii")
    d["held"] = _ser_held(held or [])
    if missions is not None:
        d["mission_fingerprint"] = _mission_fingerprint(missions)
    if out_pos is not None:
        # bytes of output already emitted for the checkpointed prefix:
        # resume truncates a seekable output here, so a crash landing
        # between a chunk's emit and its checkpoint save cannot
        # duplicate that chunk's lines (exactly-once for file outputs)
        d["out_pos"] = int(out_pos)
    if out_id is not None:
        # (st_dev, st_ino) of the output file: resume refuses to
        # truncate a DIFFERENT file at out_pos (which would destroy
        # the tail of an unrelated pre-existing file).
        d["out_id"] = [int(v) for v in out_id]
    _atomic_dump(path, d)


def load_stream_checkpoint(path: str, missions: Missions):
    """Returns (states, stream_pos, carry_bytes, held) or raises."""
    import base64

    d = load_checkpoint(path, len(missions.v))
    if d["version"] != 2:
        raise ValueError(
            f"checkpoint {path} is not a stream checkpoint (version 2)"
        )
    saved_fp = d.get("mission_fingerprint")
    if saved_fp is not None and saved_fp != _mission_fingerprint(missions):
        raise ValueError(
            f"checkpoint {path} was written by a different mission "
            "configuration (encodings/filters/flags differ) - resume "
            "must use the same command line"
        )
    states = [
        {
            "consumed": int(st["consumed"]),
            "cursor": int(st["cursor"]),
            "printed_maybe_cut": bool(st["printed_maybe_cut"]),
            "dec_mode": int(st.get("dec_mode", 0)),
            "dec_output_flag": bool(st.get("dec_output_flag", False)),
            "leftover_cps": list(map(int, st.get("leftover_cps", []))),
        }
        for st in d["missions"]
    ]
    carry = base64.b64decode(d["carry"])
    held = _deser_held(d["held"], missions)
    out_pos = d.get("out_pos")
    return states, int(d["stream_pos"]), carry, held, out_pos, d.get("out_id")


def fresh_states(missions: Missions) -> List[dict]:
    return [
        {
            "consumed": m.counter_offset,
            "cursor": 0,
            "printed_maybe_cut": False,
            "dec_mode": 0,
            "dec_output_flag": False,
            "leftover_cps": [],
        }
        for m in missions
    ]
