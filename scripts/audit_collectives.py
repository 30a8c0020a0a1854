"""Audit the compiled sharded programs' cross-shard communication.

Machine-checks the claim that the ONLY cross-shard communication in
the mesh scan is the neighbor ppermute halo exchange
(SURVEY.md section 5 long-context row: halo exchange is the designed-in
only comm; the byte stream must never be all-gathered).

For each (program, device count) it compiles on a virtual CPU mesh,
walks the post-optimization HLO, and asserts:
  1. no all-gather / all-reduce / all-to-all / reduce-scatter /
     ragged-all-to-all appears anywhere;
  2. every collective-permute's source_target_pairs are data-axis
     NEIGHBORS (|src - tgt| == 1 within one data row of the mesh).

Programs audited:
  - parallel.mesh.build_sharded_counts (the flagship fused SWAR counts
    pass) at 8 and 16 data shards;
  - parallel.mesh.build_sharded_scan (lanes + run-table extraction,
    2-D data x mission mesh) at 4x2 and 8x2.

Prints one JSON line with the per-program results.

Usage: python scripts/audit_collectives.py
"""

import json
import os
import re
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=16"
)

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FORBIDDEN = (
    "all-gather", "all-reduce", "all-to-all", "reduce-scatter",
    "ragged-all-to-all",
)

_PAIRS_RE = re.compile(r"source_target_pairs=\{((?:\{\d+,\d+\},?)+)\}")
_PAIR_RE = re.compile(r"\{(\d+),(\d+)\}")
_AG_SHAPE_RE = re.compile(
    r"=\s+\(?\s*\S*?\[([\d,]*)\]\S*\s+all-gather(?:-start)?\(")


def audit_hlo(hlo: str, n_data: int, n_mission: int = 1,
              state_gather_budget_elems: int = 0):
    """Returns a findings dict for one compiled module.

    `state_gather_budget_elems` > 0 permits all-gathers whose RESULT is
    at most that many elements: the chain-kind scan programs (CJK /
    ISO-2022-JP) gather a few ints of entry-phase/mode transfer state
    per shard (parallel/mesh.py stages A and C) - O(n_data) scalars,
    never the byte stream. Stream-sized all-gathers remain forbidden."""
    forbidden_hits = {}
    small_gathers = []
    for op in FORBIDDEN:
        # op names appear as '%all-gather.12 = ...' or ' all-gather('
        hits = len(re.findall(rf"\b{re.escape(op)}(?:-start)?\b[.(]", hlo))
        if not hits:
            continue
        if op == "all-gather" and state_gather_budget_elems > 0:
            shapes = []
            for m in _AG_SHAPE_RE.finditer(hlo):
                dims = [int(d) for d in m.group(1).split(",") if d]
                elems = 1
                for d in dims:
                    elems *= d
                shapes.append(elems)
            if len(shapes) < hits:
                # FAIL CLOSED: fewer parsed result shapes than matched
                # instructions (e.g. tuple-shaped async all-gather-
                # start forms the regex cannot parse) - report the
                # unparsed remainder rather than silently passing a
                # possibly stream-sized collective.
                forbidden_hits[op] = (
                    f"{hits - len(shapes)} of {hits} hits with "
                    f"UNPARSED result shapes")
                continue
            big = [e for e in shapes if e > state_gather_budget_elems]
            small_gathers = [e for e in shapes
                             if e <= state_gather_budget_elems]
            if big:
                forbidden_hits[op] = f"{len(big)} over budget: {big}"
            continue
        forbidden_hits[op] = hits
    permutes = []
    non_neighbor = []
    for m in _PAIRS_RE.finditer(hlo):
        pairs = [(int(a), int(b)) for a, b in _PAIR_RE.findall(m.group(1))]
        permutes.append(pairs)
        for a, b in pairs:
            # device ids enumerate the mesh row-major (data, mission):
            # neighbors on the data axis differ by n_mission and share
            # the mission coordinate
            da, ma = divmod(a, n_mission)
            db, mb = divmod(b, n_mission)
            if ma != mb or abs(da - db) != 1:
                non_neighbor.append((a, b))
    out = {
        "collective_permutes": len(permutes),
        "permute_pair_sets": [
            f"{len(p)} pairs, max|d|={max(abs(a - b) for a, b in p)}"
            for p in permutes
        ],
        "forbidden_collectives": forbidden_hits,
        "non_neighbor_pairs": non_neighbor,
        "ok": not forbidden_hits and not non_neighbor and len(permutes) > 0,
    }
    if small_gathers:
        out["state_all_gather_elems"] = small_gathers
    return out


def compiled_text(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def main():
    from stringsext_tpu.mission import Missions
    from stringsext_tpu.ops.swar import swar_params
    from stringsext_tpu.parallel import mesh as pmesh

    ms = Missions.new(flag_encoding=["UTF-8", "utf-16le", "utf-16be"])
    p = swar_params(ms.v)
    specs = (
        ("utf8", p["af_iv"], p["ubf_iv"], p["greps"][0]),
        ("utf16", False, p["cp_iv_le"], p["greps"][1]),
        ("utf16", True, p["cp_iv_be"], p["greps"][2]),
    )

    results = {}
    shard_rows = 16

    for n_data in (8, 16):
        m = pmesh.make_mesh(n_data, 1)
        step = pmesh.build_sharded_counts(specs, m, shard_rows=shard_rows)
        words = np.zeros((n_data * shard_rows, 128), np.int32)
        hlo = compiled_text(step, words)
        r = audit_hlo(hlo, n_data, 1)
        results[f"counts_{n_data}dev"] = r
        print(f"counts @ {n_data} devices: "
              f"{'OK' if r['ok'] else 'FAIL'} {r}")

    shard_len = 4096
    for n_data, n_mission in ((4, 2), (8, 2)):
        m = pmesh.make_mesh(n_data, n_mission)
        step = pmesh.build_sharded_scan(
            ms.v[:2], m, shard_len=shard_len, capacity=128
        )
        data = np.zeros(n_data * shard_len, np.uint8)
        hlo = compiled_text(step, data)
        r = audit_hlo(hlo, n_data, n_mission)
        results[f"scan_{n_data}x{n_mission}dev"] = r
        print(f"scan @ {n_data}x{n_mission} devices: "
              f"{'OK' if r['ok'] else 'FAIL'} {r}")

    # Chain-kind scan (CJK + modal ISO-2022-JP): the entry-phase/state
    # transfer composition all-gathers a few ints per shard (stages A
    # and C of parallel/mesh.build_sharded_scan). Those O(n_data)-elem
    # gathers are the designed-in exception; stream-sized collectives
    # stay forbidden and halos stay neighbor ppermute.
    ms_cjk = Missions.new(
        flag_encoding=["shift_jis", "gb18030", "euc-jp", "ISO-2022-JP"])
    for n_data, n_mission in ((2, 4), (4, 4)):
        m = pmesh.make_mesh(n_data, n_mission)
        step = pmesh.build_sharded_scan(
            ms_cjk.v, m, shard_len=shard_len, capacity=128
        )
        data = np.zeros(n_data * shard_len, np.uint8)
        hlo = compiled_text(step, data)
        r = audit_hlo(hlo, n_data, n_mission,
                      state_gather_budget_elems=n_data * 16)
        results[f"scan_allkinds_{n_data}x{n_mission}dev"] = r
        print(f"all-kinds scan @ {n_data}x{n_mission} devices: "
              f"{'OK' if r['ok'] else 'FAIL'} {r}")

    all_ok = all(r["ok"] for r in results.values())
    print(json.dumps({"collective_audit": results, "all_ok": all_ok}))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
