"""Orchestration: scan the stream with all missions, merge, print.

Parity reference: /root/reference/src/main.rs::run() (main.rs:93-175).

The reference runs one OS thread per mission in lock-step over 4 KiB
slices, with a merger thread k-merging each batch. Here the heavy
per-byte work happens up-front as data-parallel event generation (one
pass per *distinct encoding*, on the device when available - mission
parallelism comes free since missions share event streams), and the
per-slice emission automaton + merge run on the host.
"""

from __future__ import annotations

import sys
from heapq import merge as heapq_merge
from typing import Dict, IO, List, Optional

from .engine.automaton import SliceScanner
from .engine.events import Events, generate_events
from .finding import Finding
from .input import LoadedStream, load_stream
from .mission import Missions
from .options import Args


def scan_stream(
    stream: LoadedStream,
    missions: Missions,
    event_backend: str = "numpy",
) -> "list[Finding]":
    """Scan the whole stream; returns findings in output order."""
    findings_batches = scan_stream_batches(stream, missions, event_backend)
    out: List[Finding] = []
    for batch in findings_batches:
        out.extend(batch)
    return out


def _generate_all_events(
    stream: LoadedStream, missions: Missions, event_backend: str
) -> Dict[str, Events]:
    """One decode pass per distinct encoding (shared by missions)."""
    events_by_encoding: Dict[str, Events] = {}
    for m in missions:
        if m.encoding_name not in events_by_encoding:
            if event_backend == "device":
                from .ops import device_events

                events_by_encoding[m.encoding_name] = device_events.generate_events_device(
                    stream.data, m.encoding_name
                )
            else:
                events_by_encoding[m.encoding_name] = generate_events(
                    stream.data, m.encoding_name
                )
    return events_by_encoding


def scan_stream_batches(
    stream: LoadedStream,
    missions: Missions,
    event_backend: str = "numpy",
):
    """Yield per-slice batches of merged findings (main.rs:118-136: the
    merger collects one FindingCollection per mission per slice and
    kmerges them)."""
    events_by_encoding = _generate_all_events(stream, missions, event_backend)
    scanners = [SliceScanner(m) for m in missions]

    for sl in stream.slices():
        per_mission: List[List[Finding]] = []
        for sc in scanners:
            ev = events_by_encoding[sc.mission.encoding_name]
            per_mission.append(
                sc.scan_slice(
                    sl.data, sl.stream_start, ev, sl.input_file_id, sl.is_last
                )
            )
        # k-way merge with the reference's comparison key
        # (finding.rs:92-109); per-mission lists are already sorted.
        yield list(heapq_merge(*per_mission, key=lambda f: f.sort_key()))


_HOT_BLOCK = 512  # hot-map granularity (one SWAR compaction block)

_WARNED: set = set()


def _feed_enabled() -> bool:
    """Device run-table feed gate: DEFAULT ON under engine=device (the
    device-first execution model is the default, not an opt-in - the
    native emitter transparently falls back per window for
    lane-ineligible configs, and overflow/unsupported cases degrade to
    the hot-map path). The feed classifies in bounded windows
    (ops/device_events._FEED_PIECE), so it runs at any input size.
    STRINGSEXT_RUNTABLE_FEED=0 is the escape hatch; =1 remains accepted
    from when it was the opt-in."""
    import os

    return os.environ.get("STRINGSEXT_RUNTABLE_FEED", "1") != "0"


def _warn_once(key, msg: str) -> None:
    """One-shot stderr warning for silent-degradation events (the
    reference warns on its only lossy path the same way,
    finding_collection.rs:311-317). Output on stdout is unaffected;
    these surface when a fast path quietly fell back to a slower one.
    `run()` clears the set on entry, so in library use every run()
    gets its own warnings (not just the first in the process)."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    print(msg, file=sys.stderr)


# ---------------------------------------------------------------------------
# engine=auto accelerator probe: pick the device path when it can win
# ---------------------------------------------------------------------------

_PROBE_BW_MIN = 2e9  # bytes/s effective H2D+compute+fetch bandwidth
_PROBE_LAT_MAX = 0.05  # seconds per tiny dispatch+fetch round trip
_PROBE_ERROR_TTL = 300.0  # seconds a failed probe's host verdict is reused


def _engine_name(engine: str) -> str:
    """Canonical engine name: "tpu" is the old name of "device" and
    stays accepted wherever an engine is passed in."""
    return "device" if engine == "tpu" else engine


def _link_measurement() -> dict:
    """Measure the device link from THIS process: dispatch+fetch round
    trip latency and the rate of an 8 MiB host->device copy plus a tiny
    reduction fetched back. Returns bw_bytes_s/rt_lat_s/device, or
    {"platform": "cpu"} when JAX finds no accelerator."""
    import time

    import numpy as np

    import jax
    import jax.numpy as jnp

    devs = jax.devices()
    if not devs or devs[0].platform == "cpu":
        return {"platform": "cpu"}
    one = jnp.ones((), jnp.int32)
    int(one + 1)  # compile + first dispatch
    t0 = time.perf_counter()
    for _ in range(3):
        int(one + 1)
    lat = (time.perf_counter() - t0) / 3
    buf = np.zeros(8 << 20, np.uint8)
    x = jax.device_put(buf)
    int(jnp.sum(x[::4096].astype(jnp.int32)))
    t0 = time.perf_counter()
    x = jax.device_put(buf)
    int(jnp.sum(x[::4096].astype(jnp.int32)))
    bw = len(buf) / max(time.perf_counter() - t0, 1e-9)
    return {"bw_bytes_s": bw, "rt_lat_s": lat, "device": str(devs[0]),
            "platform": devs[0].platform}


def _probe_main() -> None:
    """Entry point of the probe child: one JSON line on stdout."""
    import json

    try:
        m = _link_measurement()
    except Exception as e:
        m = {"error": f"{type(e).__name__}: {e}"}
    print(json.dumps(m))


def _probe_verdict(bw_bytes_s: float, rt_lat_s: float) -> bool:
    """True iff the measured link supports the device execution model:
    a co-located accelerator sees multi-GB/s H2D and sub-ms dispatch; a
    remote device misses both by orders of magnitude, and the host
    emitter (hundreds of MB/s) then beats shipping bytes to it."""
    return bw_bytes_s >= _PROBE_BW_MIN and rt_lat_s <= _PROBE_LAT_MAX


def _accel_plausible() -> bool:
    """Cheap accelerator-presence signals - NO jax import (scan-only
    runs never pay the jax import; a probe only runs when one of these
    fires and no cached verdict exists)."""
    import glob
    import os

    if glob.glob("/dev/nvidia[0-9]*") or os.path.exists("/dev/kfd"):
        return True
    plat = (os.environ.get("JAX_PLATFORMS")
            or os.environ.get("JAX_PLATFORM_NAME") or "").lower()
    return any(k in plat for k in ("gpu", "cuda", "rocm"))


def _live_accelerator_backend() -> bool:
    """True iff this process already initialized a JAX backend whose
    default device is an accelerator. Never initializes one itself."""
    jax = sys.modules.get("jax")
    if jax is None:
        return False
    try:
        from jax._src import xla_bridge

        return bool(xla_bridge._backends) and jax.default_backend() != "cpu"
    except Exception:
        return False


def _probe_cache_path() -> str:
    import os

    return os.environ.get("STRINGSEXT_PROBE_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "stringsext-tpu",
        "device_probe.json",
    )


def _measure_device_link():
    """Measure the link. A process that already holds an accelerator
    backend (library use) measures in-process, so no second process
    tries to reserve the card. Otherwise the measurement runs in a
    SUBPROCESS with a hard timeout - JAX init against a hung device can
    block for minutes, and a host verdict must not initialize JAX in
    this process at all - without preallocating device memory. Returns
    a dict with bw_bytes_s/rt_lat_s/device, {"platform": "cpu"}, or an
    error key."""
    import json
    import os
    import subprocess

    if _live_accelerator_backend():
        try:
            return _link_measurement()
        except Exception as e:
            return {"error": f"{type(e).__name__}: {e}"}
    try:
        timeout = float(os.environ.get("STRINGSEXT_PROBE_TIMEOUT", "30"))
    except ValueError:
        timeout = 30.0
    pkg_parent = os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, XLA_PYTHON_CLIENT_PREALLOCATE="false")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_parent, env.get("PYTHONPATH")) if p)
    try:
        r = subprocess.run(
            [sys.executable, "-c",
             "from stringsext_tpu.run import _probe_main; _probe_main()"],
            capture_output=True, timeout=timeout, text=True, env=env,
        )
        line = (r.stdout or "").strip().splitlines()
        if line:
            return json.loads(line[-1])
        err = (r.stderr or "").strip().splitlines()
        return {"error": err[-1] if err else f"probe exited {r.returncode}"}
    except subprocess.TimeoutExpired:
        return {"error": f"probe timed out after {timeout:.0f}s"}
    except Exception as e:
        return {"error": str(e)}


def _probe_failed(error: str) -> str:
    """Report a failed probe on stderr; the run takes the host engine."""
    print(f"Warning: accelerator probe failed ({error}); using the host "
          f"engine. --engine device forces the device path, "
          f"STRINGSEXT_DEVICE_PROBE=1 probes again now, "
          f"STRINGSEXT_DEVICE_PROBE=0 skips the probe.", file=sys.stderr)
    return "auto"


def _auto_engine() -> str:
    """Resolve engine=auto: "device" when a co-located accelerator
    whose link can beat the host path is attached, "auto" (host native)
    otherwise - so a fresh CLI on an accelerator machine uses the
    device with zero flags. The measurement runs at most once per
    machine (verdict cached in ~/.cache/stringsext-tpu/
    device_probe.json); STRINGSEXT_DEVICE_PROBE=0 pins the host path,
    =1 forces a re-measure. A failed probe is cached for
    _PROBE_ERROR_TTL seconds only - so a card that keeps failing costs
    one probe per TTL, not one per run - and every run that uses the
    cached failure prints it again."""
    import json
    import os
    import time

    mode = os.environ.get("STRINGSEXT_DEVICE_PROBE", "")
    if mode == "0":
        return "auto"
    cache = _probe_cache_path()
    if mode != "1":
        try:
            with open(cache) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            doc = None
        if isinstance(doc, dict) and "error" in doc:
            try:
                age = time.time() - float(doc.get("time", 0))
            except (TypeError, ValueError):
                age = _PROBE_ERROR_TTL
            if 0 <= age < _PROBE_ERROR_TTL:
                return _probe_failed(doc["error"])
        elif isinstance(doc, dict):
            if _engine_name(doc.get("verdict", "")) != "device":
                return "auto"
            # The cache is per-machine but jax is per-interpreter: a
            # verdict measured from a jax-equipped venv must not crash
            # a jax-less install (e.g. the .deb, which only depends on
            # python3-numpy) - honor it only when this interpreter can
            # actually import jax.
            import importlib.util

            if importlib.util.find_spec("jax") is None:
                return "auto"
            return "device"
        if not _accel_plausible():
            return "auto"
    m = _measure_device_link()
    if "error" in m:
        doc = {"verdict": "auto", "error": m["error"]}
    elif "bw_bytes_s" in m:
        ok = _probe_verdict(m["bw_bytes_s"], m["rt_lat_s"])
        doc = {"verdict": "device" if ok else "auto", **m}
    else:  # JAX sees no accelerator: a measured host verdict
        doc = {"verdict": "auto", **m}
    doc["time"] = time.time()
    try:
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        tmp = cache + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, cache)
    except OSError:
        pass
    if "error" in doc:
        return _probe_failed(doc["error"])
    return doc["verdict"]


def _merge_ranges(starts, ends, n):
    """Merge possibly-overlapping (starts, ends) intervals, clipped to
    [0, n]. Returns sorted disjoint int64 arrays."""
    import numpy as np

    if len(starts) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.argsort(starts, kind="stable")
    s = starts[order]
    e = np.maximum.accumulate(ends[order])  # running max end
    new_group = s[1:] > e[:-1]  # vectorized interval merge
    first = np.concatenate([[True], new_group])
    last = np.concatenate([new_group, [True]])
    return np.maximum(s[first], 0), np.minimum(e[last], n)


_MESH_COUNTS_CACHE = {}

# Default missions per fused hot-map launch; --hot-group /
# STRINGSEXT_HOT_GROUP override it (0: all in one launch). On an H100 the 41-spec
# all-encodings set at a 32 MiB chunk ran in two launches of <= 24 in
# about half the time of one launch of 41: XLA splits the one large
# fusion into more passes over the chunk.
_HOT_GROUP_DEFAULT = 24


def _mesh_counts(w2, specs, ndev):
    """One chunk's hot-only counts pass sharded over an ndev-wide
    "data" mesh (parallel/mesh.build_sharded_counts: ppermute halos,
    bit-exact vs the single-device pass). Pads the word panel to ndev
    equal shards - zero rows beyond the real ones give the same
    real-block counts as the single-device pass - and splices the
    per-shard count panels back together."""
    import jax.numpy as jnp

    from .ops.swar import HALO_ROWS
    from .parallel.mesh import build_sharded_counts, make_mesh

    rows = w2.shape[0]
    shard_rows = max(HALO_ROWS, -(-rows // ndev))
    padded = ndev * shard_rows
    if padded != rows:
        w2 = jnp.concatenate(
            [w2, jnp.zeros((padded - rows, w2.shape[1]), jnp.int32)]
        )
    key = (specs, ndev, shard_rows)
    fn = _MESH_COUNTS_CACHE.get(key)
    if fn is None:
        if len(_MESH_COUNTS_CACHE) >= 16:
            # Bounded: long-lived library processes scanning many
            # distinct mission sets must not grow this without limit
            # (each entry pins a compiled sharded function).
            _MESH_COUNTS_CACHE.pop(next(iter(_MESH_COUNTS_CACHE)))
        fn = build_sharded_counts(
            specs, make_mesh(ndev, 1), shard_rows, hot_only=True,
        )
        _MESH_COUNTS_CACHE[key] = fn
    out = fn(w2)  # [ndev, R, shard_rows]
    return jnp.swapaxes(out, 0, 1).reshape(out.shape[1], -1)[:, :rows]


def _hot_groups(jobs):
    """Split the hot-map jobs into fused launches of at most
    --hot-group / STRINGSEXT_HOT_GROUP missions (default
    _HOT_GROUP_DEFAULT)."""
    import os

    cap_env = os.environ.get("STRINGSEXT_HOT_GROUP")
    cap = int(cap_env) if cap_env else _HOT_GROUP_DEFAULT
    if not cap or cap >= len(jobs):
        return [jobs]
    return [jobs[i:i + cap] for i in range(0, len(jobs), cap)]


def _device_hot_ranges_swar(stream: LoadedStream, jobs,
                            chunk: int = 32 * 1024 * 1024,
                            pad_to: int = 0):
    """Hot byte ranges for every SWAR-able mission at once, from the
    fused counts pass's per-512-byte-block accept counts.

    Exact run tables are NOT extracted: a block is hot iff any accepted
    char starts in it, which (with an 8-byte spill margin) is already a
    superset of every finding - the exactness the emitter needs. This
    removes the run-table capacity/overflow fallback entirely. Hot-only
    passes skip the run-boundary algebra, so missions of ANY kind fuse
    into a few launches per chunk (see _hot_groups).

    `jobs` is [(mission_index, swar_mission_spec)]. Returns
    {mission_index: (starts, ends)} sorted disjoint int64 arrays."""
    import os

    import numpy as np

    import jax
    import jax.numpy as jnp

    from .ops.swar import swar_counts
    from .utils import profiling

    n = len(stream.data)
    groups = _hot_groups(list(jobs))

    # Multi-device: shard each chunk's counts pass over the "data" mesh
    # axis (ppermute halos; bit-exact vs the single-device pass). Opt-in
    # with --mesh / STRINGSEXT_MESH=1: on four H100s the CLI has so far
    # run slower with the mesh than on one card.
    ndev = jax.device_count()
    use_mesh = ndev > 1 and os.environ.get("STRINGSEXT_MESH") == "1"

    def counts_fn(w2, specs_t):
        if not use_mesh:
            return swar_counts(w2, specs_t, hot_only=True)
        return _mesh_counts(w2, specs_t, ndev)

    launched = []
    pos = 0
    while pos < n:
        m_end = min(pos + chunk, n)
        raw = stream.data[pos:m_end]
        # Pad to a power-of-two number of 512-byte blocks (at least 8),
        # capped at the chunk: few distinct shapes, so few compiles.
        # `pad_to` pins the padded size (streaming passes the steady
        # chunk size so the short TAIL chunk reuses the compiled shape;
        # pad bytes are zeros and the collector clips to real blocks).
        eff = max(len(raw), min(pad_to, chunk))
        padded = 8 * _HOT_BLOCK
        while padded < eff:
            padded *= 2
        padded = min(padded, -(-chunk // _HOT_BLOCK) * _HOT_BLOCK)
        padded = max(padded, -(-eff // _HOT_BLOCK) * _HOT_BLOCK)
        buf = np.zeros(padded, np.uint8)
        buf[: len(raw)] = raw
        w2 = jnp.asarray(buf.view(np.int32).reshape(-1, 128))
        with profiling.scope("device.dispatch", len(raw)):
            for grp in groups:
                counts = counts_fn(w2, tuple(sp for _, sp in grp))
                launched.append((pos, m_end, [
                    (grp[j], (counts[2 * j] >> 20) > 0)
                    for j in range(len(grp))
                ]))
        pos = m_end

    raw_ranges = {idx: [] for idx, _sp in jobs}
    for pos, m_end, job_hots in launched:
        nblocks = -(-(m_end - pos) // _HOT_BLOCK)
        for (idx, _sp), h in job_hots:
            with profiling.scope("device.collect"):
                hb = np.asarray(h)[:nblocks].copy()
            if len(hb):
                # chunk-edge blocks are always hot: boundary-spanning
                # chars cross them.
                hb[0] = True
                hb[-1] = True
            d = np.diff(hb.astype(np.int8), prepend=0, append=0)
            s_blk = np.flatnonzero(d == 1).astype(np.int64)
            e_blk = np.flatnonzero(d == -1).astype(np.int64)
            raw_ranges[idx].append(
                (pos + s_blk * _HOT_BLOCK - 8, pos + e_blk * _HOT_BLOCK + 8)
            )

    out = {}
    for idx, parts in raw_ranges.items():
        s = np.concatenate([p[0] for p in parts])
        e = np.concatenate([p[1] for p in parts])
        out[idx] = _merge_ranges(s, e, n)
    return out


def _device_hot_ranges(stream: LoadedStream, mission, chunk: int = 8 * 1024 * 1024):
    """Compute conservative 'hot' byte ranges (superset of all accepted
    char runs) for one mission with the device scan kernels, processing
    the stream in chunks. Chunk edges are force-marked hot so chunk-
    local classification can never exclude a boundary-spanning char.
    Returns (starts, ends) sorted disjoint int64 arrays, or None when
    the encoding has no device kernel.

    Fallback path for encodings without a SWAR spec; SWAR-able missions
    go through _device_hot_ranges_swar (no run-table extraction)."""
    import numpy as np

    import jax.numpy as jnp

    from .ops import runs as runs_mod
    from .ops.device_events import compute_lanes
    from .utils import profiling

    n = len(stream.data)
    af_w, ubf_w = runs_mod.filter_words(mission)
    g = -1 if mission.filter.grep_char is None else mission.filter.grep_char

    # Double-buffered dispatch (SURVEY.md section 2 "lock-step batch
    # pipeline" analog): launch all chunk scans asynchronously, then
    # collect - H2D of chunk k+1 overlaps the device scan of chunk k.
    launched = []
    pos = 0
    while pos < n:
        m_end = min(pos + chunk, n)
        # Capacity scales with the chunk (and so with its pad bucket,
        # keeping one compile per bucket); overflow falls back to
        # marking the whole chunk hot.
        capacity = int(min(32768, max(1024, (m_end - pos) // 256)))
        with profiling.scope("device.dispatch", m_end - pos):
            lanes = compute_lanes(stream.data[pos:m_end], mission.encoding_name)
            if lanes is None:
                return None
            rt = runs_mod.extract_runs(
                lanes, jnp.asarray(af_w), jnp.asarray(ubf_w), jnp.int32(g),
                capacity=capacity,
            )
        launched.append((pos, m_end, rt))
        pos = m_end

    raw_ranges = []
    for pos, m_end, rt in launched:
        with profiling.scope("device.collect"):
            cnt = int(rt.count)
            overflow = bool(rt.overflow)
        if overflow:
            _warn_once(
                ("runtable-overflow", mission.mission_id),
                f"Warning: device run-table overflow in bytes "
                f"{pos}..{m_end} (mission {mission.mission_id}, "
                f"{mission.encoding_name}); treating the whole chunk as "
                f"hot - output is unaffected, the host rescans it.",
            )
            raw_ranges.append((pos, m_end))  # conservative: all hot
        elif cnt:
            s = np.asarray(rt.start)[:cnt].astype(np.int64) + pos
            e = np.asarray(rt.end)[:cnt].astype(np.int64) + pos
            raw_ranges.append((s, e))
        # chunk seam always hot (boundary-spanning chars)
        if m_end < n:
            raw_ranges.append((m_end - 8, m_end + 8))

    # Flatten, expand by a safety margin, merge.
    starts, ends = [], []
    for item in raw_ranges:
        s, e = item
        starts.append(np.atleast_1d(np.asarray(s, np.int64)))
        ends.append(np.atleast_1d(np.asarray(e, np.int64)))
    if not starts:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return _merge_ranges(
        np.concatenate(starts) - 8, np.concatenate(ends) + 8, n
    )


def _host_hot_ranges(stream: LoadedStream, jobs):
    """Hot byte ranges from a HOST-side prepass - the no-device variant
    of _device_hot_ranges_swar with the same conservative contract
    (ranges are a superset of every finding's bytes; the emitter skips
    everything else and rescans hot ranges exactly).

    Built from the same static mission specs as the device kernels:
    byte-value LUT membership for the utf8/sbyte/CJK-plausible specs (a
    block with no AF-accepted or accepted-lead byte value contains no
    accepted char START; the 8-byte spill margin covers trailing
    continuation bytes, exactly like the device criterion), and an
    exact accepted-unit interval test for UTF-16 (units sit at even
    stream offsets; surrogate ranges are added when the filters reach
    the astral planes so pair units stay hot). numpy does one pass per
    mission at memory bandwidth - ~50x slower than the device kernels
    but it gives engine=auto the skip machinery and segment-parallel
    scanning with no accelerator attached.
    """
    import numpy as np

    from .ops.specs import cjk_hot_spec, swar_mission_spec

    data = stream.data
    n = len(data)
    nb = (n + _HOT_BLOCK - 1) // _HOT_BLOCK
    n_body = (nb - 1) * _HOT_BLOCK if nb else 0  # whole blocks
    out = {}
    # (mission idx, kind-tagged byte LUTs): every mission fuses into
    # ONE table gather below - byte-value membership for the utf8 /
    # single-byte / CJK-plausible / iso-2022-jp specs, and a
    # parity-split block test for UTF-16 (high-byte membership at the
    # unit-high byte parity + the page-0 low-byte test; units sit at
    # even stream offsets, and 512-byte blocks never split a unit).
    fuse_jobs = []
    for i, m in jobs:
        spec = swar_mission_spec(m) or cjk_hot_spec(m)
        if spec is None:
            continue
        kind = spec[0]
        if kind == "utf16":
            # A unit is hot iff its high byte is the high byte of SOME
            # accepted codepoint, or (high byte 0x00) its low byte is
            # an accepted cp < 0x100 - zero-filled gaps stay cold
            # because cp 0x0000 is rejected. At block level this
            # becomes: any(hi member at hi-parity) | (any(0x00 at
            # hi-parity) & any(lo member at lo-parity)) - a superset of
            # the exact per-unit test (the AND decouples), which is all
            # the hot contract needs.
            _k, be, cp_iv, _g = spec
            iv = list(cp_iv)
            if any(hi >= 0x10000 for _lo, hi in iv):
                iv.append((0xD800, 0xDFFF))
            hi_lut = np.zeros(256, bool)
            lo_lut0 = np.zeros(256, bool)
            for lo, hi in iv:
                if lo <= 0xFFFF:
                    hi_lut[max(lo >> 8, 1) : (min(hi, 0xFFFF) >> 8) + 1] = True
                if lo <= 0xFF:
                    lo_lut0[lo : min(hi, 0xFF) + 1] = True
            fuse_jobs.append((i, "u16", (bool(be), hi_lut, lo_lut0)))
        else:
            iv = (spec[1] + spec[2]) if kind == "utf8" else spec[1]
            lut = np.zeros(256, bool)
            for lo, hi in iv:
                lut[lo : hi + 1] = True
            fuse_jobs.append((i, "lut", lut))

    # Fused pass: one bits[data] gather per group, a bit (or three) per
    # mission - separate per-mission passes cost ~#missions x the
    # memory traffic, and the UTF-16 strided gathers are the host's
    # weakest access pattern (the 40-mission sweep spent 96% of its
    # wall here). The per-block even/odd-parity OR masks come from one
    # reshape reduce; small chunks keep the gather output cache-
    # resident for it (measured 1.6x vs 32 MiB chunks).
    def bits_needed(job):
        return 1 if job[1] == "lut" else 2  # u16: hi + lo0 (+shared 0)

    groups = []
    cur, used = [], 1  # bit 0 reserved per group: byte value == 0x00
    for job in fuse_jobs:
        need = bits_needed(job)
        if used + need > 64:
            groups.append(cur)
            cur, used = [], 1
        cur.append(job)
        used += need
    if cur:
        groups.append(cur)

    CH = 2 * 1024 * 1024  # multiple of 2*_HOT_BLOCK; cache-resident
    for grp in groups:
        nbits = 1 + sum(bits_needed(j) for j in grp)
        dt = (np.uint8 if nbits <= 8 else np.uint16 if nbits <= 16
              else np.uint32 if nbits <= 32 else np.uint64)
        bits = np.zeros(256, dt)
        bits[0] |= dt(1)  # shared bit 0: byte value 0x00
        assign = {}
        nxt = 1
        for i, tag, payload in grp:
            if tag == "lut":
                bits[payload] |= dt(1 << nxt)
                assign[i] = (tag, nxt)
                nxt += 1
            else:
                _be, hi_lut, lo_lut0 = payload
                bits[hi_lut] |= dt(1 << nxt)
                bits[lo_lut0] |= dt(1 << (nxt + 1))
                assign[i] = (tag, nxt)
                nxt += 2
        # Per-block OR masks split by byte-position parity.
        blk_ev = np.zeros(nb, dt)
        blk_od = np.zeros(nb, dt)
        pos = 0
        while pos < n_body:
            e = min(pos + CH, n_body)
            per = bits[data[pos:e]]
            r = np.bitwise_or.reduce(
                per.reshape(-1, _HOT_BLOCK // 2, 2), axis=1
            )
            blk_ev[pos // _HOT_BLOCK : e // _HOT_BLOCK] = r[:, 0]
            blk_od[pos // _HOT_BLOCK : e // _HOT_BLOCK] = r[:, 1]
            pos = e
        if n > n_body:
            tail = bits[data[n_body:]]
            blk_ev[nb - 1] = np.bitwise_or.reduce(tail[0::2]) if len(
                tail[0::2]) else dt(0)
            blk_od[nb - 1] = np.bitwise_or.reduce(tail[1::2]) if len(
                tail[1::2]) else dt(0)
        for i, tag, payload in grp:
            kind2, b0 = assign[i]
            if kind2 == "lut":
                hb = (((blk_ev | blk_od) >> dt(b0)) & dt(1)).astype(bool)
            else:
                be = payload[0]
                hi_col, lo_col = (blk_ev, blk_od) if be else (blk_od,
                                                              blk_ev)
                hb = ((hi_col >> dt(b0)) & dt(1)).astype(bool)
                if payload[2].any():
                    hb |= (((hi_col & dt(1)) != 0)
                           & (((lo_col >> dt(b0 + 1)) & dt(1)) != 0))
            if len(hb):
                hb[0] = True
                hb[-1] = True  # stream edges: boundary-spanning carry
            out[i] = _hb_to_ranges(hb, n)
    return out


_SEGMENT_PROBE_MIN = 4 * 1024 * 1024  # probe segmentation size floor
_PROBE_ROW_TRIES = 1024  # rows examined around each balance target


def _iso_entry_modes(data, sl, bounds, initial_mode=0, first_lo=None):
    """ISO-2022-JP segment entry modes from the escape history before
    each split point (cold-quiescent boundaries are event starts with
    output_flag=false; only the MODE carries, and it is a pure function
    of the preceding bytes - engine.align._iso_mode_transfer).
    `first_lo` overrides the first span's start byte (the streaming
    path starts it at the mission's carried cursor, since the carry
    tail can hold an escape that changes the mode before the first
    split)."""
    from .engine.align import _iso_mode_transfer

    entry = [initial_mode] * (len(bounds) - 1)
    mode = initial_mode
    for si, (r0, r1) in enumerate(zip(bounds[:-1], bounds[1:])):
        entry[si] = mode
        lo = (first_lo if si == 0 and first_lo is not None
              else int(sl[0][r0]))
        hi = int(sl[0][r1 - 1] + sl[1][r1 - 1])
        t = _iso_mode_transfer(data[lo:hi])
        if t >= 0:
            mode = t
    return entry


def _concat_segment_parts(parts):
    """Stitch ordered per-segment scan results [(res, strbuf)] into one
    (res, strbuf): concat every column, rebasing str_off into the
    joined strbuf (which is why SE_INREF is off for segmented
    missions)."""
    import numpy as np

    sb = b"".join(p[1] for p in parts)
    off = 0
    cols = {k: [] for k in parts[0][0]}
    for res_p, psb in parts:
        for k, v in res_p.items():
            if k == "str_off":
                v = v + np.uint64(off)
            cols[k].append(v)
        off += len(psb)
    return {k: np.concatenate(v) for k, v in cols.items()}, sb


def _mission_cold_lut(mission):
    """Cold-slice membership test data for one mission: ("lut", lut256)
    where True = the byte CAN belong to / start an accepted char, or
    ("u16", be, hi_lut, lo_lut0) for UTF-16 (the same static spec
    decomposition as _host_hot_ranges). None = no static spec.

    Memoized on the mission object: the streaming path probes every
    chunk, and the spec derivation is not free (gb18030's plausible-
    byte spec walks ~1.09M pointer indices)."""
    cached = getattr(mission, "_cold_lut", False)
    if cached is not False:
        return cached
    import numpy as np

    from .ops.specs import cjk_hot_spec, swar_mission_spec

    spec = swar_mission_spec(mission) or cjk_hot_spec(mission)
    if spec is None:
        val = None
    elif spec[0] == "utf16":
        _k, be, cp_iv, _g = spec
        iv = list(cp_iv)
        if any(hi >= 0x10000 for _lo, hi in iv):
            iv.append((0xD800, 0xDFFF))
        hi_lut = np.zeros(256, bool)
        lo_lut0 = np.zeros(256, bool)
        for lo, hi in iv:
            if lo <= 0xFFFF:
                hi_lut[max(lo >> 8, 1) : (min(hi, 0xFFFF) >> 8) + 1] = True
            if lo <= 0xFF:
                lo_lut0[lo : min(hi, 0xFF) + 1] = True
        val = ("u16", bool(be), hi_lut, lo_lut0)
    else:
        iv = (spec[1] + spec[2]) if spec[0] == "utf8" else spec[1]
        lut = np.zeros(256, bool)
        for lo, hi in iv:
            lut[lo : hi + 1] = True
        val = ("lut", lut)
    object.__setattr__(mission, "_cold_lut", val)  # Mission is frozen
    return val


def _probe_segment_rows(data, sl, mission, kind: str, window_bytes: int,
                        max_segments: int):
    """Cold split points near the byte-balance targets by DIRECT
    byte probing - the DEFAULT segmentation path when no hot map
    exists, so one mission's emitter runs on several cores with zero
    full-stream prepass (VERDICT r4 task 5: segment-parallel scanning
    engages by default under engine=auto).

    Split semantics are _segment_rows' exactly, with a byte-granular
    (strictly stronger) cold test: row r qualifies iff the previous
    slice PLUS an 8-byte lookback (covers chars starting up to 3 bytes
    before it - the hot-map path's block spill margin) contains no byte
    that can belong to an accepted char, the slice is >= two decode
    windows, the per-kind no-span guard holds at the boundary, and CJK
    kinds pass the ground-byte alignment proof. Bounded: at most
    _PROBE_ROW_TRIES rows are examined per target, so the probe touches
    a few MiB, not the stream."""
    import numpy as np

    cold = _mission_cold_lut(mission)
    if cold is None:
        return []
    starts, lens, _f, _l = sl
    n_rows = len(starts)
    if n_rows < 2 or max_segments <= 1:
        return []
    total = int(starts[-1] + lens[-1])

    if kind in _SEGMENT_KINDS_CJK:
        from .engine.align import _cjk_boundary_aligned

        def _aligned(r):
            return _cjk_boundary_aligned(data, 0, int(starts[r]), kind)
    else:
        def _aligned(_r):
            return True

    def _cold_prev(r):
        ps, pl = int(starts[r - 1]), int(lens[r - 1])
        if pl < 2 * window_bytes:
            return False
        lo = max(ps - 8, 0)
        # Cheap prefix reject: on dense data nearly every candidate
        # has a member byte within its first bytes - test 72 bytes
        # before touching the whole slice, so a failed probe costs
        # ~nothing per candidate (the full test below still decides).
        if cold[0] == "lut":
            if cold[1][data[lo : min(lo + 72, ps + pl)]].any():
                return False
        win = data[lo : ps + pl]
        if cold[0] == "lut":
            return not cold[1][win].any()
        _t, be, hi_lut, lo_lut0 = cold
        if lo & 1:  # units pair at even STREAM offsets
            win = win[1:]
        # same cheap prefix reject for the UTF-16 branch: any hi-byte
        # member in the first units rejects without the full pass
        pre = win[:72]
        if hi_lut[pre[1::2] if not be else pre[0::2]].any():
            return False
        ev, od = win[0::2], win[1::2]
        m = min(len(ev), len(od))
        hi, lo8 = (ev[:m], od[:m]) if be else (od[:m], ev[:m])
        if hi_lut[hi].any():
            return False
        if lo_lut0.any() and (hi == 0).any() and lo_lut0[lo8].any():
            return False
        return True

    def _guard(r):
        p = int(starts[r])
        if kind == "utf8":
            b = int(data[min(p, len(data) - 1)])
            return not (0x80 <= b <= 0xBF)
        if kind in ("utf16le", "utf16be"):
            if p % 2:
                return False
            if p >= 2:
                hi_off = 1 if kind == "utf16le" else 2
                hi = int(data[max(p - hi_off, 0)])
                if 0xD8 <= hi <= 0xDB:
                    return False
        return True

    picks = []
    for g in range(1, max_segments):
        target = total * g // max_segments
        r0 = int(np.searchsorted(starts, target))
        found = None
        for d in range(_PROBE_ROW_TRIES):
            for r in (((r0 + d), (r0 - d)) if d else (r0,)):
                if r <= 0 or r >= n_rows:
                    continue
                if _cold_prev(r) and _guard(r) and _aligned(r):
                    found = r
                    break
            if found is not None:
                break
        if found is not None:
            picks.append(found)
    return sorted(set(picks))


def _hb_to_ranges(hb, n):
    import numpy as np

    d = np.diff(hb.astype(np.int8), prepend=0, append=0)
    s_blk = np.flatnonzero(d == 1).astype(np.int64) * _HOT_BLOCK - 8
    e_blk = np.flatnonzero(d == -1).astype(np.int64) * _HOT_BLOCK + 8
    return _merge_ranges(s_blk, e_blk, n)


# Segment-parallel native scanning (engine=device): kinds whose event
# stream provably re-synchronizes at a cold-slice boundary via the
# _quiescent_mask guards alone. The multi-byte CJK kinds and modal
# ISO-2022-JP segment too (round 3), with the extra per-candidate
# checks the distributed shard-boundary search introduced: a
# ground-byte decode-forward alignment proof for CJK
# (engine.align._cjk_boundary_aligned) and, for ISO-2022-JP,
# an entry mode computed from the escape history before the split
# point (its cold slices carry no escapes and no pair phase, see
# ops/specs.cjk_hot_spec, so cold-quiescent boundaries are always
# event starts with output_flag=false).
_SEGMENT_KINDS = ("utf8", "utf16le", "utf16be", "single-byte")
_SEGMENT_KINDS_CJK = ("euc-kr", "big5", "shift_jis", "euc-jp", "gb18030")
_SEGMENT_MAX = None  # None = os.cpu_count(); tests monkeypatch this


def _quiescent_mask(sl, hot, window_bytes: int, data=None,
                    kind: str = "utf8"):
    """bool[n_rows-1]: entry r-1 is True iff an independent scan
    segment may start at slice row r for this mission - the previous
    slice is entirely cold (no hot range intersects it), at least two
    decode windows long, and the per-kind no-span guard holds at the
    boundary byte (see _segment_rows for the full argument). Shared by
    the in-process segment splitter and the multi-process distributed
    shard-boundary search (parallel/distributed.py), which must agree
    on boundaries deterministically."""
    import numpy as np

    starts, lens, _fids, _last = sl
    hs, he = hot
    n_rows = len(starts)
    prev_start = starts[:-1]
    prev_end = prev_start + lens[:-1]
    # First hot range ending after prev_start; cold iff it starts at or
    # after prev_end.
    k = np.searchsorted(he, prev_start, "right")
    kk = np.minimum(k, max(len(hs) - 1, 0))
    cold = (k >= len(hs)) | (
        (hs[kk] >= prev_end) if len(hs) else np.ones(n_rows - 1, bool)
    )
    ok = cold & (lens[:-1] >= 2 * window_bytes)
    p = starts[1:]
    if kind == "utf8" and data is not None:
        b = np.asarray(data[np.minimum(p, len(data) - 1)])
        ok = ok & ~((b >= 0x80) & (b <= 0xBF))
    elif kind in ("utf16le", "utf16be"):
        ok = ok & (p % 2 == 0)
        if data is not None:
            hi_off = 1 if kind == "utf16le" else 2
            hi = np.asarray(
                data[np.clip(p - hi_off, 0, len(data) - 1)]
            )
            ok = ok & ~((hi >= 0xD8) & (hi <= 0xDB) & (p >= 2))
    return ok


def _segment_rows(sl, hot, window_bytes: int, max_segments: int,
                  data=None, kind: str = "utf8"):
    """Split a buffered scan into independently scannable row spans of
    the slice table - the HOST analog of the device halo stitching
    (SURVEY.md sec. 5 sequence parallelism).

    A segment may start at slice row r iff the previous slice is
    entirely cold (no hot range intersects it), at least two decode
    windows long, and NO event can span the boundary: the sequential
    scanner entering that cold slice quiesces within its first window
    (leftover re-filtered, maybe-cut flag cleared) and skips the rest,
    so the state at row r is provably the fresh state with cursor =
    slice start. The no-span guard matters even for REJECTED chars: a
    valid-but-filtered char straddling the boundary reports inside the
    new segment in the sequential scan but re-decodes as malformed
    events there in a segmented scan, which advances the decode-call
    label differently and shifts the (call-granular) printed position
    of a finding in that first window. Guards per kind (`data` is the
    stream bytes; both may be omitted for sbyte kinds):
      utf8:   data[start] must not be a continuation byte (every char
              spanning the boundary claims one there);
      utf16*: start must be even (unit phase = bytes-consumed parity,
              which stays even for UTF-16 streams) and the previous
              unit must not be a high surrogate (no pair may span).
    Returns sorted row indices (possibly empty), at most
    max_segments-1 of them, balanced by byte span."""
    import numpy as np

    starts, lens, _fids, _last = sl
    n_rows = len(starts)
    if n_rows < 2 or max_segments <= 1:
        return []
    ok = _quiescent_mask(sl, hot, window_bytes, data=data, kind=kind)
    cand = np.flatnonzero(ok) + 1
    if len(cand) == 0:
        return []
    if kind in _SEGMENT_KINDS_CJK and data is not None:
        # Non-self-synchronizing kinds: additionally require a proved
        # event start at the candidate (ground-byte decode-forward,
        # shared with the distributed shard-boundary search).
        from .engine.align import _cjk_boundary_aligned

        def _aligned(r):
            return _cjk_boundary_aligned(data, 0, int(starts[r]), kind)
    else:
        def _aligned(_r):
            return True
    # Pick the nearest PASSING candidate for each equal-byte-span
    # target (bounded tries: alignment checks decode ~4 KiB each).
    dists = starts[cand].astype(np.int64)
    total = int(starts[-1] + lens[-1])
    picks = []
    for g in range(1, max_segments):
        target = total * g // max_segments
        order = np.argsort(np.abs(dists - target), kind="stable")
        for j in order[:16]:
            r = int(cand[j])
            if _aligned(r):
                picks.append(r)
                break
    return sorted(set(picks))


def _scan_arrays(stream: LoadedStream, missions: Missions, engine: str,
                 input_refs: bool = False):
    """Scan all missions, returning per-mission column arrays:
    dict(position, precision, completes, file_id, str_off, str_len) +
    strbuf (4th element: the input buffer when `input_refs` streams
    carry SE_INREF-flagged offsets). Uses the native C++ engine for
    supported encodings (exact same output, orders of magnitude faster
    than the per-slice Python loop), the Python automaton otherwise.

    `input_refs` requires that the caller's output path resolves
    SE_INREF offsets (the fused se_merge_fd) and is forced off
    whenever hot maps / segmentation are in play (the segment
    concatenation rebases str_off, which would corrupt flagged
    values)."""
    import numpy as np

    from . import native
    from .encodings import encoding_kind
    from .input import slice_table
    from .utils import profiling

    results = [None] * len(missions.v)
    native_ok = engine != "python"
    sl = slice_table(stream) if native_ok else None
    python_missions = []
    native_jobs = []
    for i, m in enumerate(missions):
        kind = encoding_kind(m.encoding_name)
        if native_ok and native.native_supported(kind):
            native_jobs.append((i, m))
        else:
            python_missions.append(m)

    if native_jobs:
        # One OS thread per mission, like the reference (main.rs:151-167);
        # the C call releases the GIL. With engine="device", the device
        # kernels pre-compute accepted-run tables and the emitter skips
        # every window outside them.
        from concurrent.futures import ThreadPoolExecutor

        import os

        hot_by_mission = {}
        runtable_feeds = {}
        if engine != "device":
            # Host-side hot maps: a numpy prepass gives the native
            # engine the same window-skipping machinery with no device
            # attached. OPT-IN (STRINGSEXT_HOST_HOTMAP=1): whether the
            # full prepass pays off depends on host memory bandwidth vs
            # the emitter's cold fast paths - measured on a 2-vCPU
            # host it lost even at 60% cold. Segment-PARALLELISM does
            # not need it: cold split points are found by direct
            # probing near the balance targets (_probe_segment_rows,
            # default-on below), thousands of times cheaper than a
            # full-stream prepass.
            hm = os.environ.get("STRINGSEXT_HOST_HOTMAP", "0")
            if hm == "1":
                with profiling.scope("host.hotmap", len(stream.data)):
                    hot_by_mission = _host_hot_ranges(stream, native_jobs)
        if engine == "device":
            from .ops.specs import cjk_hot_spec, swar_mission_spec

            if _feed_enabled():
                # Device run-table feed (KERNELS.md design 1): EVERY
                # kind - UTF-8/UTF-16/single-byte/CJK and modal
                # ISO-2022-JP (device mode-prefix scan) - gets EXACT
                # accepted runs + the device-decoded payload (UTF-8
                # payloads are the input itself); the emitter consumes
                # whole runs (full in-run windows become payload
                # memcpys) and the exact runs double as the hot map
                # (for ISO-2022-JP the extras keep every mode/phase-
                # dependent byte hot so the skip gate stays sound).
                from .ops.device_events import FEED_KINDS, runtable_feed

                for i, m in native_jobs:
                    if encoding_kind(m.encoding_name) not in FEED_KINDS:
                        continue
                    res = runtable_feed(stream.data, m, with_extras=True)
                    if res is not None:
                        feed, (ex_pos, ex_len) = res
                        runtable_feeds[i] = feed
                        # the hot map must also cover accepted chars
                        # the feed excludes (multi-cp / report-clamped)
                        hs = np.concatenate([feed[0], ex_pos]) - 8
                        he = np.concatenate(
                            [feed[1], ex_pos + ex_len]) + 8
                        hot_by_mission[i] = _merge_ranges(
                            hs, he, len(stream.data)
                        )
            # Missions without a feed get counts-pass hot maps.
            swar_jobs, lanes_jobs = [], []
            for i, m in native_jobs:
                if i in runtable_feeds:
                    continue
                # Exact-count spec (UTF-8/UTF-16/single-byte), else the
                # conservative plausible-byte spec for the stateful
                # multi-byte encodings - CJK and modal ISO-2022-JP -
                # (hot/cold map only; the emitter rescans hot ranges
                # exactly and gates ISO-2022-JP skips on its mode
                # state).
                spec = swar_mission_spec(m) or cjk_hot_spec(m)
                (swar_jobs if spec is not None else lanes_jobs).append(
                    (i, m, spec)
                )
            if swar_jobs:
                hot_by_mission.update(
                    _device_hot_ranges_swar(
                        stream, [(i, sp) for i, _m, sp in swar_jobs]
                    )
                )
            for i, m, _sp in lanes_jobs:
                hot_by_mission[i] = _device_hot_ranges(stream, m)
                if hot_by_mission[i] is None:
                    _warn_once(
                        ("no-device-kernel", m.encoding_name),
                        f"Warning: engine=device has no device kernel for "
                        f"{m.encoding_name} (mission {m.mission_id}); "
                        f"falling back to a full host scan for it.",
                    )

        # Segment-parallel dispatch: missions with device hot maps and a
        # re-synchronizing kind split at provably-quiescent cold slices
        # so ONE mission's emitter runs on several cores (the reference
        # is strictly sequential per mission). Each job is
        # (mission_idx, mission, (row0, row1) | None).
        max_seg = _SEGMENT_MAX or (os.cpu_count() or 1)
        all_jobs = []
        for i, m in native_jobs:
            hot = hot_by_mission.get(i)
            splits = []
            kind = encoding_kind(m.encoding_name)
            seg_kind = (kind in _SEGMENT_KINDS
                        or kind in _SEGMENT_KINDS_CJK
                        or kind == "iso-2022-jp")
            if seg_kind and max_seg > 1 and i not in runtable_feeds:
                # (feed coordinates are absolute; the prototype keeps
                # feed missions unsegmented)
                if hot is not None:
                    splits = _segment_rows(
                        sl, hot, 2 * m.output_line_char_nb_max, max_seg,
                        data=stream.data, kind=kind,
                    )
                elif (len(stream.data) >= _SEGMENT_PROBE_MIN
                      and os.environ.get(
                          "STRINGSEXT_SEGMENT_PROBE", "1") != "0"):
                    # No hot map: probe cold split points directly
                    # (default-on; identical split semantics). The
                    # split budget is the cores LEFT OVER after the
                    # mission threads - with every core already busy,
                    # segmentation only costs the zero-copy output
                    # path (measured regression on dense 2-mission
                    # streams).
                    eff = max(1, max_seg // max(len(native_jobs), 1))
                    if eff > 1:
                        splits = _probe_segment_rows(
                            stream.data, sl, m, kind,
                            2 * m.output_line_char_nb_max, eff,
                        )
            bounds = [0] + splits + [len(sl[0])]
            if kind == "iso-2022-jp" and len(bounds) > 2:
                entry_modes = _iso_entry_modes(stream.data, sl, bounds)
            else:
                entry_modes = [0] * (len(bounds) - 1)
            if len(bounds) == 2:
                all_jobs.append((i, m, None, 0))
            else:
                for si, (r0, r1) in enumerate(zip(bounds[:-1], bounds[1:])):
                    all_jobs.append((i, m, (r0, r1), entry_modes[si]))

        # SE_INREF only without hot maps or segments: both rebase /
        # concatenate strbufs, which would corrupt flagged offsets.
        any_seg = any(t[2] is not None for t in all_jobs)
        use_refs = input_refs and not hot_by_mission and not any_seg

        def job(t):
            i, m, seg, entry_mode = t
            hot = hot_by_mission.get(i)
            if seg is None:
                return t, native.native_scan(
                    m, stream.data, *sl, hot_ranges=hot,
                    input_refs=use_refs and hot is None,
                    runtable_feed=runtable_feeds.get(i),
                )
            r0, r1 = seg
            ssl = tuple(a[r0:r1] for a in sl)
            seg_start = int(sl[0][r0])
            st = {
                "consumed": m.counter_offset + seg_start,
                "cursor": seg_start,
                "printed_maybe_cut": False,
                "dec_mode": entry_mode,
                "dec_output_flag": False,
                "leftover_cps": [],
            }
            if hot is None:  # probe-split segment: full scan of the span
                return t, native.native_scan(
                    m, stream.data, *ssl, state=st,
                )
            hs, he = hot
            seg_end = int(sl[0][r1 - 1] + sl[1][r1 - 1])
            ksel = (hs < seg_end) & (he > seg_start)
            return t, native.native_scan(
                m, stream.data, *ssl, state=st,
                hot_ranges=(hs[ksel], he[ksel]),
            )

        seg_parts = {}  # mission idx -> [(r0, res, sb)]
        workers = min(len(all_jobs), max(max_seg, len(native_jobs)))
        if len(all_jobs) == 1:
            outs = [job(all_jobs[0])]
        else:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                outs = list(ex.map(job, all_jobs))
        for (i, m, seg, _em), (res, sb) in outs:
            seg_parts.setdefault(i, []).append(
                (0 if seg is None else seg[0], m, res, sb)
            )
        for i, parts in seg_parts.items():
            parts.sort(key=lambda p: p[0])
            m = parts[0][1]
            if len(parts) == 1:
                results[i] = (m, parts[0][2], parts[0][3]) + (
                    (stream.data if use_refs else None,)
                    if input_refs else ()
                )
                continue
            res, sb = _concat_segment_parts([(p[2], p[3]) for p in parts])
            results[i] = (m, res, sb) + ((None,) if input_refs else ())

    if python_missions:
        sub = Missions(python_missions)
        per_mission_findings = {id(m): [] for m in python_missions}
        events_by_encoding = _generate_all_events(stream, sub, "numpy")
        from .engine.automaton import SliceScanner

        scanners = [SliceScanner(m) for m in python_missions]
        for s in stream.slices():
            for sc in scanners:
                ev = events_by_encoding[sc.mission.encoding_name]
                per_mission_findings[id(sc.mission)].extend(
                    sc.scan_slice(s.data, s.stream_start, ev, s.input_file_id, s.is_last)
                )
        it = iter(python_missions)
        for i, r in enumerate(results):
            if r is None:
                m = next(it)
                fl = per_mission_findings[id(m)]
                sb = b"".join(f.s for f in fl)
                offs = np.zeros(len(fl), np.uint64)
                lens = np.array([len(f.s) for f in fl], np.uint32)
                if len(fl):
                    offs[1:] = np.cumsum(lens.astype(np.uint64))[:-1]
                res = {
                    "position": np.array([f.position for f in fl], np.uint64),
                    "precision": np.array(
                        [f.position_precision for f in fl], np.int8
                    ),
                    "completes": np.array(
                        [1 if f.s_completes_previous_s else 0 for f in fl], np.uint8
                    ),
                    "file_id": np.array(
                        [-1 if f.input_file_id is None else f.input_file_id for f in fl],
                        np.int32,
                    ),
                    "str_off": offs,
                    "str_len": lens,
                }
                results[i] = (m, res, sb) + (
                    (None,) if input_refs else ()
                )
    return results


def write_output(out, args: Args, results) -> None:
    """Merge per-mission finding arrays by (position, mission_id) - the
    reference's kmerge key (finding.rs:92-109) - and write the exact
    output grammar (BOM, per-line metadata, final newline)."""
    out.write(b"\xef\xbb\xbf")  # U+FEFF BOM (main.rs:116)
    _emit_lines(out, args, results)
    out.write(b"\n")
    out.flush()


# Findings per native-formatter payload: bounds peak memory at
# forensic-scale outputs (a dense 1 GiB image emits >10M lines).
_FORMAT_BATCH = 1 << 21


def _chunk_runtable_feed(data, m, st):
    """Per-chunk run-table feed for the streaming path (KERNELS.md
    design 1 on the scale path): classification is grounded at the
    MISSION'S OWN CURSOR - a true event start by the native state
    contract - so the event chain is exact even for the
    non-self-synchronizing CJK kinds (the chunk-base as-if-ground of
    the counts hot maps would not be). Feed/extras coordinates are
    shifted back to chunk-buffer positions. Modal ISO-2022-JP engages
    only when the chunk is entered in ground state (mode ASCII, output
    flag clear - the lanes decode from mode 0); other entries fall
    back to the conservative hot spec for that chunk. Returns
    (feed, (extra_pos, extra_len)) or None."""
    from .encodings import encoding_kind
    from .ops.device_events import FEED_KINDS, runtable_feed

    kind = encoding_kind(m.encoding_name)
    if kind not in FEED_KINDS:
        return None
    if kind == "iso-2022-jp" and (
            int(st.get("dec_mode", 0)) != 0 or st.get("dec_output_flag")):
        return None
    c0 = int(st["cursor"])
    if c0 < 0 or c0 >= len(data):
        return None
    res = runtable_feed(data[c0:], m, with_extras=True)
    if res is None:
        return None
    (rs, re, cb, co, ip, pay), (ex_pos, ex_len) = res
    if c0:
        ip = ip + c0
        # UTF-8: co IS ip (payload = the input span); shift once.
        co = ip if pay is None else co
        rs, re, ex_pos = rs + c0, re + c0, ex_pos + c0
    return (rs, re, cb, co, ip, pay), (ex_pos, ex_len)


def _emit_lines(out, args: Args, results) -> None:
    """Write the merged finding lines of one batch ("\n" + line each,
    no BOM / trailing newline) - shared by the buffered path and the
    per-chunk streaming path."""
    import numpy as np

    from .finding import PRECISION_AFTER, PRECISION_BEFORE
    from .options import Radix

    import os

    from . import native as native_mod

    show_file = len(args.inputs) > 1
    show_radix = args.radix is not None
    show_enc = len(args.encoding) > 1
    no_meta = args.no_metadata
    flags = (
        (1 if show_file else 0) | (2 if show_radix else 0)
        | (4 if show_enc else 0) | (8 if no_meta else 0)
    )
    radix_fmt = {Radix.X: "x", Radix.D: "d", Radix.O: "o"}.get(args.radix)
    enc_prefix = [
        b"(" + bytes([(r[0].mission_id + 97) & 0xFF]) + b" "
        + r[0].display_encoding_name.encode() + b")\t"
        for r in results
    ]
    # Streams may carry SE_INREF-flagged str_off values (bit 63 =
    # offset into the stream's input buffer, emitted only when the
    # fused path was promised at scan time); ONLY native_merge_fd
    # resolves them, so the fallback paths below must never see one.
    has_input_refs = any(len(r) > 3 and r[3] is not None for r in results)

    if (
        results
        and os.environ.get("STRINGSEXT_NATIVE_FORMAT", "1") != "0"
        and os.environ.get("STRINGSEXT_FD_WRITE", "1") != "0"
        and native_mod.get_lib() is not None
    ):
        # Fused C k-way merge + format + straight-to-fd write: skips
        # the whole numpy concat/lexsort/gather stage AND the Python
        # payload copies. Only for real OS-level outputs (tests pass
        # BytesIO and fall through to the paths below). fileno()
        # failing (no real fd) falls back; a FAILING FLUSH is a real
        # output error and must propagate (with input-ref streams the
        # fallback could not render them anyway).
        try:
            fd = out.fileno()
        except (AttributeError, OSError, ValueError):
            fd = None
        if fd is not None:
            out.flush()
            streams = [
                (r[1], r[2], r[0].mission_id,
                 r[3] if len(r) > 3 else None)
                for r in results
            ]
            wrote = native_mod.native_merge_fd(
                fd, streams, enc_prefix, flags,
                (radix_fmt or "d").encode(),
            )
            if wrote is not None:
                return
    if has_input_refs:
        # The scan-time promise was broken (env changed mid-process or
        # the output object lost its fd): refuse rather than feed
        # bit-63 offsets to a formatter that would read wild memory.
        raise RuntimeError(
            "internal: input-referencing findings require the fused "
            "fd output path"
        )

    positions = np.concatenate([r[1]["position"] for r in results])
    mids = np.concatenate(
        [np.full(len(r[1]["position"]), r[0].mission_id, np.int32) for r in results]
    )
    midx = np.concatenate(
        [np.full(len(r[1]["position"]), i, np.int32) for i, r in enumerate(results)]
    )
    ridx = np.concatenate(
        [np.arange(len(r[1]["position"]), dtype=np.int64) for r in results]
    )
    order = np.lexsort((mids, positions))

    use_native_fmt = os.environ.get("STRINGSEXT_NATIVE_FORMAT", "1") != "0"
    if use_native_fmt and native_mod.get_lib() is not None and len(order):
        # Native formatter: numpy-gather every column into merge order
        # (vectorized), then C++ passes write the exact line grammar
        # (finding.rs:112-155) - the per-finding Python loop below is
        # ~50x slower at forensic-scale finding counts. Formatting runs
        # in bounded batches so the payload never holds the whole
        # output stream at once (a 1 GiB dense image emits >10M lines).
        full = {
            name: np.concatenate([r[1][name] for r in results]).astype(
                dtype, copy=False
            )
            for name, dtype in (
                ("precision", np.int8),
                ("completes", np.uint8), ("file_id", np.int32),
                ("str_off", np.uint64), ("str_len", np.uint32),
            )
        }
        # `positions` above is already the concatenated uint64 column.
        full["position"] = positions.astype(np.uint64, copy=False)
        strbufs = [r[2] for r in results]
        # Straight-to-fd writes (se_format_fd) skip the Python bytes +
        # BufferedWriter copies - at forensic scale the payload is
        # larger than the input. Only for real OS-level outputs; the
        # preceding flush keeps the BOM/line interleaving exact.
        fd = None
        if os.environ.get("STRINGSEXT_FD_WRITE", "1") != "0":
            try:
                fd = out.fileno()
                out.flush()
            except (AttributeError, OSError, ValueError):
                fd = None
        batch = _FORMAT_BATCH
        for lo in range(0, len(order), batch):
            sel = order[lo : lo + batch]
            payload = native_mod.native_format(
                np.ascontiguousarray(full["position"][sel]),
                np.ascontiguousarray(full["precision"][sel]),
                np.ascontiguousarray(full["completes"][sel]),
                np.ascontiguousarray(full["file_id"][sel]),
                np.ascontiguousarray(midx[sel]),
                np.ascontiguousarray(full["str_off"][sel]),
                np.ascontiguousarray(full["str_len"][sel]),
                strbufs,
                enc_prefix,
                flags,
                (radix_fmt or "d").encode(),
                fd=fd,
            )
            # native_format is None only when the lib is absent, which
            # get_lib() above already excluded; with fd it returned the
            # byte count after writing directly.
            if fd is None:
                out.write(payload)
        return

    w = out.write
    buf = bytearray()
    for k in order.tolist():
        mi = midx[k]
        i = ridx[k]
        res, sb = results[mi][1], results[mi][2]
        buf += b"\n"
        if not no_meta:
            if show_file:
                fid = res["file_id"][i]
                if fid >= 0:
                    buf += bytes([(fid + 64) & 0xFF, 0x20])  # u8 wrap parity
            if show_radix:
                p = res["precision"][i]
                buf += b">" if p == PRECISION_AFTER else (b"<" if p == PRECISION_BEFORE else b" ")
                buf += format(int(res["position"][i]), radix_fmt).encode()
                buf += b"+\t" if res["completes"][i] else b" \t"
            if show_enc:
                buf += enc_prefix[mi]
        o = int(res["str_off"][i])
        buf += sb[o : o + int(res["str_len"][i])]
        if len(buf) >= 1 << 20:
            w(bytes(buf))
            buf.clear()
    w(bytes(buf))


STREAM_CHUNK = 8 * 1024 * 1024  # stdin streaming chunk (multiple of 4096)


def _run_streaming_stdin(
    args: Args, missions: Missions, out, src=None,
    chunk_bytes: int = STREAM_CHUNK, engine: str = "auto",
    checkpoint_path: Optional[str] = None,
    file_plan: Optional[List] = None,
) -> int:
    """Constant-memory stdin scan: state-carrying native chunk scans +
    per-chunk merge/format - the reference's lock-step batch pipeline
    (main.rs:118-136: scan batch N+1 while the merger prints batch N)
    with the decoder carry held in the native state ABI.

    Output is BYTE-IDENTICAL to the buffered path: each chunk's
    findings have positions < the next chunk's (call labels live inside
    their chunk's slices), except findings emitted exactly AT a chunk
    boundary position, which could tie with the next chunk's first
    findings under the (position, mission_id) merge key - those are
    held back one chunk and merged there. Unconsumed tail bytes (the
    decode cursor stops at the first event reporting past the chunk,
    <= ~8 bytes) are re-prepended to the next chunk with per-mission
    cursor rebasing.

    `file_plan` = ordered [(file_id, path)]: MULTI-FILE constant-memory
    streaming (the reference scans any number of files in a fixed
    4 KiB buffer, input.rs:33-168). Chunks never span files - each
    chunk's slice rows carry that one file's id, so letters print
    exactly as buffered - and mission states (decoder carry, counters,
    leftovers) flow across file boundaries like the reference's
    concatenated stream; a leftover settled in the next file's first
    chunk gets THAT file's letter, which is the reference's own
    labeling (FindingCollection::from tags findings with the buffer's
    input_file_id). Files are chunked from their own offset 0, so the
    4096 slice grid restarts per file exactly like the buffered
    slice-table replay."""
    import numpy as np

    from concurrent.futures import ThreadPoolExecutor

    from . import native
    from .utils import checkpoint, profiling

    import os

    assert chunk_bytes % 4096 == 0
    if src is None:
        src = sys.stdin.buffer

    # --checkpoint FILE: resume when the file exists (restore mission
    # states, the unconsumed carry tail, the held-back boundary
    # findings, and skip the already-scanned stream prefix; the prior
    # run already wrote the BOM), else start fresh. Saved after every
    # chunk, removed on successful completion.
    held = None  # chunk-boundary-position findings deferred one chunk
    carry = np.zeros(0, np.uint8)  # unconsumed tail (buffer-relative)
    stream_pos = 0  # absolute bytes read from src so far
    resumed = False
    def _out_ident():
        """(st_dev, st_ino) of the output sink, or None (no real fd)."""
        try:
            st = os.fstat(out.fileno())
            return [int(st.st_dev), int(st.st_ino)]
        except (AttributeError, OSError, ValueError):
            return None

    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        (states, stream_pos, carry_b, held,
         ck_out_pos, ck_out_id) = checkpoint.load_stream_checkpoint(
            checkpoint_path, missions
        )
        carry = np.frombuffer(carry_b, np.uint8).copy()
        resumed = True
        # Exactly-once output when resuming into the SAME file: drop
        # any lines a crash let through after the checkpointed chunk
        # (the save runs after the emit, so a kill between them would
        # otherwise duplicate that chunk's lines). A sink smaller than
        # the recorded offset is a fresh/concatenated output (e.g.
        # stdout piped per run): append there, where a crash in that
        # window can still repeat lines - hence the warning.
        try:
            out.seek(0, 2)
            end = out.tell()
        except (AttributeError, OSError, ValueError):
            end = None
        if ck_out_pos is not None and end is not None and end >= ck_out_pos:
            oid = _out_ident()
            if ck_out_id is not None and oid is not None and oid != ck_out_id:
                raise RuntimeError(
                    "--checkpoint resume: the output is not the file the "
                    "checkpoint was writing (device/inode differ); refusing "
                    "to truncate it at the recorded offset. Point --output "
                    "at the original file, or remove the checkpoint to "
                    "start fresh."
                )
            out.seek(ck_out_pos)
            out.truncate()
        elif ck_out_pos is not None and end is not None:
            # Seekable but SHORTER than the recorded offset: a fresh or
            # different sink (e.g. stdout piped per run). Append there -
            # the checkpointed prefix is NOT re-emitted, and a crash
            # between an emit and its save can still repeat lines.
            _warn_once(
                ("ckpt-short-output",),
                "Warning: resuming to an output shorter than the "
                "checkpointed offset (fresh or different sink); the "
                "already-printed prefix is not re-emitted and lines "
                "written after the last checkpoint save may repeat.",
            )
        else:
            _warn_once(
                ("ckpt-unseekable",),
                "Warning: resuming to a non-seekable output; lines "
                "written after the last checkpoint save may repeat.",
            )
        # Skip the scanned prefix: seek when possible, else drain.
        try:
            src.seek(stream_pos)
        except (AttributeError, OSError):
            left = stream_pos
            while left > 0:
                got = src.read(min(left, chunk_bytes))
                if not got:
                    raise RuntimeError(
                        f"checkpoint {checkpoint_path} expects at least "
                        f"{stream_pos} input bytes but the stream ended "
                        f"at {stream_pos - left}"
                    )
                left -= len(got)
    else:
        states = checkpoint.fresh_states(missions)
    if not resumed:
        out.write(b"\xef\xbb\xbf")  # BOM (main.rs:116)

    pool = ThreadPoolExecutor(max_workers=max(1, len(missions.v)))

    # Zero-copy findings: when the fused se_merge_fd path will render
    # this stream (real fd + native formatter on + no checkpointing,
    # whose JSON serializer slices strbuf by offset), the fast lanes
    # may emit SE_INREF-flagged offsets into the chunk buffer instead
    # of copying bytes into strbuf (SURVEY.md sec. 5: findings as
    # offsets into a resident buffer, not owned strings).
    use_input_refs = (
        checkpoint_path is None
        and os.environ.get("STRINGSEXT_NATIVE_FORMAT", "1") != "0"
        and os.environ.get("STRINGSEXT_FD_WRITE", "1") != "0"
        and native.get_lib() is not None
    )
    if use_input_refs:
        try:
            out.fileno()
            out.flush()
        except (AttributeError, OSError, ValueError):
            use_input_refs = False

    # Front headroom per chunk buffer: the carry (the tiny unconsumed
    # tail of the previous chunk, typically <= 8 bytes) is spliced in
    # front of the freshly-read bytes AFTER the previous scans settle
    # it, so the read itself can run ahead on the reader thread.
    _PAD = 4096
    reader_pool = ThreadPoolExecutor(max_workers=1)

    def read_chunk():
        """Read the next chunk_bytes into a fresh buffer with _PAD
        bytes of front headroom. Runs on the reader thread, overlapping
        the scans and the merge of earlier chunks (the main thread used
        to do this read between scan rounds - a per-chunk pipeline
        bubble). Reads are serialized by the 1-worker pool, so stream
        order is preserved. Returns (buf, got, deferred_error)."""
        buf = np.empty(_PAD + chunk_bytes, np.uint8)
        # readinto the preallocated buffer: avoids the bytes object +
        # np.concatenate copies (a full extra pass over the stream).
        # Loop to a full chunk so a short raw-stream read is not
        # mistaken for EOF (is_final = short read, as with
        # BufferedReader.read semantics).
        got = 0
        view = memoryview(buf)[_PAD:]
        try:
            readinto = getattr(src, "readinto", None)
            while got < chunk_bytes:
                if readinto is not None:
                    k = readinto(view[got:])
                else:
                    raw = src.read(chunk_bytes - got)
                    # A non-blocking source without readinto returns
                    # None when no data is ready - route it to the
                    # same select() wait as the readinto branch.
                    k = None if raw is None else len(raw)
                    if k:
                        view[got : got + k] = raw
                if k is None:
                    # non-blocking fd with no data ready: wait, don't
                    # mistake it for EOF (silent truncation)
                    import select

                    fno = getattr(src, "fileno", None)
                    if fno is None:
                        raise BlockingIOError(
                            "non-blocking source returned no data"
                        )
                    select.select([fno()], [], [])
                    continue
                if not k:
                    break
                got += k
        except BaseException as e:  # defer: the PREVIOUS chunk must
            return buf, got, e  # still be emitted + checkpointed first
        return buf, got, None

    def build_and_launch(rd):
        """Splice the carry into the prefetched chunk, build its slice
        grid + hot maps, launch the per-mission scans on the pool, and
        prefetch the NEXT chunk's read. Called only once the mission
        states are settled for the PREVIOUS chunk (native_scan mutates
        them in place), so the scans of chunk N+1 overlap the
        merge+format of chunk N - the reference's lock-step pipeline
        (main.rs:118-136: scan batch N+1 while the merger prints N)."""
        nonlocal stream_pos
        buf, got, err = rd.result()
        if err is not None:
            return ("err", err)
        stream_pos += got
        carry_len = len(carry)
        if carry_len <= _PAD:
            base = _PAD - carry_len
            buf[base:_PAD] = carry
            data = buf[base : _PAD + got]
        else:  # pathological carry larger than the headroom: assemble
            data = np.empty(carry_len + got, np.uint8)
            data[:carry_len] = carry
            data[carry_len:] = buf[_PAD : _PAD + got]
        chunk_end = carry_len + got  # buffer-relative
        is_final = got < chunk_bytes
        next_rd = None
        if not is_final:
            next_rd = reader_pool.submit(read_chunk)

        # Slice grid: 4096-byte slices starting at the first new byte
        # (chunks are 4096-multiples, so the grid stays stream-aligned).
        s = np.arange(carry_len, chunk_end, 4096, dtype=np.int64)
        sl = (
            s,
            np.minimum(chunk_end - s, 4096).astype(np.int32),
            np.full(len(s), -1, np.int32),
            np.zeros(len(s), np.uint8),
        )

        # Per-chunk hot maps (buffer-relative byte coordinates -
        # native_scan compares them against the same): device kernels
        # under engine=device, or the opt-in host prepass
        # (STRINGSEXT_HOST_HOTMAP=1) with no device - the latter is
        # what makes many-mission sparse sweeps of huge STREAMED files
        # feasible (the buffered path has had it since round 2).
        hot_by_mission = {}
        if (engine != "device" and len(data)
                and os.environ.get("STRINGSEXT_HOST_HOTMAP") == "1"):
            hot_by_mission = _host_hot_ranges(
                LoadedStream(data, [(None, 0, len(data))]),
                list(enumerate(missions.v)),
            )
        runtable_feeds = {}
        if engine == "device" and len(data):
            from .ops.specs import cjk_hot_spec, swar_mission_spec

            if _feed_enabled():
                # Per-chunk device run-table feed (cursor-grounded
                # exact classification; see _chunk_runtable_feed). The
                # exact runs + extras double as the chunk's hot map,
                # with the pre-cursor head kept hot.
                for i, m in enumerate(missions.v):
                    r = _chunk_runtable_feed(data, m, states[i])
                    if r is None:
                        continue
                    feed, (ex_pos, ex_len) = r
                    runtable_feeds[i] = feed
                    c0 = int(states[i]["cursor"])
                    hs = np.concatenate(
                        [feed[0], ex_pos, [0]]) - 8
                    he = np.concatenate(
                        [feed[1], ex_pos + ex_len, [c0 + 8]]) + 8
                    hot_by_mission[i] = _merge_ranges(
                        hs, he, len(data))
            chunk_stream = LoadedStream(data, [(None, 0, len(data))])
            swar_jobs = []
            for i, m in enumerate(missions.v):
                if i in runtable_feeds:
                    continue
                spec = swar_mission_spec(m) or cjk_hot_spec(m)
                if spec is not None:
                    swar_jobs.append((i, spec))
            if swar_jobs:
                # pad_to pins the kernel shape so the short final chunk
                # reuses the steady-state compile.
                hot_by_mission.update(_device_hot_ranges_swar(
                    chunk_stream, swar_jobs, pad_to=chunk_bytes + 4096
                ))

        # Probe-split segmentation WITHIN a chunk (the streaming twin
        # of the buffered default): a huge single-mission stream
        # otherwise scans sequentially while cores idle. Segment 0
        # enters with the mission's carried state; later segments
        # enter at provably-quiescent cold rows in the FRESH state
        # (same probe + guards as the buffered path; ISO entry modes
        # composed from the escape history), scan concurrently, and
        # the LAST segment's exit state becomes the carried state.
        from .encodings import encoding_kind as _ekind

        max_seg = _SEGMENT_MAX or (os.cpu_count() or 1)
        # split budget = cores left over after the mission threads (a
        # fully-busy host gains nothing and would lose the zero-copy
        # output path - measured on the dense 2-mission stream)
        eff_seg = max(1, max_seg // max(len(missions.v), 1))
        seg_bounds = {}  # i -> (bounds_rows, entry_modes)
        if (eff_seg > 1 and len(data) >= _SEGMENT_PROBE_MIN
                and os.environ.get("STRINGSEXT_SEGMENT_PROBE", "1") != "0"):
            for i, m in enumerate(missions.v):
                if i in runtable_feeds or hot_by_mission.get(i) is not None:
                    continue
                kind = _ekind(m.encoding_name)
                if not (kind in _SEGMENT_KINDS
                        or kind in _SEGMENT_KINDS_CJK
                        or kind == "iso-2022-jp"):
                    continue
                splits = _probe_segment_rows(
                    data, sl, m, kind, 2 * m.output_line_char_nb_max,
                    eff_seg,
                )
                if not splits:
                    continue
                bounds = [0] + splits + [len(sl[0])]
                carried = int(states[i].get("dec_mode", 0))
                if kind == "iso-2022-jp":
                    entry_modes = _iso_entry_modes(
                        data, sl, bounds, initial_mode=carried,
                        first_lo=int(states[i].get("cursor", 0)),
                    )
                else:
                    entry_modes = [carried] * (len(bounds) - 1)
                seg_bounds[i] = (bounds, entry_modes)

        def job(i, m):
            if i not in seg_bounds:
                return i, [native.native_scan(
                    m, data, *sl, state=states[i],
                    hot_ranges=hot_by_mission.get(i),
                    input_refs=use_input_refs,
                    runtable_feed=runtable_feeds.get(i),
                )], None
            bounds, entry_modes = seg_bounds[i]
            base = states[i]
            k0 = int(base["consumed"])
            row0 = int(sl[0][0])
            seg_states = [base]
            for si in range(1, len(bounds) - 1):
                s_off = int(sl[0][bounds[si]])
                seg_states.append({
                    # the native counter is SLICE-cumulative (consumed
                    # advances by slice length, emitter.cpp:1811), so
                    # the counter at row r is the chunk-entry counter
                    # plus the slice bytes before r - NOT a cursor
                    # delta (the cursor may lag in the carry tail)
                    "consumed": k0 + (s_off - row0),
                    "cursor": s_off,
                    "printed_maybe_cut": False,
                    "dec_mode": entry_modes[si],
                    "dec_output_flag": False,
                    "leftover_cps": [],
                })

            def seg_job(si):
                r0, r1 = bounds[si], bounds[si + 1]
                ssl = tuple(a[r0:r1] for a in sl)
                return native.native_scan(
                    m, data, *ssl, state=seg_states[si],
                )

            with ThreadPoolExecutor(
                max_workers=len(seg_states)
            ) as sx:
                parts = list(sx.map(seg_job, range(len(seg_states))))
            # the last segment's exit state is the sequential exit
            # state (quiescent entries are exact)
            states[i] = seg_states[-1]
            return i, parts, "seg"

        futs = [pool.submit(job, i, m) for i, m in enumerate(missions.v)]
        return chunk_end, is_final, data, futs, next_rd

    inflight = build_and_launch(reader_pool.submit(read_chunk))
    while True:
        if inflight[0] == "err":
            pool.shutdown()
            reader_pool.shutdown()
            raise inflight[1]
        chunk_end, is_final, data, futs, next_rd = inflight
        results = [None] * len(missions.v)
        with profiling.scope("scan", chunk_end * len(missions.v)):
            # (reports only the NON-overlapped scan residual once the
            # pipeline is warm)
            for f in futs:
                i, parts, seg = f.result()
                if seg is None:
                    res, sb = parts[0]
                    # 4th element: the chunk buffer SE_INREF offsets
                    # point into (None when input_refs is off)
                    ib = data if use_input_refs else None
                else:
                    # probe-split segments
                    res, sb = _concat_segment_parts(parts)
                    ib = None
                results[i] = (missions.v[i], res, sb, ib)

        consumed_now = [int(st["consumed"]) for st in states]

        ck_snapshot = None
        if not is_final:
            # Tail carry: drop everything every mission consumed. Trim
            # an EVEN number of bytes so the chunk buffer's base parity
            # stays the stream's parity: the device hot-map kernels and
            # the emitter's skip-resume alignment pair UTF-16 units by
            # buffer offset, and an odd base would flip the unit phase
            # (fuzz 987654 trials 696/2884: bogus / missing UTF-16
            # findings after a skip in streaming engine=device).
            cmin = min(int(st["cursor"]) for st in states)
            cmin = min(cmin, chunk_end) & ~1
            carry = data[cmin:].copy()
            for st in states:
                st["cursor"] = int(st["cursor"]) - cmin
            if checkpoint_path is not None:
                # Snapshot before the next launch starts mutating the
                # states (shallow per-state copies: native_scan
                # replaces values, never mutates them).
                ck_snapshot = (
                    [dict(st) for st in states], stream_pos,
                    carry.tobytes(),
                )
            # Launch chunk N+1 now (states and carry are settled; its
            # bytes were prefetched by the reader thread during this
            # chunk's scans); the holdback split and the merge+format
            # below overlap with its scans.
            inflight = build_and_launch(next_rd)

        # Split off boundary-position findings (they can tie with the
        # next chunk under the merge key) unless this is the last
        # chunk. The boundary position is per mission: its `consumed`
        # counter after this chunk (counter offsets may differ).
        # Positions are nondecreasing, so boundary ties can only sit at
        # the tail: one searchsorted + O(1) slicing (views, no copies).
        emit, hold = [], []
        for i, (m, res, sb, ib) in enumerate(results):
            if is_final:
                emit.append((m, res, sb, ib))
                continue
            pos = res["position"]
            cut = int(np.searchsorted(pos, consumed_now[i], "left"))
            if cut == len(pos):
                emit.append((m, res, sb, ib))
                hold.append(
                    (i, m, {k: v[:0] for k, v in res.items()}, sb, ib)
                )
            else:
                emit.append(
                    (m, {k: v[:cut] for k, v in res.items()}, sb, ib)
                )
                hold.append(
                    (i, m, {k: v[cut:] for k, v in res.items()}, sb, ib)
                )
        if held is not None:
            # (resumed checkpoints deserialize held rows without the
            # input-buffer element)
            emit = [
                (r[1], r[2], r[3], r[4] if len(r) > 4 else None)
                for r in held
            ] + emit
        held = hold if not is_final else None

        with profiling.scope("merge+format"):
            _emit_lines(out, args, emit)

        if ck_snapshot is not None:
            # Output position AFTER this chunk's emit (fd writes went
            # through the kernel offset; flush drains any buffered
            # Python-side bytes first). None on non-seekable sinks.
            try:
                out.flush()
                ck_out = out.tell()
            except (AttributeError, OSError, ValueError):
                ck_out = None
            checkpoint.save_stream_checkpoint(
                checkpoint_path, ck_snapshot[0], ck_snapshot[1],
                ck_snapshot[2], held, missions=missions,
                out_pos=ck_out, out_id=_out_ident(),
            )

        if is_final:
            if checkpoint_path is not None:
                try:
                    os.remove(checkpoint_path)
                except OSError:
                    pass
            break

    out.write(b"\n")
    out.flush()
    pool.shutdown()
    reader_pool.shutdown()
    profiling.report()
    return 0


def _compilation_cache_dir() -> str:
    """Where the persistent XLA compilation cache lives:
    JAX_COMPILATION_CACHE_DIR when set, else `.jax_cache/` at the root
    of the checkout (a fixed path - the cache key includes it, so a
    moving directory would never hit)."""
    import os

    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache",
    )


def _enable_compilation_cache() -> None:
    """Persistent XLA compilation cache for engine=device: without it,
    every CLI process compiles the device passes again. A failure is
    reported on stderr; the scan itself goes on uncached."""
    import os

    path = _compilation_cache_dir()
    try:
        import jax

        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    except Exception as e:
        _warn_once(("compile-cache",),
                   f"Warning: persistent compilation cache disabled "
                   f"({path}: {e}); every process compiles again.")


def run(args: Args, out: Optional[IO[bytes]] = None, engine: str = "auto") -> int:
    """CLI entry: load input, scan, write the output stream.

    Output contract (main.rs:103-139): BOM first, then "\\n" before each
    finding line, then a final "\\n"; to stdout or `-p FILE`.
    """
    import os

    from .utils import profiling

    _WARNED.clear()  # per-run degradation warnings (library use)
    engine = _engine_name(engine)
    missions = Missions.from_args(args)

    from . import native
    from .encodings import encoding_kind

    # Extension flags -> env bridge: the inner passes read the
    # STRINGSEXT_* variables; an already-set variable overrides the
    # flag (see options.py). Only keys WE set are removed again on the
    # way out, so one run()'s flags never leak into a later in-process
    # run() (an ambient variable the caller exported stays put).
    _bridged = []
    for _key, _val in (
        ("STRINGSEXT_HOT_GROUP", args.hot_group),
        ("STRINGSEXT_MESH", "1" if args.mesh else None),
        ("STRINGSEXT_STREAM_FILE_MIN", args.stream_file_min),
        ("STRINGSEXT_HOST_HOTMAP", "1" if args.host_hotmap else None),
    ):
        if _val is not None and _key not in os.environ:
            os.environ[_key] = _val
            _bridged.append(_key)
    try:
        if engine == "auto":
            # engine=auto probes the attached accelerator (once per
            # machine, cached) and promotes itself to the device path
            # when the link can beat the host emitter - device-first
            # with zero flags on a co-located card (see _auto_engine).
            engine = _auto_engine()
        if engine == "device":
            _enable_compilation_cache()

        use_stdin = (not args.inputs) or (
            len(args.inputs) == 1 and args.inputs[0] == "-"
        )

        if args.dist_nprocs is not None and int(args.dist_nprocs) > 1:
            # Multi-process distributed scan: every process runs the same
            # command with its --dist-rank; the input must be a real file
            # set visible to all hosts (no stdin), and process 0 prints
            # the merged byte-identical stream.
            if use_stdin:
                raise RuntimeError(
                    "distributed scan requires file inputs (stdin cannot be "
                    "sharded across processes)"
                )
            from .parallel import distributed

            distributed.initialize(
                coordinator_address=args.dist_coord,
                num_processes=int(args.dist_nprocs),
                process_id=int(args.dist_rank or 0),
            )
            close_d = False
            if out is None:
                if args.output is not None and int(args.dist_rank or 0) == 0:
                    out = open(args.output, "wb")
                    close_d = True
                else:
                    out = sys.stdout.buffer
            try:
                # --checkpoint: per-rank scan-phase resume (the merge
                # phase is idempotent; resume = rerun the identical
                # command with the same world).
                return distributed.distributed_run(
                    args, missions, out, engine=engine,
                    checkpoint_path=args.checkpoint,
                )
            finally:
                if close_d:
                    out.close()
        native_streamable = (
            engine != "python"
            and native.get_lib() is not None
            and all(
                native.native_supported(encoding_kind(m.encoding_name))
                for m in missions.v
            )
        )
        if args.checkpoint is not None:
            # Checkpointed scans always take the chunked streaming path
            # (its state is what the checkpoint captures). Requirements:
            # one input (or stdin) and native-supported missions.
            if len(args.inputs) > 1:
                raise RuntimeError(
                    "--checkpoint requires a single input file or stdin"
                )
            if not native_streamable:
                raise RuntimeError(
                    "--checkpoint requires the native engine (engine=auto or "
                    "device) and native-supported encodings"
                )
            close_ck = False
            if out is None:
                if args.output is not None:
                    # resume appends: the printed prefix must survive
                    out = open(args.output,
                               "ab" if os.path.exists(args.checkpoint) else "wb")
                    close_ck = True
                else:
                    out = sys.stdout.buffer
            try:
                if use_stdin:
                    return _run_streaming_stdin(
                        args, missions, out, engine=engine,
                        checkpoint_path=args.checkpoint,
                    )
                with open(args.inputs[0], "rb") as src:
                    return _run_streaming_stdin(
                        args, missions, out, src=src, engine=engine,
                        checkpoint_path=args.checkpoint,
                    )
            finally:
                if close_ck:
                    out.close()
        stream_stdin = use_stdin and native_streamable
        # A huge SINGLE file also streams in constant memory: the findings
        # columns of a buffered scan grow with the finding count (a dense
        # 10 GB image holds >100M findings), while the chunked pipeline is
        # O(chunk). Identical output (the streaming-vs-buffered invariant
        # is fuzzed); single-file only, so file-letter metadata (absent for
        # one input) never applies.
        stream_file = None
        if (
            not use_stdin and len(args.inputs) == 1 and native_streamable
        ):
            try:
                fsize = os.path.getsize(args.inputs[0])
            except OSError:
                fsize = 0
            try:
                stream_min = int(
                    os.environ.get("STRINGSEXT_STREAM_FILE_MIN", "") or (1 << 30)
                )
            except ValueError:
                stream_min = 1 << 30  # malformed env: keep the default
            if fsize >= stream_min:
                stream_file = args.inputs[0]

        close_out = False
        if out is None:
            if args.output is not None:
                out = open(args.output, "wb")
                close_out = True
            else:
                out = sys.stdout.buffer

        try:
            if stream_stdin:
                return _run_streaming_stdin(args, missions, out, engine=engine)
            if stream_file is not None:
                try:
                    src = open(stream_file, "rb")
                except OSError:
                    src = None  # unreadable: buffered path warns + empty
                if src is not None:
                    with src:
                        return _run_streaming_stdin(
                            args, missions, out, src=src, engine=engine
                        )
            with profiling.scope("input.load"):
                stream = load_stream(args.inputs)
            nbytes = len(stream.data)
            # SE_INREF for the buffered path too: only when the fused
            # fd merge will render the result (same preconditions as
            # the streaming path) and no hot maps/segmentation are in
            # play (checked again inside _scan_arrays).
            buf_refs = (
                os.environ.get("STRINGSEXT_NATIVE_FORMAT", "1") != "0"
                and os.environ.get("STRINGSEXT_FD_WRITE", "1") != "0"
                and native.get_lib() is not None
            )
            if buf_refs:
                try:
                    out.fileno()
                except (AttributeError, OSError, ValueError):
                    buf_refs = False
            with profiling.scope("scan", nbytes * len(missions.v)):
                results = _scan_arrays(stream, missions, engine,
                                       input_refs=buf_refs)
            with profiling.scope("merge+format"):
                write_output(out, args, results)
            profiling.report()
        finally:
            if close_out:
                out.close()
        return 0
    finally:
        for _key in _bridged:
            os.environ.pop(_key, None)
