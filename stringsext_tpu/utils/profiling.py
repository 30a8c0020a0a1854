"""Tracing / profiling hooks.

The reference has none (SURVEY.md section 5: "no timing, counters, or
trace hooks anywhere"). This build adds:

- `Scope`: lightweight wall-clock + bytes/s counters for pipeline
  stages, dumped with `report()` (enable with STRINGSEXT_PROFILE=1 or
  programmatically).
- `device_trace`: context manager around `jax.profiler.trace` for
  XLA device traces viewable in TensorBoard/XProf.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

ENABLED = os.environ.get("STRINGSEXT_PROFILE", "") not in ("", "0")

_stats: Dict[str, list] = defaultdict(lambda: [0.0, 0, 0])  # t, calls, bytes


@contextlib.contextmanager
def scope(name: str, nbytes: int = 0) -> Iterator[None]:
    """Time a stage; attribute `nbytes` of input to it."""
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        s = _stats[name]
        s[0] += dt
        s[1] += 1
        s[2] += nbytes


def report(out=None) -> None:
    if not ENABLED or not _stats:
        return
    out = out or sys.stderr
    print("--- stringsext-tpu profile ---", file=out)
    for name, (t, calls, nbytes) in sorted(_stats.items()):
        rate = f" {nbytes / t / 1e6:8.1f} MB/s" if nbytes and t > 0 else ""
        print(f"{name:32s} {t:8.3f}s  x{calls:<6d}{rate}", file=out)


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None) -> Iterator[None]:
    """Device trace via jax.profiler (XProf/TensorBoard format)."""
    logdir = logdir or os.environ.get("STRINGSEXT_TRACE_DIR")
    if not logdir:
        yield
        return
    import jax

    with jax.profiler.trace(logdir):
        yield
