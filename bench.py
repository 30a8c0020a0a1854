"""Benchmark: device scan throughput on the flagship configuration.

Measures bytes/s of the multi-mission scan step (UTF-8 + UTF-16LE +
UTF-16BE, the conformance-corpus config) over a device-resident buffer
on one GPU: the fused SWAR counts pass plus run-table extraction
(__graft_entry__.entry). This is the kernel layer only - no input
load, host emitter or output.

The scan is iterated on device inside one jit (each iteration XORs the
stream with a loop-dependent byte so no work can be hoisted), and the
whole loop is timed to completion.

Needs a GPU: exits non-zero when JAX finds none. Prints ONE JSON line
with the metric, the device as JAX reports it and the card's power
limit.
"""

import json
import subprocess
import sys
import time

import numpy as np


def make_corpus(size: int, seed: int = 0) -> np.ndarray:
    """Binary-image-like corpus: mostly random bytes with embedded
    ASCII/UTF-8/UTF-16 strings (like the reference's functional test
    input2: machine code + embedded UTF-16LE strings)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=size, dtype=np.uint8)
    msgs = [
        b"/lib64/ld-linux-x86-64.so.2\x00",
        "Configuration déjà chargée €uro.".encode("utf-8"),
        "Device path: \\EFI\\BOOT\\BOOTX64.EFI".encode("utf-16-le"),
        "Русский текст в дампе памяти".encode("utf-16-le"),
        b"GET /index.html HTTP/1.1\r\nHost: example.com\r\n",
    ]
    step = max(size // 2048, 4096)
    for off in range(0, size - 256, step):
        m = msgs[(off // step) % len(msgs)]
        data[off : off + len(m)] = np.frombuffer(m, np.uint8)
    return data


def build_bench_fn():
    import importlib.util

    import jax
    import jax.numpy as jnp

    spec = importlib.util.spec_from_file_location("graft", "__graft_entry__.py")
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)
    scan_step, _ = g.entry()

    def bench_fn(data, iters):
        def body(i, acc):
            xw = (i % 2) * 0x01010101
            out = scan_step(data, xor_word=xw)
            chk = acc
            for rt in out:
                chk = chk + rt[3].astype(jnp.int32)  # run count
                chk = chk + jnp.sum(rt[0][:8])
            return chk

        return jax.lax.fori_loop(0, iters, body, jnp.int32(0))

    return jax.jit(bench_fn, static_argnames=("iters",))


def _power_limit() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else ""
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return ""


def main():
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 64 * 1024 * 1024
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 100

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench.py: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 1

    sys.path.insert(0, ".")
    bench = build_bench_fn()
    # Resident as packed int32 words (the scan's native layout).
    data = jax.device_put(make_corpus(size).view(np.int32))
    int(bench(data, iters))  # compile + warm up

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        int(bench(data, iters))  # scalar fetch waits for the loop
        best = min(best, time.perf_counter() - t0)
    print(json.dumps({
        "metric": "scan_throughput_3mission",
        "value": size * iters / best / 1e9,
        "unit": "GB/s",
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
        "card": _power_limit(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
