#!/usr/bin/env python3
"""Bring-up smoke of the device engine on one NVIDIA GPU.

Drives the normal CLI path end to end on the card and checks every
result against the repo's own references: the host (native C++)
engine, the Python oracle, and the independent jnp classification
lanes run on the CPU backend. Inputs are generated from fixed seeds.

    python chip_smoke.py                # every phase, one card
    python chip_smoke.py --four-chips   # the mesh path on four cards only
    python chip_smoke.py --only kernel,buffered   # a subset, for debugging

The parent process never imports JAX. Each phase runs in a child
process, one after another, so only one process holds the card at a
time. Any failure exits non-zero; nothing falls back to the CPU. The
last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Wall times printed on the way are bring-up timings of this script,
not benchmark results.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BUDGET_S = 1150.0  # the whole script, compilation included

PHASES = ("env", "native", "kernel", "buffered", "streamed",
          "all-encodings", "oracle", "cache")

MIB = 1 << 20
KERNEL_CHUNK = 32 * MIB
BUFFERED_SIZE = 768 * MIB
STREAMED_SIZE = 1536 * MIB  # above the 1 GiB single-file streaming threshold
ALL_ENC_SIZE = 128 * MIB
ORACLE_SIZE = 1 * MIB
FOUR_CHIP_SIZE = 256 * MIB
READ_BW_H100 = 3.35e12  # H100 SXM HBM3 bytes/s (NVIDIA data sheet)

FLAGSHIP_ARGS = ["-t", "x", "-n", "4", "-e", "UTF-8", "-e", "utf-16le",
                 "-e", "utf-16be"]
# The conformance corpus's configuration (golden config 1).
ORACLE_ARGS = ["-q", "16", "-g", "63", "-tx", "-a", "All-Ctrl", "-u",
               "Common", "-e", "UTF-8", "-e", "utf-16le", "-e", "utf-16be"]

_MESSAGES = (
    b"/lib64/ld-linux-x86-64.so.2\x00",
    "Configuration déjà chargée €uro.".encode("utf-8"),
    "Device path: \\EFI\\BOOT\\BOOTX64.EFI".encode("utf-16-le"),
    "Русский текст в дампе памяти".encode("utf-16-le"),
    "Big-endian wide string Ωμέγα".encode("utf-16-be"),
    b"GET /search?q=index.html HTTP/1.1\r\nHost: example.com\r\n",
    "Where is the key? C:\\Windows\\System32".encode("utf-16-le"),
    "シフトJISの文字列".encode("shift_jis"),
    "汉字字符串测试".encode("gb18030"),
    b"\x1b$B" + "漢字".encode("iso-2022-jp")[3:-3] + b"\x1b(B ok",
    "в лесу родилась ёлочка".encode("koi8_r"),
)


def make_image(size: int, seed: int, noise: float = 0.1):
    """Forensic-shaped disk image: zero sectors, random-byte file
    extents (64 KiB each, a `noise` share of the image) and text in
    several encodings planted every 4 KiB, like the strings of a
    filesystem image. Deterministic in (size, seed)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    img = np.zeros(size, np.uint8)
    ext = 64 * 1024
    n_ext = size // ext
    picked = np.flatnonzero(rng.random(n_ext) < noise)
    for e in picked:
        img[e * ext:(e + 1) * ext] = rng.integers(0, 256, ext, np.uint8)
    step = 4096
    offs = np.arange(1024, max(size - 256, 1024), step)
    jitter = rng.integers(0, 512, len(offs)) * 2
    for k, off in enumerate(offs):
        m = _MESSAGES[k % len(_MESSAGES)]
        o = int(off + jitter[k])
        if o + len(m) < size:
            img[o:o + len(m)] = np.frombuffer(m, np.uint8)
    return img


# --------------------------------------------------------------- helpers


def _gpu_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def _require_gpu(dev) -> None:
    if dev.platform != "gpu":
        raise RuntimeError(f"JAX found no GPU (platform {dev.platform})")


def _card() -> str:
    """'<name>, <power limit>' of the first card, for timing lines."""
    return _gpu_line().splitlines()[0]


def _cli(argv, out_path, env_extra=None, timeout=900):
    """Run the CLI in a fresh process with stdout to `out_path`.
    Returns (stderr text, wall seconds)."""
    env = dict(os.environ)
    env.setdefault("STRINGSEXT_PROFILE", "1")
    if env_extra:
        env.update(env_extra)
    t0 = time.perf_counter()
    with open(out_path, "wb") as out:
        p = subprocess.run(
            [sys.executable, "-m", "stringsext_tpu.cli", *argv],
            stdout=out, stderr=subprocess.PIPE, cwd=REPO, env=env,
            timeout=timeout,
        )
    dt = time.perf_counter() - t0
    err = p.stderr.decode(errors="replace")
    if p.returncode != 0:
        raise RuntimeError(
            f"CLI {' '.join(argv[:12])} exited {p.returncode}:\n"
            f"{err[-3000:]}")
    return err, dt


def _profile(err: str) -> dict:
    """{scope name: [seconds, calls]} from the STRINGSEXT_PROFILE
    report."""
    out = {}
    for ln in err.splitlines():
        m = re.match(r"^(\S+)\s+([0-9.]+)s\s+x(\d+)", ln)
        if m:
            out[m.group(1)] = [float(m.group(2)), int(m.group(3))]
    return out


def _calls(prof: dict, scope: str) -> int:
    return prof.get(scope, [0.0, 0])[1]


def _digest(path: str):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 24), b""):
            h.update(blk)
    return h.hexdigest(), os.path.getsize(path)


def _device_vs_host(name, argv, work, env_extra=None, feed=True):
    """The device engine (engine=auto, which must promote itself) and
    the host engine on the same input: byte-identical stdout and a
    device dispatch in the profile - a run-table feed too, unless
    `feed` is False. Returns the device run's output digest."""
    dev_out = os.path.join(work, f"{name}.device.out")
    host_out = os.path.join(work, f"{name}.host.out")
    err, t_dev = _cli(argv, dev_out, env_extra)
    prof = _profile(err)
    print(f"{name}: device engine wall {t_dev:.3f} s, profile "
          f"{{scope: [s, calls]}} {prof}")
    if _calls(prof, "device.dispatch") <= 0:
        raise RuntimeError(
            f"{name}: no device.dispatch in the profile - the device "
            f"engine did not run:\n{err[-3000:]}")
    if feed and _calls(prof, "device.feed") <= 0:
        raise RuntimeError(f"{name}: the run-table feed did not run")
    _, t_host = _cli(argv, host_out,
                     dict(env_extra or {}, STRINGSEXT_DEVICE_PROBE="0"))
    print(f"{name}: host engine wall {t_host:.3f} s")
    d_dev, d_host = _digest(dev_out), _digest(host_out)
    if d_dev != d_host:
        raise RuntimeError(
            f"{name}: device output {d_dev} != host output {d_host}")
    if d_dev[1] < 1000:
        raise RuntimeError(f"{name}: suspiciously small output {d_dev[1]}")
    print(f"{name}: output identical to the host engine "
          f"({d_dev[1]} bytes, sha256 {d_dev[0][:16]})")
    return d_dev


def _write_image(path, size, seed, **kw):
    make_image(size, seed, **kw).tofile(path)


# ---------------------------------------------------------------- phases


def phase_env(work):
    print(f"nvidia-smi: {_gpu_line()}")
    import jax

    devs = jax.devices()
    d = devs[0]
    print(f"jax {jax.__version__}: platform={d.platform} "
          f"device_kind={d.device_kind} count={len(devs)}")
    _require_gpu(d)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def phase_native(work):
    t0 = time.perf_counter()
    p = subprocess.run(["make", "-B", "native"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    if p.returncode != 0:
        raise RuntimeError(f"native build failed:\n{p.stderr[-3000:]}")
    print(f"set-up: native emitter rebuilt in "
          f"{time.perf_counter() - t0:.3f} s")


def _lanes_block_counts(words_u8, mission, cpu):
    """Per-512-byte-block (accept, grep) counts from the independent
    jnp lanes (ops/classify.py + ops/runs.accept_mask), on the CPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from stringsext_tpu.encodings import KIND_UTF16BE, KIND_UTF16LE, \
        KIND_UTF8, encoding_kind
    from stringsext_tpu.ops import classify
    from stringsext_tpu.ops.runs import accept_mask, filter_words

    n = len(words_u8)
    b = jax.device_put(words_u8, cpu)
    kind = encoding_kind(mission.encoding_name)
    if kind == KIND_UTF8:
        lanes = classify.utf8_lanes(b, n)
    elif kind in (KIND_UTF16LE, KIND_UTF16BE):
        lanes = classify.utf16_lanes(b, kind == KIND_UTF16BE, n)
    else:
        lanes = classify.single_byte_lanes(b, mission.encoding_name, n)
    af_w, ubf_w = filter_words(mission)
    with jax.default_device(cpu):
        acc = accept_mask(lanes, jnp.asarray(af_w), jnp.asarray(ubf_w))
        g = -1 if mission.filter.grep_char is None else mission.filter.grep_char
        grep = acc & (lanes.cp == g)
        nb = n // 512
        a_blk = jnp.sum(acc.reshape(nb, 512).astype(jnp.int32), axis=1)
        g_blk = jnp.sum(grep.reshape(nb, 512).astype(jnp.int32), axis=1)
    return np.asarray(a_blk), np.asarray(g_blk)


def _time_device(fn, reps=20):
    """Best warm wall time of fn() (block_until_ready), seconds."""
    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def _trace_device_ms(fn, reps, logdir):
    """Device time per call of fn() from a profiler trace: the summed
    durations of the swar_counts XLA modules on the GPU plane (kernel
    events on the stream lines when the trace has no module line)."""
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn())
    jax.profiler.start_trace(logdir)
    try:
        for _ in range(reps):
            out = fn()
        jax.block_until_ready(out)
    finally:
        jax.profiler.stop_trace()
    paths = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                             recursive=True))
    if not paths:
        return None, "no xplane file"
    pd = ProfileData.from_file(paths[-1])
    mod_ns, kern_ns, lines = 0, 0, set()
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines.add(line.name)
            for ev in line.events:
                if line.name == "XLA Modules":
                    if "swar_counts" in ev.name:
                        mod_ns += ev.duration_ns
                elif line.name.startswith("Stream"):
                    kern_ns += ev.duration_ns
    ns = mod_ns or kern_ns
    src = "XLA Modules" if mod_ns else "stream kernel events"
    return (ns / reps / 1e6 if ns else None), f"{src}; lines {sorted(lines)}"


def phase_kernel(work):
    # This check compiles for the CPU as well: keep it out of a shared
    # persistent cache, which may hold CPU code built on another host.
    os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from stringsext_tpu.encodings import ALL_ENCODING_NAMES
    from stringsext_tpu.mission import Missions
    from stringsext_tpu.ops.specs import cjk_hot_spec, swar_mission_spec
    from stringsext_tpu.ops.swar import swar_counts

    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    _require_gpu(gpu)
    card = _card()

    # Mixed input: noisy image + zero margins at the stream edges and
    # around the 4 MiB slice boundary, so slice and full-chunk counts
    # agree block for block.
    raw = make_image(KERNEL_CHUNK, seed=11, noise=0.5)
    slice_n = 4 * MIB
    for lo, hi in ((0, 4096), (slice_n - 4096, slice_n + 4096),
                   (KERNEL_CHUNK - 4096, KERNEL_CHUNK)):
        raw[lo:hi] = 0
    words = raw.view(np.int32).reshape(-1, 128)
    w_gpu = jax.device_put(words, gpu)
    w_cpu = jax.device_put(words, cpu)
    w_cpu_slice = jax.device_put(words[: slice_n // 512], cpu)

    ms3 = Missions.new(flag_encoding=["UTF-8", "utf-16le", "utf-16be"],
                       flag_grep_char="63")
    specs3 = tuple(swar_mission_spec(m) for m in ms3.v)
    names = ["ascii"] + [e for e in ALL_ENCODING_NAMES if e != "ascii"]
    msa = Missions.new(flag_encoding=names, flag_grep_char="63")
    jobs = []
    for m in msa.v:
        sp = swar_mission_spec(m)
        exact = sp is not None
        sp = sp or cjk_hot_spec(m)
        if sp is not None:
            jobs.append((m, sp, exact))
    specsa = tuple(sp for _m, sp, _e in jobs)
    print(f"specs: flagship {len(specs3)}, all-encodings {len(specsa)} "
          f"({sum(e for *_x, e in jobs)} exact-count)")

    for label, sp, hot in (("flagship", specs3, False),
                           ("flagship hot-only", specs3, True),
                           ("all-encodings hot-only", specsa, True)):
        t0 = time.perf_counter()
        comp = swar_counts.lower(w_gpu, sp, hot_only=hot).compile()
        print(f"set-up: compiled swar_counts [{label}] at 32 MiB in "
              f"{time.perf_counter() - t0:.3f} s")
        print(f"memory_analysis [{label}]: {comp.memory_analysis()}")

    # Exact equality, flagship at 32 MiB: against the jnp lanes (accept,
    # grep) and against the same function on the CPU (all fields).
    got3 = np.asarray(swar_counts(w_gpu, specs3))
    ref3 = np.asarray(swar_counts(w_cpu, specs3))
    if not np.array_equal(got3, ref3):
        raise RuntimeError("flagship counts: GPU != CPU (same function)")
    for j, m in enumerate(ms3.v):
        a_blk, g_blk = _lanes_block_counts(raw, m, cpu)
        if not np.array_equal(got3[2 * j] >> 20, a_blk):
            raise RuntimeError(f"{m.encoding_name}: accept counts differ "
                               f"from the jnp lanes")
        if not np.array_equal(got3[2 * j + 1], g_blk):
            raise RuntimeError(f"{m.encoding_name}: grep counts differ "
                               f"from the jnp lanes")
    print(f"flagship: per-block counts equal to the jnp lanes and to the "
          f"CPU at 32 MiB ({int((got3[0] >> 20).sum())} UTF-8 accepts)")

    # All-encodings: full chunk on the GPU, compared on the 4 MiB slice.
    gota = np.asarray(swar_counts(w_gpu, specsa, hot_only=True))
    nb = slice_n // 512
    refa = np.asarray(swar_counts(w_cpu_slice, specsa, hot_only=True))
    if not np.array_equal(gota[:, :nb], refa):
        raise RuntimeError("all-encodings counts: GPU != CPU on 4 MiB")
    slice_u8 = raw[:slice_n]
    for j, (m, _sp, exact) in enumerate(jobs):
        if not exact:
            continue
        a_blk, g_blk = _lanes_block_counts(slice_u8, m, cpu)
        if not (np.array_equal(gota[2 * j, :nb] >> 20, a_blk)
                and np.array_equal(gota[2 * j + 1, :nb], g_blk)):
            raise RuntimeError(f"{m.encoding_name}: counts differ from "
                               f"the jnp lanes on the 4 MiB slice")
    print("all-encodings: exact-count specs equal to the jnp lanes, "
          "plausible-byte specs equal to the CPU, on the 4 MiB slice")

    bound_us = KERNEL_CHUNK / READ_BW_H100 * 1e6
    print(f"read-once bound at 32 MiB: {bound_us:.3f} us (3.35 TB/s)")
    groups24 = [specsa[i:i + 24] for i in range(0, len(specsa), 24)]
    timed = {
        "flagship": lambda: swar_counts(w_gpu, specs3),
        "flagship hot-only": lambda: swar_counts(w_gpu, specs3,
                                                 hot_only=True),
        "all-encodings hot-only, one launch":
            lambda: swar_counts(w_gpu, specsa, hot_only=True),
        "all-encodings hot-only, groups of 24":
            lambda: [swar_counts(w_gpu, g, hot_only=True) for g in groups24],
    }
    for label, fn in timed.items():
        t = _time_device(fn)
        print(f"warm wall [{label}] at 32 MiB: {t * 1e6:.1f} us "
              f"= {t * 1e6 / bound_us:.2f}x the read-once bound, on {card}")
    for label in ("flagship", "all-encodings hot-only, one launch"):
        try:
            ms_, how = _trace_device_ms(
                timed[label], 10, os.path.join(work, "trace", label[:8]))
            msg = "not measured" if ms_ is None else f"{ms_ * 1e3:.1f} us"
            print(f"trace device time [{label}] at 32 MiB: {msg} "
                  f"({how}), on {card}")
        except Exception as e:  # the trace is a measurement aid only
            print(f"trace device time [{label}]: not measured "
                  f"({type(e).__name__}: {e})")


def phase_buffered(work):
    path = os.path.join(work, "buffered.img")
    _write_image(path, BUFFERED_SIZE, seed=1)
    want = _device_vs_host("buffered", FLAGSHIP_ARGS + [path], work)
    # The same image on the device engine's other path: the run-table
    # feed off, counts-pass hot maps only.
    out = os.path.join(work, "buffered.hotmap.out")
    err, dt = _cli(FLAGSHIP_ARGS + [path], out,
                   {"STRINGSEXT_RUNTABLE_FEED": "0"})
    prof = _profile(err)
    print(f"buffered: device engine, feed off, wall {dt:.3f} s, "
          f"profile {prof}")
    if _calls(prof, "device.dispatch") <= 0 or _digest(out) != want:
        raise RuntimeError("buffered: the feed-off device run differs")
    os.remove(out)


def phase_streamed(work):
    path = os.path.join(work, "streamed.img")
    _write_image(path, STREAMED_SIZE, seed=2)
    _device_vs_host("streamed", FLAGSHIP_ARGS + [path], work)
    os.remove(path)


def _list_encodings():
    p = subprocess.run(
        [sys.executable, "-m", "stringsext_tpu.cli", "--list-encodings"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env=dict(os.environ, STRINGSEXT_DEVICE_PROBE="0"))
    lines = p.stdout.splitlines()
    i = next(k for k, ln in enumerate(lines) if ln.startswith("ENC_NAME"))
    names = []
    for ln in lines[i + 1:]:
        if not ln.startswith("\t") or ln.strip().startswith("Warning"):
            if names:
                break
            continue
        names.append(ln.strip())
    if len(names) < 40:
        raise RuntimeError(f"--list-encodings gave {names}")
    return names


def phase_all_encodings(work):
    names = _list_encodings()
    path = os.path.join(work, "mixed.img")
    _write_image(path, ALL_ENC_SIZE, seed=3, noise=0.02)
    argv = ["-t", "x", "-n", "6"]
    for e in names:
        argv += ["-e", e]
    print(f"all-encodings: {len(names)} encodings")
    _device_vs_host("all-encodings", argv + [path], work)


def phase_oracle(work):
    path = os.path.join(work, "golden_shape.bin")
    _write_image(path, ORACLE_SIZE, seed=4, noise=0.5)
    dev_out = os.path.join(work, "oracle.device.out")
    py_out = os.path.join(work, "oracle.python.out")
    err, t_dev = _cli(ORACLE_ARGS + ["--engine", "device", path], dev_out)
    if _calls(_profile(err), "device.dispatch") <= 0:
        raise RuntimeError("oracle: device engine did not dispatch")
    _, t_py = _cli(ORACLE_ARGS + ["--engine", "python", path], py_out,
                   timeout=600)
    d_dev, d_py = _digest(dev_out), _digest(py_out)
    if d_dev != d_py:
        raise RuntimeError(f"oracle: device {d_dev} != python {d_py}")
    print(f"oracle: device output identical to the Python oracle "
          f"({d_dev[1]} bytes; device {t_dev:.3f} s, python {t_py:.3f} s)")


def phase_cache(work):
    path = os.path.join(work, "buffered.img")
    if not os.path.exists(path):
        _write_image(path, BUFFERED_SIZE, seed=1)
    out = os.path.join(work, "cache.device.out")
    err, dt = _cli(FLAGSHIP_ARGS + [path], out,
                   {"JAX_LOG_COMPILES": "1"})
    if _calls(_profile(err), "device.dispatch") <= 0:
        raise RuntimeError("cache: device engine did not dispatch")
    slow = []
    compiles = 0
    for ln in err.splitlines():
        m = re.search(r"Finished XLA compilation of (\S+) in ([0-9.]+) sec",
                      ln)
        if m:
            compiles += 1
            if float(m.group(2)) >= 1.0:
                slow.append((m.group(1), float(m.group(2))))
    hits = err.count("Persistent compilation cache hit")
    print(f"cache: second process wall {dt:.3f} s, {compiles} compiles "
          f"logged, {hits} persistent-cache hits")
    if slow:
        raise RuntimeError(f"cache: recompiled {slow} in the second process")
    ref = os.path.join(work, "buffered.device.out")
    if os.path.exists(ref) and _digest(ref) != _digest(out):
        raise RuntimeError("cache: second process output differs")


def phase_four_chips(work):
    """The mesh path: the CLI with four visible cards and --mesh (the
    counts pass sharded with ppermute halos; the run-table feed off, so
    the counts pass decides every hot map) against one visible card,
    then the sharded scan dry run on the cards."""
    print(f"nvidia-smi: {_gpu_line()}")
    p = subprocess.run(["make", "-B", "native"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    if p.returncode != 0:
        raise RuntimeError(f"native build failed:\n{p.stderr[-3000:]}")
    path = os.path.join(work, "four.img")
    _write_image(path, FOUR_CHIP_SIZE, seed=5)
    argv = FLAGSHIP_ARGS + ["--engine", "device", path]
    hot = {"STRINGSEXT_RUNTABLE_FEED": "0"}
    out4 = os.path.join(work, "four.out")
    out1 = os.path.join(work, "one.out")
    err4, t4 = _cli(argv[:-1] + ["--mesh", path], out4, hot)
    prof4 = _profile(err4)
    if _calls(prof4, "device.dispatch") <= 0:
        raise RuntimeError("four cards: device engine did not dispatch")
    err1, t1 = _cli(argv, out1, dict(hot, CUDA_VISIBLE_DEVICES="0"))
    d4, d1 = _digest(out4), _digest(out1)
    if d4 != d1:
        raise RuntimeError(f"four-card output {d4} != one-card {d1}")
    print(f"four cards: mesh output identical to one card ({d4[1]} bytes;"
          f" wall 4 cards {t4:.3f} s, 1 card {t1:.3f} s)")
    print(f"four cards: profile {prof4}")
    print(f"one card: profile {_profile(err1)}")
    dev = _dryrun_multichip(4)
    if dev["platform"] != "gpu" or dev["count"] != 4:
        raise RuntimeError(f"dryrun_multichip ran on {dev}")
    return dev


def _dryrun_multichip(n):
    """__graft_entry__.dryrun_multichip(n) in a child process; returns
    the devices it ran on as JAX reports them."""
    code = ("import json, sys; sys.path.insert(0, '.');"
            "import __graft_entry__ as g; g.dryrun_multichip(%d);"
            "import jax; d = jax.devices();"
            "print('DEVICES ' + json.dumps({'platform': d[0].platform,"
            " 'kind': d[0].device_kind, 'count': len(d)}))" % n)
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    if p.returncode != 0:
        raise RuntimeError(f"dryrun_multichip({n}) failed:\n"
                           f"{p.stderr[-3000:]}")
    print(p.stdout.strip().splitlines()[0][:300])
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("DEVICES ")]
    return json.loads(line[-1][len("DEVICES "):])


_PHASE_FN = {
    "env": phase_env, "native": phase_native, "kernel": phase_kernel,
    "buffered": phase_buffered, "streamed": phase_streamed,
    "all-encodings": phase_all_encodings, "oracle": phase_oracle,
    "cache": phase_cache, "four-chips": phase_four_chips,
}


# ---------------------------------------------------------------- driver


def _run_phase(name, work, timeout, card):
    """Run one phase in a child process (its own process group, killed
    whole on timeout). Returns (rc, result dict or None)."""
    t0 = time.perf_counter()
    p = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase", name,
         "--work", work],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO,
        start_new_session=True, text=True,
    )
    result = None
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, _ = p.communicate()
        out += f"\nphase {name} timed out after {timeout:.0f} s"
        p.returncode = 124
    for ln in out.splitlines():
        if ln.startswith("PHASE-RESULT "):
            result = json.loads(ln[len("PHASE-RESULT "):])
        else:
            print(f"[{name}] {ln}")
    dt = time.perf_counter() - t0
    print(f"[{name}] bring-up timing (not a benchmark): phase wall "
          f"{dt:.3f} s, rc {p.returncode}, on {card}")
    sys.stdout.flush()
    return p.returncode, result


def _child(name, work):
    try:
        res = _PHASE_FN[name](work)
    except Exception as e:
        import traceback

        traceback.print_exc(file=sys.stdout)
        print(f"FAILED: {type(e).__name__}: {e}")
        return 1
    if res is not None:
        print("PHASE-RESULT " + json.dumps(res))
    return 0


def main(argv):
    if "--phase" in argv:
        i = argv.index("--phase")
        return _child(argv[i + 1], argv[argv.index("--work") + 1])
    if not os.path.isdir(os.path.join(REPO, "stringsext_tpu")):
        print("chip_smoke: the stringsext_tpu package is not beside this "
              "script", file=sys.stderr)
        return 2
    if "--four-chips" in argv:
        phases = ["four-chips"]
    elif "--only" in argv:
        phases = argv[argv.index("--only") + 1].split(",")
        if phases[0] != "env":
            phases.insert(0, "env")
    else:
        phases = list(PHASES)
    unknown = [p for p in phases if p not in _PHASE_FN]
    if unknown:
        print(f"chip_smoke: unknown phases {unknown}", file=sys.stderr)
        return 2
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    os.environ["STRINGSEXT_PROBE_CACHE"] = os.path.join(work, "probe.json")
    t_start = time.perf_counter()
    device = None
    try:
        card = _card()
    except (OSError, RuntimeError, subprocess.SubprocessError, IndexError):
        card = "no card found by nvidia-smi"
    try:
        for name in phases:
            left = BUDGET_S - (time.perf_counter() - t_start)
            if left <= 0:
                print(f"chip_smoke: out of time before phase {name}")
                return 1
            rc, res = _run_phase(name, work, left, card)
            if rc != 0:
                print(f"chip_smoke: phase {name} failed (rc {rc})")
                return 1
            if name in ("env", "four-chips"):
                device = res
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if not device or device.get("platform") != "gpu":
        print("chip_smoke: no GPU device was reported")
        return 1
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.3f} s")
    print(_gpu_line())
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
