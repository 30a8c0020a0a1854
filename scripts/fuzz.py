"""Differential fuzz: python vs native vs device engines must agree
byte-for-byte on random configs and corpora.

Usage: python scripts/fuzz.py [seconds] [seed]
Prints PASS/FAIL summary; saves any failing repro to /tmp/fuzz_fail_*.
"""

import io
import os
import random
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# Force the CPU backend via the config so fuzzing never touches (or
# waits on) real hardware.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax

jax.config.update("jax_platforms", "cpu")

from stringsext_tpu.cli import parse_args
from stringsext_tpu.run import run

ENCODINGS = [
    "UTF-8", "utf-16le", "utf-16be", "ascii", "windows-1252", "KOI8-R",
    "IBM866", "iso-8859-7", "euc-kr", "shift_jis", "gb18030", "euc-jp",
    "big5", "iso-2022-jp", "windows-874", "x-mac-cyrillic",
]
PLANTS = [
    ("utf-8", "déjà vu €uro ? text with spaces"),
    ("utf-16-le", "UTF16 Кириллица ? string"),
    ("utf-16-be", "BE Ελληνικά ? string"),
    ("utf-16-le", "astral \U0001F600\U0001D11E pairs ? \U00020000"),
    ("utf-16-be", "astral \U0001F680 be ? pair"),
    ("cp949", "한국어 ? 테스트"),
    ("cp932", "日本語?テスト"),
    ("gb18030", "中文?测试\U00020000"),
    ("euc_jp", "日本語の?テスト"),
    ("big5hkscs", "中文?字元測試"),
    ("iso2022_jp", "mode ? 日本語 switch"),
]


def random_config(rng):
    encs = rng.sample(ENCODINGS, rng.randint(1, 3))
    argv = []
    for e in encs:
        if rng.random() < 0.2:
            e = f"{e},{rng.randint(2, 8)}"
        argv += ["-e", e]
    argv += ["-t", rng.choice("xdo")]
    if rng.random() < 0.5:
        argv += ["-u", rng.choice(["Default", "Common", "Cyrillic", "Asian",
                                   "Latin", "0xfffffffffffc"])]
    if rng.random() < 0.3:
        argv += ["-a", rng.choice(["All-Ctrl", "All-Ctrl+Wsp", "All"])]
    if rng.random() < 0.3:
        argv += ["-g", str(rng.choice([63, 47, 32, 58]))]
    if rng.random() < 0.3:
        argv += ["-n", str(rng.randint(2, 12))]
    if rng.random() < 0.3:
        argv += ["-q", str(rng.randint(6, 40))]
    if rng.random() < 0.2:
        argv += ["-r"]
    if rng.random() < 0.2:
        argv += ["-s", str(rng.randint(0, 100000))]
    if rng.random() < 0.1:
        argv += ["-c"]
    return argv


def random_corpus(rng, nprng):
    size = rng.choice([64, 700, 4095, 4096, 4097, 9000, 20000])
    if rng.random() < 0.15:
        # Large sparse corpus with whole-slice cold gaps: exercises the
        # segment-parallel split points (quiescent cold slices) and
        # strings ending exactly at split-eligible boundaries.
        size = rng.choice([32768, 65536, 131072])
        data = bytearray(size)
        pos = 0
        while pos < size - 4096:
            gap = 4096 * rng.randint(1, 4)
            pos += gap
            isl = rng.randint(8, 3000)
            if pos + isl >= size:
                break
            data[pos : pos + isl] = nprng.integers(
                0, 256, size=isl, dtype=np.uint8
            ).tobytes()
            # half the time, butt a string right against the gap edge
            if rng.random() < 0.5:
                codec, text = rng.choice(PLANTS)
                t = text.encode(codec)
                if len(t) < isl:
                    data[pos : pos + len(t)] = t
            pos += isl
        return bytes(data)
    if rng.random() < 0.2:
        # Text-dense corpus: long accepted-ASCII / UTF-16 text runs
        # interleaved with junk - the emitter full-window fast lanes
        # (accepted-ASCII, UTF-16 BMP) and the sterile-call lookahead
        # trigger constantly here, and run edges land at every
        # window-grid phase.
        data = bytearray()
        words = [b"lorem", b"ipsum", b"dolor", b"sit", b"amet", b"sed"]
        while len(data) < size:
            r = rng.random()
            if r < 0.5:
                n = rng.randint(3, 120)
                data += b" ".join(
                    words[rng.randint(0, len(words) - 1)]
                    for _ in range(n)
                ) + b". "
            elif r < 0.75:
                n = rng.randint(2, 40)
                data += (" ".join(
                    "text" for _ in range(n)
                )).encode(rng.choice(["utf-16le", "utf-16be"]))
            else:
                n = rng.randint(4, 200)
                data += nprng.integers(
                    0, 256, size=n, dtype=np.uint8
                ).tobytes()
        data = bytearray(data[:size])
    elif rng.random() < 0.35:
        # Sparse corpus: mostly zeros (cold blocks for the engine=device
        # hot-range skipper) with random hot islands and CJK chain-byte
        # noise (0x81-0xFE runs) that lands lead/trail bytes right at
        # skip-window boundaries - the align_cursor stress case.
        data = bytearray(size)
        for _ in range(rng.randint(1, 6)):
            off = rng.randint(0, max(0, size - 24))
            ln = rng.randint(1, 24)
            if rng.random() < 0.5:
                data[off : off + ln] = nprng.integers(
                    0x81, 0xFF, size=ln, dtype=np.uint8
                ).tobytes()
            else:
                data[off : off + ln] = nprng.integers(
                    0, 256, size=ln, dtype=np.uint8
                ).tobytes()
    else:
        data = bytearray(
            nprng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
        )
    for _ in range(rng.randint(0, 8)):
        codec, text = rng.choice(PLANTS)
        t = text.encode(codec)
        if size > len(t) + 2:
            off = rng.randint(0, size - len(t) - 1)
            data[off : off + len(t)] = t
    # sprinkle structure: zeros runs, escapes, surrogate-ish bytes
    for _ in range(rng.randint(0, 5)):
        off = rng.randint(0, max(0, size - 20))
        kind = rng.random()
        if kind < 0.3:
            data[off : off + 16] = b"\x00" * 16
        elif kind < 0.6 and size > 24:
            data[off] = 0x1B
        else:
            data[off : off + 4] = bytes([0x41, 0xD8, 0x42, 0xDC])
    return bytes(data)


def main():
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 300
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 1234
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)

    t0 = time.time()
    trials = 0
    fails = 0
    while time.time() - t0 < seconds:
        # Trial-counter-derived (NOT rng-drawn, so seed-replay order is
        # unchanged) toggles for the slab-parallel merge renderer and
        # the device run-table feed - both are native code that would
        # otherwise never engage under fuzz (the 2-core default picks
        # the fused merge; the feed is opt-in).
        os.environ["STRINGSEXT_MERGE_WORKERS"] = ("1", "4")[trials % 2]
        # The feed defaults ON under engine=device now; set it explicitly
        # both ways so feed and hot-map paths stay fuzzed.
        os.environ["STRINGSEXT_RUNTABLE_FEED"] = (
            "1" if trials % 3 == 0 else "0")
        argv = random_config(rng)
        blob = random_corpus(rng, nprng)
        nfiles = rng.randint(1, 3)
        paths = []
        try:
            for k in range(nfiles):
                f = tempfile.NamedTemporaryFile(delete=False)
                f.write(blob[k::nfiles] if nfiles > 1 else blob)
                f.close()
                paths.append(f.name)
            outs = {}
            from stringsext_tpu import run as run_mod

            # Randomize the segment-parallel split count so every trial
            # exercises a different split placement (1 = no splits),
            # and toggle the opt-in host-side hot-map prepass so its
            # skip/segmentation machinery is fuzzed too.
            run_mod._SEGMENT_MAX = rng.choice([1, 2, 3, 5, 8])
            # Trial-counter-derived (no rng draw): drop the probe
            # segmentation size floor on odd trials so the default
            # probe-split path (buffered AND per-streaming-chunk) gets
            # fuzzed on these small corpora.
            run_mod._SEGMENT_PROBE_MIN = (1, 4 << 20)[trials % 2]
            os.environ["STRINGSEXT_HOST_HOTMAP"] = rng.choice(["0", "1"])
            # STRINGSEXT_FUZZ_ENGINES=python,auto -> ASan mode: skip
            # every jax-tracing path (ASan's __cxa_throw interceptor
            # CHECK-fails inside jaxlib's MLIR bindings, a jaxlib/ASan
            # incompatibility - not a bug here). Same rng draw order.
            engines = os.environ.get(
                "STRINGSEXT_FUZZ_ENGINES", "python,auto,device"
            ).split(",")
            for engine in engines:
                args = parse_args(argv + paths)
                buf = io.BytesIO()
                run(args, out=buf, engine=engine)
                outs[engine] = buf.getvalue()
            if "auto" in engines:
                # Real-fd output variant: the fused se_merge_fd +
                # SE_INREF zero-copy pipeline only engages on OS-level
                # outputs (BytesIO has no fileno), so the passes above
                # never touch it - and it is the most memory-safety-
                # critical path (C resolves bit-63 offsets against
                # per-stream input buffers). No rng draws here, so
                # seed-replay order is unchanged.
                ofd, opath = tempfile.mkstemp()
                try:
                    args = parse_args(argv + paths)
                    with os.fdopen(ofd, "wb") as fo:
                        run(args, out=fo, engine="auto")
                    with open(opath, "rb") as fo:
                        outs["auto-fd"] = fo.read()
                finally:
                    os.unlink(opath)
            if (os.environ.get("STRINGSEXT_RUNTABLE_FEED") == "1"
                    and nfiles == 1):
                # Run-table feed lane differential WITHOUT jax (so the
                # ASan build covers the new C lane too): the host-built
                # feed arrays are identical to the device ones
                # (runtable_feed device=False; tests pin equality), and
                # a fed scan must equal an unfed scan byte-for-byte.
                # No rng draws (replay order unchanged).
                from stringsext_tpu import native as _nat
                from stringsext_tpu.encodings import encoding_kind as _ek
                from stringsext_tpu.input import LoadedStream, slice_table
                from stringsext_tpu.mission import Missions
                from stringsext_tpu.ops.device_events import (
                    FEED_KINDS,
                    runtable_feed,
                )

                args = parse_args(argv + [paths[0]])
                ms = Missions.from_args(args)
                data = np.frombuffer(blob, np.uint8)
                sl = slice_table(LoadedStream(data, [(1, 0, len(data))]))
                for m in ms.v:
                    k3 = _ek(m.encoding_name)
                    if (k3 not in FEED_KINDS
                            or not _nat.native_supported(k3)):
                        continue
                    feed = runtable_feed(data, m, device=False)
                    if feed is None:
                        break
                    b_res, b_sb = _nat.native_scan(m, data, *sl)
                    f_res, f_sb = _nat.native_scan(
                        m, data, *sl, runtable_feed=feed)
                    ok = bytes(b_sb) == bytes(f_sb) and all(
                        np.array_equal(b_res[k2], f_res[k2])
                        for k2 in b_res
                    )
                    if not ok:
                        fails += 1
                        fn = f"/tmp/fuzz_fail_{trials}.bin"
                        with open(fn, "wb") as f:
                            f.write(blob)
                        print(f"FAIL trial={trials} feed-lane "
                              f"{m.encoding_name} argv={argv} repro={fn}",
                              flush=True)
                    break  # one feed-kind mission per trial
            if nfiles == 1:
                # stdin streaming (state-carrying chunk scans) must
                # match the buffered single-file scan byte-for-byte;
                # tiny chunk sizes force carries at every seam.
                from stringsext_tpu.mission import Missions
                from stringsext_tpu.run import _run_streaming_stdin

                args = parse_args(argv + ["-"])
                ms = Missions.from_args(args)
                from stringsext_tpu import native
                from stringsext_tpu.encodings import encoding_kind

                if all(
                    native.native_supported(encoding_kind(m.encoding_name))
                    for m in ms.v
                ):
                    chunk_b = 4096 * rng.choice([1, 2, 3])
                    # draw first (stable replay order), then clamp
                    # to the allowed engine set (ASan mode).
                    s_eng = (lambda e: e if e in engines else "auto")(
                        rng.choice(["auto", "device"])
                    )
                    buf = io.BytesIO()
                    _run_streaming_stdin(
                        args, ms, buf, src=io.BytesIO(blob),
                        chunk_bytes=chunk_b, engine=s_eng,
                    )
                    outs["stream"] = buf.getvalue()
                    # Same streaming run to a REAL fd: engages the
                    # per-chunk fused merge + SE_INREF offsets into the
                    # chunk buffers (incl. held-back boundary rows).
                    # No extra rng draws.
                    ofd, opath = tempfile.mkstemp()
                    try:
                        args = parse_args(argv + ["-"])
                        ms_fd = Missions.from_args(args)
                        with os.fdopen(ofd, "wb") as fo:
                            _run_streaming_stdin(
                                args, ms_fd, fo, src=io.BytesIO(blob),
                                chunk_bytes=chunk_b, engine=s_eng,
                            )
                        with open(opath, "rb") as fo:
                            outs["stream-fd"] = fo.read()
                    finally:
                        os.unlink(opath)
            if "device" in engines and trials % 2 == 1:
                # (gated on the full engine set: ASan mode must not
                # import jax, which parallel.distributed does)
                # Randomized DISTRIBUTED differential (VERDICT r3 item
                # 4): the in-process N-rank simulator (boundary search,
                # O(shard) reads, entry-mode composition, rank-0
                # holdback merge - distributed.simulate_ranks, the same
                # pure functions distributed_run executes per rank)
                # must reproduce the single-process stream
                # byte-for-byte on random corpora x mission sets x
                # nprocs, multi-file included. nprocs is trial-derived
                # (no rng draws: replay order unchanged); shard reads
                # must partition the input exactly when a real split
                # happened.
                from stringsext_tpu.parallel import distributed as D

                nprocs = 2 + (trials // 2) % 4  # 2..5
                d_args = parse_args(argv + paths)
                # Trial-derived engine (no rng draws): feed trials run
                # the ranks with engine=device so the per-shard run-table
                # feed + device hot maps are fuzzed too.
                d_eng = "device" if trials % 3 == 0 else "auto"
                sim_out, st = D.simulate_ranks(
                    d_args, paths, nprocs, engine=d_eng)
                outs[f"dist{nprocs}"] = sim_out
                total = sum(os.path.getsize(p) for p in paths)
                bounds = st["bounds"]
                real_split = len(set(bounds)) > 2
                if real_split and sum(st["shard_read"]) != total:
                    fails += 1
                    print(f"FAIL trial={trials} dist shard reads "
                          f"{st['shard_read']} != total {total} "
                          f"argv={argv}", flush=True)
            if not all(v == outs["python"] for v in outs.values()):
                fails += 1
                fn = f"/tmp/fuzz_fail_{trials}.bin"
                with open(fn, "wb") as f:
                    f.write(blob)
                bad = [e for e in outs if outs[e] != outs["python"]]
                print(f"FAIL trial={trials} argv={argv} engines={bad} repro={fn}",
                      flush=True)

            # Checkpoint/resume: a scan split at a random slice
            # boundary with the state JSON-round-tripped between the
            # halves must equal the one-shot scan (native state ABI +
            # utils/checkpoint serialization). Probabilistic: it
            # rescans every mission twice. NOTE for failure replay:
            # this draws from rng AFTER the streaming branch's draws.
            if rng.random() < 0.25:
                from stringsext_tpu import native
                from stringsext_tpu.encodings import encoding_kind
                from stringsext_tpu.input import LoadedStream, slice_table
                from stringsext_tpu.mission import Missions
                from stringsext_tpu.utils import checkpoint

                args = parse_args(argv + [paths[0]])
                ms = Missions.from_args(args)
                if all(
                    native.native_supported(encoding_kind(m.encoding_name))
                    for m in ms.v
                ):
                    data = np.frombuffer(blob[0::nfiles] if nfiles > 1 else blob,
                                         np.uint8)
                    stream = LoadedStream(data, [(1, 0, len(data))])
                    sl = slice_table(stream)
                    nsl = len(sl[0])
                    cut = rng.randint(1, nsl - 1) if nsl >= 2 else 0
                    for mi, m in enumerate(ms.v if cut else []):
                        whole, sb_whole = native.native_scan(m, data, *sl)
                        st = checkpoint.fresh_states(ms)[mi]
                        parts, bufs = [], []
                        for lo, hi in ((0, cut), (cut, nsl)):
                            seg = tuple(a[lo:hi] for a in sl)
                            res, sb = native.native_scan(
                                m, data, *seg, state=st
                            )
                            st = checkpoint.state_to_dict([st], hi)[
                                "missions"
                            ][0]
                            parts.append(res)
                            bufs.append(sb)
                        ok = b"".join(bufs) == sb_whole and all(
                            np.array_equal(
                                np.concatenate([p[f] for p in parts]),
                                whole[f],
                            )
                            for f in ("position", "precision", "completes",
                                      "file_id", "str_len")
                        )
                        if not ok:
                            fails += 1
                            fn = f"/tmp/fuzz_fail_ckpt_{trials}.bin"
                            with open(fn, "wb") as f:
                                f.write(blob)
                            print(
                                f"FAIL(ckpt) trial={trials} argv={argv} "
                                f"enc={m.encoding_name} cut={cut} repro={fn}",
                                flush=True,
                            )
        finally:
            for p in paths:
                os.unlink(p)
        trials += 1
        if trials % 200 == 0:
            # Every random filter config compiles fresh CPU kernels;
            # unbounded, the jit cache grows to several GB over a long
            # run (observed: LLVM "Cannot allocate memory" at ~7 GB
            # RSS after ~30 min).
            jax.clear_caches()
    print(f"fuzz done: {trials} trials, {fails} failures, "
          f"{time.time() - t0:.0f}s")
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
