"""TRUE multi-process distributed scan tests: 2 OS processes join one
jax.distributed runtime (Gloo collectives over localhost - the CI
stand-in for a 2-host pod slice, SURVEY.md sec. 4).

Round 1 case ("counts"): the mesh-sharded counts kernel over an 8-way
"data" axis with cross-PROCESS ppermute halo exchange, checked
bit-exactly against the single-device pass.

Round 2 case ("cli"): the FULL pipeline - each process scans its
quiescent shard of a shared input file, findings (not counts) are
shipped to process 0, merged with the finding.rs:92-109 key and
printed; process 0's bytes must equal the single-process engine=auto
output exactly (the reference's whole observable behavior,
main.rs:93-175). Includes the dense-corpus fallback (no safe split ->
rank 0 absorbs) and a boundary-straddling string.

Round 3 additions: the O(shard) data plane (the "big" corpus pins
bytes-read per rank at shard + bounded windows, NOT the whole input),
the CJK/ISO-2022-JP mission set ("cjk" corpus: Shift_JIS + gb18030 +
ISO-2022-JP + UTF-8 with a REAL split, incl. a jis mode left open
across shard boundaries - entry modes ride the transfer composition),
and the TCP gather-to-rank-0 (no padded allgather).

The reference has no distributed tests (nothing distributed to test);
this pins the added multi-host path end-to-end at the
process boundary, not just on a virtual in-process mesh.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER_ENV = "STRINGSEXT_DIST_TEST_WORKER"


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cli_worker_main():
    pid = int(os.environ[_WORKER_ENV])
    coord = os.environ["STRINGSEXT_DIST_COORD"]
    work = os.environ["STRINGSEXT_DIST_WORKDIR"]
    nprocs = int(os.environ.get("STRINGSEXT_DIST_NPROCS", "2"))
    os.environ["JAX_PLATFORMS"] = "cpu"

    import io

    import jax

    jax.config.update("jax_platforms", "cpu")
    from stringsext_tpu.parallel import distributed

    distributed.initialize(
        coordinator_address=coord, num_processes=nprocs, process_id=pid
    )
    assert jax.process_count() == nprocs

    from stringsext_tpu.cli import parse_args
    from stringsext_tpu.mission import Missions

    cases = [
        ("sparse", ["-t", "x", "-e", "UTF-8", "-e", "utf-16le"]),
        ("dense", ["-t", "d", "-e", "UTF-8", "-e", "KOI8-R", "-n", "5"]),
        ("cjk", ["-t", "x", "-e", "Shift_JIS", "-e", "gb18030",
                 "-e", "ISO-2022-JP", "-e", "UTF-8", "-n", "4"]),
        ("big", ["-t", "x", "-e", "UTF-8", "-e", "utf-16le"]),
    ]
    for name, argv in cases:
        corpus = os.path.join(work, f"{name}.bin")
        if not os.path.exists(corpus):
            continue  # heavyweight cases only exist for some tests
        args = parse_args(argv + [corpus])
        ms = Missions.from_args(args)
        buf = io.BytesIO()
        rc = distributed.distributed_run(args, ms, buf, engine="auto")
        assert rc == 0
        if name == "big":
            # O(shard) data plane: each rank reads only its shard plus
            # the bounded boundary-search windows - NOT the whole input
            # (input.rs:120-167: each byte read once; here once per
            # OWNING rank).
            total = os.path.getsize(corpus)
            read = distributed.LAST_STATS["bytes_read"]
            assert read < 0.75 * total, (read, total,
                                         distributed.LAST_STATS)
        if name == "sparse":
            # engine=device (device hot maps over each rank's shard)
            # must produce the identical stream
            buf_t = io.BytesIO()
            rc = distributed.distributed_run(args, ms, buf_t,
                                             engine="device")
            assert rc == 0
            assert buf_t.getvalue() == buf.getvalue()
            # KV-store-less gather fallback (chunked allgather rounds):
            # forced via the env hook; must stay byte-identical and
            # warn once on stderr (asserted by the parent harness).
            os.environ["STRINGSEXT_FORCE_GATHER_FALLBACK"] = "1"
            try:
                buf_f = io.BytesIO()
                rc = distributed.distributed_run(args, ms, buf_f,
                                                 engine="auto")
                assert rc == 0
                assert buf_f.getvalue() == buf.getvalue()
            finally:
                del os.environ["STRINGSEXT_FORCE_GATHER_FALLBACK"]
        if pid == 0:
            expected = open(os.path.join(work, f"{name}.expected"),
                            "rb").read()
            got = buf.getvalue()
            assert got == expected, (
                f"case {name}: {len(got)} vs {len(expected)} bytes; "
                f"first diff at "
                f"{next((i for i, (a, b) in enumerate(zip(got, expected)) if a != b), min(len(got), len(expected)))}"
            )
        else:
            assert buf.getvalue() == b""  # only process 0 prints
        # sparse and cjk corpora must actually split across processes
        if name in ("sparse", "cjk"):
            from stringsext_tpu.input import load_stream

            stream = load_stream([corpus])
            bounds = distributed.shard_boundaries(stream, ms, nprocs)
            assert bounds is not None and 0 < bounds[1] < bounds[2], bounds

    # CLI flag path: run() with --dist-nprocs/--dist-rank/--dist-coord
    # must route to the same distributed scan (initialize() tolerates
    # the prior join with the same world size).
    from stringsext_tpu.run import run

    corpus = os.path.join(work, "sparse.bin")
    args = parse_args(
        ["-t", "x", "-e", "UTF-8", "-e", "utf-16le",
         "--dist-nprocs", str(nprocs), "--dist-rank", str(pid),
         "--dist-coord", coord, corpus]
    )
    buf = io.BytesIO()
    rc = run(args, out=buf)
    assert rc == 0
    if pid == 0:
        expected = open(os.path.join(work, "sparse.expected"), "rb").read()
        assert buf.getvalue() == expected
    else:
        assert buf.getvalue() == b""
    print(f"WORKER{pid}-OK", flush=True)


def _ckpt_worker_main():
    """--checkpoint with --dist-nprocs: both ranks crash mid-scan in
    phase 1 (test hook), then the identical command resumes in phase 2
    - already-scanned chunks skipped, output byte-identical."""
    pid = int(os.environ[_WORKER_ENV])
    coord = os.environ["STRINGSEXT_DIST_COORD"]
    work = os.environ["STRINGSEXT_DIST_WORKDIR"]
    nprocs = int(os.environ.get("STRINGSEXT_DIST_NPROCS", "2"))
    phase = os.environ["STRINGSEXT_DIST_CKPT_PHASE"]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["STRINGSEXT_DIST_CKPT_CHUNK"] = "8"

    import io

    import jax

    jax.config.update("jax_platforms", "cpu")
    from stringsext_tpu.parallel import distributed

    distributed.initialize(
        coordinator_address=coord, num_processes=nprocs, process_id=pid
    )
    from stringsext_tpu.cli import parse_args
    from stringsext_tpu.run import run

    corpus = os.path.join(work, "sparse.bin")
    ck = os.path.join(work, "dist.ck")
    argv = ["-t", "x", "-e", "UTF-8", "-e", "utf-16le",
            "--checkpoint", ck,
            "--dist-nprocs", str(nprocs), "--dist-rank", str(pid),
            "--dist-coord", coord, corpus]
    if phase == "crash":
        os.environ["STRINGSEXT_DIST_CKPT_DIE"] = "2"
        try:
            run(parse_args(argv), out=io.BytesIO())
        except RuntimeError as e:
            assert "simulated" in str(e), e
            assert os.path.exists(f"{ck}.rank{pid}")
            print(f"WORKER{pid}-CRASHED", flush=True)
            return
        raise AssertionError("crash hook did not fire")
    buf = io.BytesIO()
    rc = run(parse_args(argv), out=buf)
    assert rc == 0
    st = distributed.LAST_STATS
    assert st["ckpt_chunks_skipped"] >= 1, st  # resume skipped work
    if pid == 0:
        expected = open(os.path.join(work, "sparse.expected"), "rb").read()
        assert buf.getvalue() == expected
    else:
        assert buf.getvalue() == b""
    assert not os.path.exists(f"{ck}.rank{pid}")  # removed on success
    print(f"WORKER{pid}-OK", flush=True)


def _worker_main():
    pid = int(os.environ[_WORKER_ENV])
    coord = os.environ["STRINGSEXT_DIST_COORD"]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=2, process_id=pid
    )
    assert jax.process_count() == 2
    assert jax.device_count() == 8 and jax.local_device_count() == 4

    import numpy as np
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from stringsext_tpu.mission import Missions
    from stringsext_tpu.ops.swar import swar_counts, swar_params
    from stringsext_tpu.parallel.mesh import build_sharded_counts

    ms = Missions.new(flag_encoding=["UTF-8", "utf-16le", "utf-16be"])
    p = swar_params(ms.v)
    specs = (
        ("utf8", p["af_iv"], p["ubf_iv"], p["greps"][0]),
        ("utf16", False, p["cp_iv_le"], p["greps"][1]),
        ("utf16", True, p["cp_iv_be"], p["greps"][2]),
    )

    # Deterministic corpus, identical in both processes.
    rng = np.random.default_rng(42)
    shard_rows, n_data = 16, 8
    rows = shard_rows * n_data
    raw = rng.integers(0, 256, size=rows * 512, dtype=np.uint8)
    msg = "déjà vu €uro Кириллица".encode() + "wide".encode("utf-16-le")
    for off in range(700, rows * 512 - 128, 4096):
        raw[off : off + len(msg)] = np.frombuffer(msg, np.uint8)
    words = raw.view(np.int32).reshape(rows, 128)

    devs = list(jax.devices())
    mesh = Mesh(np.array(devs), ("data",))
    sharding = NamedSharding(mesh, P("data"))

    # Each process feeds only ITS local devices' row-blocks (the
    # multi-host input contract: hosts never hold remote shards).
    arrs = []
    for d in jax.local_devices():
        k = devs.index(d)
        arrs.append(
            jax.device_put(words[k * shard_rows : (k + 1) * shard_rows], d)
        )
    garr = jax.make_array_from_single_device_arrays(
        (rows, 128), sharding, arrs
    )

    counts_step = build_sharded_counts(
        specs, mesh, shard_rows=shard_rows
    )
    out = counts_step(garr)  # [n_data, R, shard_rows], sharded P("data")

    # Single-device reference over the whole stream (bit-exact claim).
    import jax.numpy as jnp

    ref = np.asarray(
        swar_counts(jnp.asarray(words), specs)
    )

    checked = 0
    for sh in out.addressable_shards:
        d = sh.index[0].start or 0
        got = np.asarray(sh.data)[0]
        np.testing.assert_array_equal(
            got, ref[:, d * shard_rows : (d + 1) * shard_rows],
            f"shard {d}",
        )
        checked += 1
    assert checked == 4
    print(f"WORKER{pid}-OK", flush=True)


def _spawn_round(port, timeout_s, mode="counts", workdir=None, nprocs=2,
                 extra_env=None):
    env = dict(os.environ)
    env["STRINGSEXT_DIST_COORD"] = f"127.0.0.1:{port}"
    env["STRINGSEXT_DIST_TEST_MODE"] = mode
    env["STRINGSEXT_DIST_NPROCS"] = str(nprocs)
    if extra_env:
        env.update(extra_env)
    if workdir is not None:
        env["STRINGSEXT_DIST_WORKDIR"] = str(workdir)
    env.pop("JAX_PLATFORMS", None)
    procs = []
    for pid in range(nprocs):
        e = dict(env)
        e[_WORKER_ENV] = str(pid)
        procs.append(
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__)],
                env=e, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            )
        )
    outs = []
    try:
        for pr in procs:
            out, _ = pr.communicate(timeout=timeout_s)
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for pr in procs:
            pr.kill()
            pr.wait()
        return None
    return list(zip(procs, outs))


def test_two_process_distributed_counts():
    # The probe socket closes before the coordinator rebinds the port
    # (TOCTOU), so retry the whole round on a fresh port if a round
    # fails or hangs.
    last = None
    for _attempt in range(3):
        res = _spawn_round(_free_port(), timeout_s=240)
        if res is not None and all(pr.returncode == 0 for pr, _ in res):
            for pid, (pr, out) in enumerate(res):
                assert f"WORKER{pid}-OK" in out, out[-3000:]
            return
        last = res
    assert False, f"all attempts failed: {last and [o[-2000:] for _, o in last]}"


def _make_cli_corpora(workdir, big=False):
    """Sparse corpus (cold zero-gaps, findings on both sides, a string
    straddling the nominal midpoint) + dense corpus (every block hot:
    no safe split, exercises the rank-0-absorbs fallback) + cjk corpus
    (Shift_JIS/gb18030/ISO-2022-JP/UTF-8 strings with cold gaps and an
    ISO-2022-JP jis mode left OPEN across a span, so shard entry modes
    matter) + optionally a big sparse corpus for the O(shard)
    bytes-read assertion, with single-process expected outputs."""
    import io

    import numpy as np

    from stringsext_tpu.cli import parse_args
    from stringsext_tpu.run import run

    rng = np.random.default_rng(5)
    n = 256 * 1024
    sparse = bytearray(n)
    msgs = [
        b"left-side ascii finding",
        "wide ЖЖ utf16 string".encode("utf-16-le"),
        "d\u00e9j\u00e0 vu \u20ac utf8".encode("utf-8"),
    ]
    mid = n // 2
    k = 0
    for off in range(512, n - 64, 3000):
        if mid < off < mid + 48 * 1024:
            continue  # cold gap after the midpoint -> a real split
        m = msgs[k % len(msgs)]
        sparse[off:off + len(m)] = m
        k += 1
    strad = b"THIS STRING STRADDLES THE NOMINAL MIDPOINT BOUNDARY"
    sparse[mid - 20:mid - 20 + len(strad)] = strad
    (workdir / "sparse.bin").write_bytes(bytes(sparse))

    dense = rng.integers(0, 256, n // 4, np.uint8).tobytes()
    (workdir / "dense.bin").write_bytes(dense)

    cn = 512 * 1024
    cjk = bytearray(cn)
    cmsgs = [
        "シフトジスの文字列テスト".encode("shift_jis"),
        "汉字字符串测试一二三".encode("gb18030"),
        "日本語のテキストです".encode("iso-2022-jp"),
        "déjà vu € ascii and ünïcode".encode(),
        b"plain ascii string here",
    ]
    k = 0
    for off in range(800, cn - 256, 2600):
        if (off % (64 * 1024)) > 44 * 1024:
            continue  # cold zero-gap in every 64 KiB period
        m = cmsgs[k % len(cmsgs)]
        cjk[off:off + len(m)] = m
        k += 1
    # leave jis0208 mode OPEN across a stretch (no closing escape until
    # the next full iso message): shard entry-mode composition matters
    third = cn // 3
    frag = b"\x1b$B" + "漢字".encode("iso-2022-jp")[3:-3]
    cjk[third:third + len(frag)] = frag
    (workdir / "cjk.bin").write_bytes(bytes(cjk))

    if big:
        bn = 48 * 1024 * 1024
        bigb = bytearray(bn)
        k = 0
        for off in range(4096, bn - 64, 256 * 1024):
            m = msgs[k % len(msgs)]
            bigb[off:off + len(m)] = m
            k += 1
        (workdir / "big.bin").write_bytes(bytes(bigb))

    for name, argv in [
        ("sparse", ["-t", "x", "-e", "UTF-8", "-e", "utf-16le"]),
        ("dense", ["-t", "d", "-e", "UTF-8", "-e", "KOI8-R", "-n", "5"]),
        ("cjk", ["-t", "x", "-e", "Shift_JIS", "-e", "gb18030",
                 "-e", "ISO-2022-JP", "-e", "UTF-8", "-n", "4"]),
        ("big", ["-t", "x", "-e", "UTF-8", "-e", "utf-16le"]),
    ]:
        if not (workdir / f"{name}.bin").exists():
            continue
        buf = io.BytesIO()
        rc = run(parse_args(argv + [str(workdir / f"{name}.bin")]),
                 out=buf, engine="auto")
        assert rc == 0
        (workdir / f"{name}.expected").write_bytes(buf.getvalue())


def test_two_process_distributed_cli(tmp_path):
    """Full end-to-end: 2 processes, shared input file, process 0's
    output byte-identical to the single-process scan; the big corpus
    additionally pins O(shard) bytes-read per rank."""
    _make_cli_corpora(tmp_path, big=True)
    last = None
    for _attempt in range(3):
        res = _spawn_round(_free_port(), timeout_s=240, mode="cli",
                           workdir=tmp_path)
        if res is not None and all(pr.returncode == 0 for pr, _ in res):
            for pid, (pr, out) in enumerate(res):
                assert f"WORKER{pid}-OK" in out, out[-3000:]
                # the forced KV-store-less gather fallback must be LOUD
                assert "chunked allgather" in out, out[-3000:]
            return
        last = res
    assert False, f"all attempts failed: {last and [o[-2000:] for _, o in last]}"


def test_two_process_checkpoint_resume(tmp_path):
    """--checkpoint + --dist-nprocs: both ranks crash mid-scan, then
    the identical command resumes - completed chunks skipped, rank 0's
    output byte-identical, checkpoint files removed on success."""
    _make_cli_corpora(tmp_path)
    # phase 1: crash (both ranks exit nonzero with rank files on disk)
    crashed = False
    for _attempt in range(3):
        res = _spawn_round(_free_port(), timeout_s=240, mode="ckpt",
                           workdir=tmp_path,
                           extra_env={"STRINGSEXT_DIST_CKPT_PHASE": "crash"})
        if res is not None and all(
            f"WORKER{pid}-CRASHED" in out for pid, (_p, out) in enumerate(res)
        ):
            crashed = True
            break
    assert crashed, "crash phase did not complete"
    assert (tmp_path / "dist.ck.rank0").exists()
    assert (tmp_path / "dist.ck.rank1").exists()
    # phase 2: resume with the SAME workdir/checkpoint
    last = None
    for _attempt in range(3):
        res = _spawn_round(_free_port(), timeout_s=240, mode="ckpt",
                           workdir=tmp_path,
                           extra_env={"STRINGSEXT_DIST_CKPT_PHASE": "resume"})
        if res is not None and all(pr.returncode == 0 for pr, _ in res):
            for pid, (pr, out) in enumerate(res):
                assert f"WORKER{pid}-OK" in out, out[-3000:]
            return
        last = res
    assert False, f"resume failed: {last and [o[-2000:] for _, o in last]}"


def test_three_process_distributed_cli(tmp_path):
    """Same full-pipeline contract at 3 processes: shard-boundary
    search, per-shard scans, findings gather, and the rank-0 merge must
    be process-count-agnostic (the sparse corpus has two cold gaps, so
    a 3-way split is generally real)."""
    _make_cli_corpora(tmp_path)
    last = None
    for _attempt in range(3):
        res = _spawn_round(_free_port(), timeout_s=300, mode="cli",
                           workdir=tmp_path, nprocs=3)
        if res is not None and all(pr.returncode == 0 for pr, _ in res):
            for pid, (pr, out) in enumerate(res):
                assert f"WORKER{pid}-OK" in out, out[-3000:]
            return
        last = res
    assert False, f"all attempts failed: {last and [o[-2000:] for _, o in last]}"


if __name__ == "__main__":
    if _WORKER_ENV in os.environ:
        sys.path.insert(
            0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        mode = os.environ.get("STRINGSEXT_DIST_TEST_MODE")
        if mode == "cli":
            _cli_worker_main()
        elif mode == "ckpt":
            _ckpt_worker_main()
        else:
            _worker_main()
    else:
        raise SystemExit("worker entry only")
