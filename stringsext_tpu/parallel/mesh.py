"""Mesh-sharded scanning: the distributed analog of the reference's
thread-per-mission + sequential-slices model (SURVEY.md section 2
"Parallelism strategies" and section 5 "Long-context").

Design:

- 2-D device mesh ("data", "mission").
- The byte stream is sharded over the "data" axis with small halo
  exchange (`jax.lax.ppermute` between neighbouring devices): each
  shard receives the last 4 bytes of its left neighbor (context so
  leading continuation bytes / unit parity / straddling ISO escapes
  classify exactly) and the first 8 bytes of its right neighbor
  (lookahead so trailing multi-byte chars classify exactly). This replaces the reference's sequential
  decoder-carry (scanner.rs:45-48) with parallel carry-free
  classification: UTF-8 / UTF-16 validity is locally decidable given
  <=4 bytes of context on each side.
- The non-self-synchronizing kinds (Big5 / EUC-JP / EUC-KR / GBK /
  gb18030 / Shift_JIS and modal ISO-2022-JP) get the SAME data-axis
  treatment via cross-shard phase composition: each shard locally
  derives its entry->exit transfer function over a tiny state set (the
  event-chain entry offset 0..3; for ISO-2022-JP also the decoder mode
  and redundant-escape flag), the per-shard transfers - a few scalars -
  are all_gather-ed over the data axis and prefix-composed, and the
  event-chain orbit then starts from the composed entry phase
  (ops/classify_cjk._orbit_mask blocked resolve /
  ops/classify_iso2022.iso_state_transfer).
  So EVERY encoding the framework supports rides the device mesh, the
  parallel-treatment parity of the reference's one-thread-per-mission
  model (main.rs:151-167).
- Missions are SPMD over the "mission" axis: every mission-device runs
  the same program and selects its encoding's classification kernel
  with `jax.lax.switch` on `axis_index("mission")` (all kernels produce
  identically-shaped Lanes). Filters are sharded over the mission axis.
  This is the reference's one-thread-per-encoding (main.rs:151-167)
  recast as a tiny expert axis.
- Output: one fixed-capacity RunTable per (data-shard, mission) with
  global byte offsets - the sparse summary the host merges and feeds to
  the emission automaton. Only run tables cross the network, never the
  byte stream.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..encodings import (
    KIND_SINGLE_BYTE,
    KIND_UTF16BE,
    KIND_UTF16LE,
    KIND_UTF8,
    encoding_kind,
)
from ..mission import Mission
from ..ops import classify
from ..ops.runs import extract_runs, filter_words

LEFT_CTX = 4  # bytes of left-neighbor context (max char span - 1, parity-safe)
RIGHT_HALO = 8  # bytes of right-neighbor lookahead

KIND_ISO2022 = "iso-2022-jp"


def make_mesh(n_data: int, n_mission: int, devices: Sequence[jax.Device] | None = None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= n_data * n_mission, (
        f"need {n_data * n_mission} devices, have {len(devices)}"
    )
    devs = np.array(devices[: n_data * n_mission]).reshape(n_data, n_mission)
    return Mesh(devs, ("data", "mission"))


def _ones_step(c):
    return jnp.ones(c.shape[0], jnp.int32)


def _pre_kernel_for(kind: str, encoding_name: str):
    """Orbit-free classification kernel for one encoding:
    (chunk, n, entry_mode, entry_flag) -> (Lanes, step). The
    self-synchronizing kinds ignore the entry state and use step==1
    (their lanes are final as-is; an all-true orbit is the identity).
    The chain kinds (CJK / ISO-2022-JP) return pre-lanes the caller
    must AND with the orbit of its composed entry phase."""
    from ..ops.classify_cjk import CJK_KINDS, cjk_pre_lanes
    from ..ops.classify_iso2022 import iso_pre_lanes

    if kind == KIND_UTF8:
        return lambda c, n, m, f: (classify.utf8_lanes(c, n), _ones_step(c))
    if kind == KIND_UTF16LE:
        return lambda c, n, m, f: (
            classify.utf16_lanes(c, False, n), _ones_step(c))
    if kind == KIND_UTF16BE:
        return lambda c, n, m, f: (
            classify.utf16_lanes(c, True, n), _ones_step(c))
    if kind == KIND_SINGLE_BYTE:
        return lambda c, n, m, f: (
            classify.single_byte_lanes(c, encoding_name, n), _ones_step(c))
    if kind in CJK_KINDS:
        return lambda c, n, m, f: cjk_pre_lanes(c, kind, n)
    if kind == KIND_ISO2022:
        return lambda c, n, m, f: iso_pre_lanes(c, n, m, f, LEFT_CTX)[:2]
    raise NotImplementedError(f"no device kernel for {kind}")


def _state_kernel_for(kind: str, shard_len: int):
    """Per-shard (mode, flag) transfer kernel: (chunk, n) -> int32[2].
    Only modal ISO-2022-JP carries cross-shard decoder state; every
    other kind's transfer is the identity (-1, -1)."""
    from ..ops.classify_iso2022 import iso_state_transfer

    if kind == KIND_ISO2022:
        return lambda c, n: iso_state_transfer(
            c, n, LEFT_CTX, LEFT_CTX + shard_len)
    return lambda c, n: jnp.full(2, -1, jnp.int32)


def build_sharded_scan(
    missions: Sequence[Mission], mesh: Mesh, shard_len: int, capacity: int = 4096
):
    """Compile a jitted SPMD scan step.

    Returns fn(data_u8[n_data * shard_len]) -> RunTable with leading
    axes [n_data, n_mission] and *global* byte offsets. `shard_len` must
    be a multiple of 2 (UTF-16 unit parity across shards). Offsets are
    rebased on-device in int32, so one CALL covers < 2 GiB
    (n_data * shard_len); larger streams are fed call-by-call (the
    chunked drivers already do), with the caller adding the chunk base
    in int64. Missions short of the mesh's mission axis are padded with
    REPLICAS of the last mission: columns >= len(missions) of the
    returned tables are duplicates the caller must ignore.
    """
    assert shard_len % 2 == 0, "shard_len must keep UTF-16 unit parity"
    n_data = mesh.shape["data"]
    n_mission = mesh.shape["mission"]
    assert 0 < len(missions) <= n_mission
    assert n_data * shard_len < 2**31, "int32 on-device offset rebase"

    from ..ops.classify_cjk import (
        CJK_KINDS, _orbit_mask, _orbit_masks_block0,
    )

    kinds = []
    kernels = []
    state_kernels = []
    af_list, ubf_list, grep_list = [], [], []
    for m in missions:
        kind = encoding_kind(m.encoding_name)
        kinds.append(kind)
        kernels.append(_pre_kernel_for(kind, m.encoding_name))
        state_kernels.append(_state_kernel_for(kind, shard_len))
        af_w, ubf_w = filter_words(m)
        af_list.append(af_w)
        ubf_list.append(ubf_w)
        grep_list.append(-1 if m.filter.grep_char is None else m.filter.grep_char)
    while len(kernels) < n_mission:  # pad mission axis with replicas
        kinds.append(kinds[-1])
        kernels.append(kernels[-1])
        state_kernels.append(state_kernels[-1])
        af_list.append(af_list[-1])
        ubf_list.append(ubf_list[-1])
        grep_list.append(grep_list[-1])

    # Static program shape: the chain kinds (CJK / ISO-2022-JP) are not
    # self-synchronizing, so their event chain must enter each shard at
    # the phase the previous shards' decode left it at. Each shard
    # derives its entry->exit transfer (a function on a tiny state set)
    # locally, the transfers are all_gather-ed over the data axis (a few
    # scalars per shard) and prefix-composed; the orbit then starts at
    # the composed entry. Mission sets of purely self-synchronizing
    # kinds compile to exactly the collective-free (ppermute-only)
    # program as before.
    needs_orbit = any(k in CJK_KINDS or k == KIND_ISO2022 for k in kinds)
    needs_state = any(k == KIND_ISO2022 for k in kinds)

    af_words = jnp.asarray(np.stack(af_list))  # [M, 4] uint32
    ubf_words = jnp.asarray(np.stack(ubf_list))  # [M, 2] uint32
    greps = jnp.asarray(np.array(grep_list, dtype=np.int32))  # [M]

    def shard_body(b_shard, af_w, ubf_w, grep):
        # b_shard: [shard_len] local bytes; af_w: [1, 4] (mission-sharded)
        af_w, ubf_w, grep = af_w[0], ubf_w[0], grep[0]
        di = jax.lax.axis_index("data")
        mi = jax.lax.axis_index("mission")

        # Halo exchange over the data axis (neighbours). Non-wrapping
        # permutes zero-fill the stream edges; zero bytes consume
        # themselves in every supported encoding, so edge shards
        # classify exactly (see module docstring).
        right_to_left = [(i + 1, i) for i in range(n_data - 1)]
        left_to_right = [(i, i + 1) for i in range(n_data - 1)]
        halo = jax.lax.ppermute(b_shard[:RIGHT_HALO], "data", right_to_left)
        ctx = jax.lax.ppermute(b_shard[-LEFT_CTX:], "data", left_to_right)
        chunk = jnp.concatenate([ctx, b_shard, halo])

        n_real = jnp.int32(LEFT_CTX + shard_len) + jnp.where(
            di < n_data - 1, RIGHT_HALO, 0
        )
        owned_end = LEFT_CTX + shard_len

        # Stage A (modal kinds only): compose the cross-shard decoder
        # state - ISO-2022-JP (mode, redundant-escape flag) - from the
        # per-shard transfer monoid. The all_gather moves 2 ints per
        # shard; the unrolled fold is O(n_data) scalar selects.
        entry_mode = jnp.int32(0)
        entry_flag = jnp.int32(-1)
        if needs_state:
            st = jax.lax.switch(mi, state_kernels, chunk, n_real)
            allA = jax.lax.all_gather(st, "data")  # [n_data, 2]
            m_acc = jnp.int32(0)
            f_acc = jnp.int32(-1)
            for k in range(n_data):
                entry_mode = jnp.where(di == k, m_acc, entry_mode)
                entry_flag = jnp.where(di == k, f_acc, entry_flag)
                m_acc = jnp.where(allA[k, 0] >= 0, allA[k, 0], m_acc)
                f_acc = jnp.where(allA[k, 1] >= 0, allA[k, 1], f_acc)

        # Stage B: orbit-free classification (per-kind via lax.switch;
        # all kernels produce identically-shaped (Lanes, step)).
        lanes, step = jax.lax.switch(
            mi, kernels, chunk, n_real, entry_mode, entry_flag
        )

        # Stage C (chain kinds only): compose the event-chain entry
        # offset. Each shard's transfer maps every possible entry
        # offset (0..3 bytes past its start - max char span 4) to the
        # exit offset into the next shard. The exit is read off the
        # truncated orbit (chains stop at owned_end): its LAST marked
        # position p* steps past the boundary by the exit delta -
        # riding the same blocked gather-free resolve as the orbit
        # itself (classify_cjk._orbit_mask).
        if needs_orbit:
            cidx = jnp.arange(chunk.shape[0], dtype=jnp.int32)

            # all four entry probes ride ONE multi-start resolve
            # (entries LEFT_CTX+0..3 are all in block 0)
            masks4 = _orbit_masks_block0(
                step, owned_end, LEFT_CTX + jnp.arange(4, dtype=jnp.int32)
            )
            pstar = jnp.max(jnp.where(masks4, cidx[None, :], -1), axis=1)
            s_at = jnp.take(step, jnp.clip(pstar, 0))
            trans = jnp.where(
                pstar < 0, 0,
                jnp.clip(pstar + s_at - owned_end, 0, 3),
            ).astype(jnp.int32)
            allT = jax.lax.all_gather(trans, "data")  # [n_data, 4]
            d_acc = jnp.int32(0)
            entry_d = jnp.int32(0)
            for k in range(n_data):
                entry_d = jnp.where(di == k, d_acc, entry_d)
                d_acc = jnp.take(allT[k], d_acc)
            orbit = _orbit_mask(step, n_real, LEFT_CTX + entry_d)
            lanes = lanes._replace(
                start=lanes.start & orbit,
                valid=lanes.valid & orbit,
                pending=lanes.pending & orbit,
            )

        # Keep only events owned by this shard: start in
        # [LEFT_CTX, LEFT_CTX + shard_len).
        idx = jnp.arange(chunk.shape[0], dtype=jnp.int32)
        own = (idx >= LEFT_CTX) & (idx < LEFT_CTX + shard_len)
        lanes = lanes._replace(
            start=lanes.start & own,
            valid=lanes.valid & own,
            pending=lanes.pending & own,
        )
        rt = extract_runs(lanes, af_w, ubf_w, grep, capacity=capacity)
        # Rebase offsets: local chunk -> global stream.
        base = di.astype(jnp.int32) * shard_len - LEFT_CTX
        has_row = jnp.arange(capacity) < rt.count
        rt = rt._replace(
            start=jnp.where(has_row, rt.start + base, rt.start),
            end=jnp.where(has_row, rt.end + base, rt.end),
        )
        return jax.tree.map(lambda x: x[None, None], rt)

    from jax import shard_map

    sharded = shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P("data"), P("mission"), P("mission"), P("mission")),
        out_specs=P("data", "mission"),
        check_vma=False,
    )

    @jax.jit
    def scan_step(data_u8):
        b = data_u8.reshape(n_data * shard_len)
        return sharded(b, af_words, ubf_words, greps)

    return scan_step


def build_sharded_counts(
    specs: tuple, mesh: Mesh, shard_rows: int, hot_only: bool = False,
):
    """Compile the fused SWAR counts pass (ops/swar.swar_counts: every
    mission in one pass, stage-1 run compaction fused in) sharded over
    the mesh's "data" axis.

    Each shard takes HALO_ROWS word-rows of context from each
    neighbour with `ppermute`; the non-wrapping permute zero-fills at
    the stream edges, which is exactly the single-device pass's
    zero-context edge semantics, so the per-512-byte-block counts are
    BIT-EXACT equal to a single-device `swar_counts` over the whole
    stream (tests/test_parallel.py pins this on the virtual CPU mesh).

    Missions need no mesh axis here - the pass fuses every mission;
    only the tiny [R, rows] count panels (1/64th of the input) leave
    each device.

    Returns fn(words_2d[n_data * shard_rows, 128]) ->
    int32[n_data, R, shard_rows].
    """
    from jax import shard_map

    from ..ops.swar import HALO_ROWS, LANE, swar_counts

    n_data = mesh.shape["data"]
    H = HALO_ROWS
    assert shard_rows >= H, "shards must cover at least one halo"

    def body(w_shard):  # [shard_rows, LANE] local words
        right_to_left = [(i + 1, i) for i in range(n_data - 1)]
        left_to_right = [(i, i + 1) for i in range(n_data - 1)]
        from_right = jax.lax.ppermute(w_shard[:H], "data", right_to_left)
        from_left = jax.lax.ppermute(w_shard[-H:], "data", left_to_right)
        ext = jnp.concatenate([from_left, w_shard, from_right], axis=0)
        counts = swar_counts(ext, specs, hot_only=hot_only)
        return counts[None, :, H : H + shard_rows]

    sharded = shard_map(
        body,
        mesh=mesh,
        in_specs=(P("data"),),
        out_specs=P("data", None, None),
        check_vma=False,
    )

    @jax.jit
    def counts_step(words_2d):
        w = words_2d.reshape(n_data * shard_rows, LANE)
        return sharded(w)

    return counts_step
