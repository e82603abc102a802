"""Voxel-grouped semantic correspondence search + hash probing.

Semantically identical to ops.hashmap.get_correspondences / lookup
(reference cpp/sage_icp/core/VoxelHashMap.cpp:48-130), but restructured
for fixed-shape accelerator execution:

  * Everything gathers WIDE rows with FLAT indices (multi-dim index
    gathers into rank-3 tables, and tiny rows, lowered much slower on
    the accelerator this was first written for; not measured on the
    H100).
  * Probing D linear-probe slots per key would be D tiny gathers; instead
    a per-frame "window table" W[i] = packed_keys[i : i + D] (built with
    D cheap rolls, no gather) turns one probe into ONE (D,)-row gather.
  * Voxel keys pack into one int32 as 10-bit offsets from a frame center
    voxel, so key comparison is a single integer compare.
  * Queries are sorted and grouped by voxel: all queries in a voxel share
    their 27 neighbors, so candidates are fetched once per UNIQUE voxel
    into (R, 27K) int16 planes, and distances compute as direct
    differences in voxel-local coordinates (local magnitudes ~2 m keep
    f32 exact).

The argmin metric (sem_th-scaled squared distance for label-match-or-
unknown) and the unweighted acceptance gate reproduce the reference
exactly (VoxelHashMap.cpp:88,111).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sage_icp_tpu.ops import hashmap as hm
from sage_icp_tpu.ops.scan import trunc_div

PACK_BITS = 10  # 10-bit per-axis offsets: rel coords must fit +-255 (+2 margin)
PACK_LIM = 255
_B = 1 << PACK_BITS


def fast_path_supported(voxel_size: float, local_map_range: float, max_range: float) -> bool:
    """Packed 10-bit offsets cover (map extent + scan extent) voxels."""
    return (local_map_range + max_range) / voxel_size + 3.0 <= PACK_LIM


def pack_rel(rel: jax.Array) -> jax.Array:
    """(..., 3) int32 relative voxel coords -> single positive int32 code.
    Out-of-range coords return -1 (matches nothing)."""
    ok = jnp.all(jnp.abs(rel) <= PACK_LIM, axis=-1)
    code = (
        (rel[..., 0] + 256) * (_B * _B)
        + (rel[..., 1] + 256) * _B
        + (rel[..., 2] + 256)
    )
    return jnp.where(ok, code, -1)


class ProbeTables(NamedTuple):
    """Per-frame probe acceleration structure (derived from MapState)."""

    window: jax.Array  # int32[C, D]: packed keys of slots [i, i+D)
    center: jax.Array  # int32[3] the packing center voxel
    points2: jax.Array  # int16[C, 4*K] PLANAR quantized block view
    #                     [x*K | y*K | z*K | l*K], voxel-local offsets


def build_probe_tables(
    state: hm.MapState, center_voxel: jax.Array, probe_depth: int
) -> ProbeTables:
    """Packed-key + count windows. Built with rolls (contiguous shifts),
    never gathers. Cost ~ (2D+2) * C * 4 bytes of streaming."""
    rel = state.keys - center_voxel[None, :]
    packed = pack_rel(rel)  # -1 for out-of-range / sentinel keys
    # keys only: per-lane candidate validity comes from the SANITIZED
    # label plane (-1 at/beyond each block's count, hashmap insert), so
    # windows no longer carry counts — half the build and half the
    # probe-gather bytes
    window = jnp.stack(
        [jnp.roll(packed, -hm.probe_offset(d)) for d in range(probe_depth)],
        axis=1,
    )  # (C, D)
    k = state.points_per_voxel
    # the map stores blocks PLANAR already (hashmap.MapState.points is
    # (C, 4, K)), so the gather-ready flat view is a free reshape —
    # component extraction after the candidate gather stays contiguous
    # K-lane slices instead of a stride-4 relayout
    planar = state.points.reshape(state.capacity, 4 * k)
    return ProbeTables(
        window=window,
        center=center_voxel,
        points2=planar,
    )


def probe(
    tables: ProbeTables, abs_keys: jax.Array, rel_codes: jax.Array, probe_depth: int
) -> tuple[jax.Array, jax.Array]:
    """Find slots for voxel keys. abs_keys: (..., 3) absolute int coords
    (for hashing); rel_codes: (...,) packed codes (for comparison).
    Returns (found bool, slot int32)."""
    cap = tables.window.shape[0]
    D = probe_depth
    h = hm.hash_keys(abs_keys, cap)  # (...,)
    # flat-index wide-row gather (multi-dim index gathers lower much slower)
    win = tables.window[h.reshape(-1)].reshape(h.shape + (D,))
    match = win == rel_codes[..., None]
    # rel_codes == -1 (invalid) never matches: window stores -1 only for
    # out-of-range keys, and match against -1 must be suppressed
    match = match & (rel_codes[..., None] >= 0)
    found = jnp.any(match, axis=-1)
    d1 = jnp.argmax(match, axis=-1)
    slot = (h + hm.probe_offset(d1)) & (cap - 1)
    return found, slot


class CorrSetup(NamedTuple):
    """Frozen per-solve correspondence structure: queries grouped into
    unique-voxel rows with their 27-neighborhood candidates gathered and
    localized ONCE. Iterating the GN loop only re-applies the running pose
    increment to the (R, P) query grid — sort, probe, gather, and the
    planar relayout are all loop-invariant.

    Row assignment is by the query's voxel at SETUP time. A query that
    crosses a voxel boundary during the solve ("mover") keeps matching
    against the setup row's 27-neighborhood as long as it stays within
    ONE voxel of the setup voxel; only moves beyond the neighbor shell
    are dropped for that iteration. The real invariant (the solver's
    0.45*voxel re-anchor bounds drift, registration.py): candidate
    coverage beyond the drifted query stays >= 0.55*voxel in every
    direction, so only weak far-gate correspondences (beyond that
    margin; the gate is 3*sigma) can be missed — the same truncation
    class as the reference's own 27-voxel search, which also sees
    nothing beyond its shell (VoxelHashMap.cpp:52-78). See corr_apply
    for why dropping all movers (rounds 1-2) destabilized the solve."""

    cxp: jax.Array  # (R, M) int16 candidate x, OWN-voxel-local quantized
    cyp: jax.Array  # (R, M) int16
    czp: jax.Array  # (R, M) int16
    clp: jax.Array  # (R, M) int16 candidate labels; -1 = invalid lane
    q0: jax.Array  # (R, P, 4) query world xyz + label at setup
    grid_used: jax.Array  # (R, P)
    row_rel: jax.Array  # (R, 3) row voxel coords relative to center
    row_origin_abs: jax.Array  # (R, 3)
    center: jax.Array  # (3,) packing center voxel
    order: jax.Array  # (N,) sort permutation (for unsorting results)
    row: jax.Array  # (N,) sorted query -> row (R = dropped)
    col: jax.Array  # (N,) sorted query -> column
    n_dropped: jax.Array  # i32 scalar: valid queries with NO grid seat
    #   (row/overflow-row capacity exhausted, or outside the packed range)
    #   — the fixed-shape engine's only silent-drop channel, surfaced for
    #   the per-frame overflow counters (StepAux)


def corr_setup(
    state: hm.MapState,
    tables: ProbeTables,
    query: jax.Array,
    valid: jax.Array,
    voxel_size,
    probe_depth: int,
    unique_voxel_rows: int = 4096,
    queries_per_voxel: int = 8,
    overflow_rows: int = 1024,
) -> CorrSetup:
    """Group queries by voxel and gather candidate planes (loop-invariant
    part of the search). query: (N, 4) world frame."""
    n = query.shape[0]
    K = state.points_per_voxel
    Q, P, OV = unique_voxel_rows, queries_per_voxel, overflow_rows
    R = Q + OV  # total voxel rows (+1 virtual drop row)

    vq_abs = trunc_div(query[:, :3], voxel_size)  # (N, 3)
    rel = vq_abs - tables.center[None, :]
    in_range = valid & jnp.all(jnp.abs(rel) <= PACK_LIM - 2, axis=-1)
    code = pack_rel(jnp.clip(rel, -PACK_LIM, PACK_LIM))
    BIG = jnp.int32(2**30)
    sortcode = jnp.where(in_range, code, BIG)

    # payload-carrying stable sort (latency-bound: extra operands are ~free
    # and remove the 16-byte-row query[order] gather); order is kept for
    # the single-pass API's unsort
    idx = jnp.arange(n, dtype=jnp.int32)
    sc, order, qsx, qsy, qsz, qsl = jax.lax.sort(
        (sortcode, idx, query[:, 0], query[:, 1], query[:, 2], query[:, 3]),
        num_keys=1,
        is_stable=True,
    )
    q_s = jnp.stack([qsx, qsy, qsz, qsl], axis=-1)
    val_s = sc != jnp.int32(2**30)
    head = jnp.concatenate([jnp.array([True]), sc[1:] != sc[:-1]]) & val_s
    pos = jnp.arange(n, dtype=jnp.int32)
    seg_start = jax.lax.associative_scan(jnp.maximum, jnp.where(head, pos, 0))
    q_rank = pos - seg_start
    u_rank = jnp.cumsum(head) - 1  # unique-voxel id per sorted query

    is_ov = val_s & (q_rank >= P)
    ov_rank = jnp.cumsum(is_ov) - 1
    row = jnp.where(
        val_s & ~is_ov & (u_rank < Q),
        u_rank,
        jnp.where(is_ov & (ov_rank < OV), Q + ov_rank, R),
    )
    col = jnp.where(is_ov, 0, jnp.minimum(q_rank, P - 1))

    # --- grid build by GATHER, not scatter (scatter avoidance: a design
    # choice from the first target accelerator, not measured on the H100).
    # Row r's queries live at sorted positions start[r] + p, so two small
    # int scatters (head and overflow start positions) replace five
    # (R, P)-shaped scatters. ---------------------------------------------
    rel_s = trunc_div(q_s[:, :3], voxel_size) - tables.center[None, :]
    u_src = jnp.where(head & (u_rank < Q), u_rank, Q)
    hp = jnp.full((Q + 1,), n, jnp.int32).at[u_src].set(
        pos, mode="drop", unique_indices=True
    )[:Q]
    ov_src = jnp.where(is_ov & (ov_rank < OV), ov_rank, OV)
    op = jnp.full((OV + 1,), n, jnp.int32).at[ov_src].set(
        pos, mode="drop", unique_indices=True
    )[:OV]
    start = jnp.concatenate([hp, op])  # (R,) first sorted index per row
    row_live = start < n
    start_c = jnp.minimum(start, n - 1)
    row_rel = jnp.where(row_live[:, None], rel_s[start_c], 0)
    row_origin_abs = (
        (row_rel + tables.center[None, :]).astype(query.dtype) * voxel_size
    )

    # one packed record per sorted query; a row's P queries are CONTIGUOUS
    # in the sorted array, so P cheap rolls build a (N, 5P) window table
    # and the whole grid comes from ONE wide-row gather instead of a
    # (R, P) gather of 20 B records
    rec = jnp.concatenate(
        [
            q_s,  # x y z label
            jnp.where(val_s, u_rank, -1).astype(query.dtype)[:, None],
        ],
        axis=1,
    )  # (N, 5)
    rec_win = jnp.concatenate(
        [jnp.roll(rec, -p_, axis=0) for p_ in range(P)], axis=1
    )  # (N, 5P): row i = rec[i : i+P] flattened
    col_iota = jnp.arange(P, dtype=jnp.int32)[None, :]
    starts = jnp.concatenate([hp, op])  # (R,)
    # out-of-bounds slots (window wrap-around / overflow cols > 0) hold
    # OTHER queries' records; every consumer is masked through grid_used
    oob = jnp.concatenate(
        [
            hp[:, None] + col_iota >= n,  # (Q, P)
            (col_iota > 0) | (op[:, None] >= n),  # (OV, P): col 0 only
        ],
        axis=0,
    )
    g = rec_win[jnp.minimum(starts, n - 1)].reshape(R, P, 5)
    row_uid = jnp.arange(R, dtype=jnp.int32)[:, None]  # uid = row for r < Q
    grid_used = jnp.where(
        row_uid < Q,
        ~oob & (g[..., 4].astype(jnp.int32) == row_uid),
        ~oob & row_live[:, None],
    )
    # --- probe the 27 neighbors of every row voxel -------------------------
    nb_rel = row_rel[:, None, :] + hm._NEIGHBOR_OFFSETS[None, :, :]  # (R,27,3)
    nb_abs = nb_rel + tables.center[None, None, :]
    if state.grid is not None:
        # toroidal dense index: ONE 8-byte-row gather per neighbor instead
        # of a 64 B hash-window row gather; per-lane validity comes from
        # the sanitized label plane (-1 beyond each block's count), so no
        # counts gather is needed at all
        found, slot = hm.grid_probe(state, nb_abs)  # (R, 27)
        found = found & row_live[:, None]
    else:
        nb_code = jnp.where(
            row_live[:, None], pack_rel(nb_rel), -1
        )
        found, slot = probe(tables, nb_abs, nb_code, probe_depth)

    # --- fetch candidate blocks (flat wide-row gather, PLANAR layout) -------
    # rows stay int16 (half the gather bytes of f32); dequantization to
    # row-local f32 happens lane-wise where the planes are consumed, so
    # device memory only ever holds the quantized planes
    flat_slot = jnp.where(found, slot, 0).reshape(-1)  # (R*27,)
    raw = tables.points2[flat_slot]  # (R*27, 4K)
    M = 27 * K
    # plane extraction as ONE (R27, 4, K) -> (4, R27, K) transpose
    # instead of four strided slices
    planes = jnp.swapaxes(raw.reshape(R * 27, 4, K), 0, 1).reshape(4, R, M)
    cx_q, cy_q, cz_q, cl = planes[0], planes[1], planes[2], planes[3]
    # block-level mask only: per-lane validity is already encoded in the
    # sanitized label plane (-1 at/beyond each block's count)
    cm = jnp.broadcast_to(found[..., None], (R, 27, K)).reshape(R, M)

    # the label plane carries the invalid-lane sentinel (-1): the NN step
    # pushes invalid lanes to +inf weighted metric (loses every argmin) and
    # to a huge true distance (fails the acceptance gate on empty rows)
    q0 = g[..., :4]  # (R, P, 4) world coords + label at setup
    n_dropped = (
        jnp.sum(valid.astype(jnp.int32))
        - jnp.sum((val_s & (row < R)).astype(jnp.int32))
    )
    return CorrSetup(
        cxp=cx_q,
        cyp=cy_q,
        czp=cz_q,
        clp=jnp.where(cm, cl, jnp.int16(-1)),
        q0=q0,
        grid_used=grid_used,
        row_rel=row_rel,
        row_origin_abs=row_origin_abs,
        center=tables.center,
        order=order,
        row=row,
        col=col,
        n_dropped=n_dropped,
    )


def corr_apply(
    setup: CorrSetup,
    T: jax.Array,
    voxel_size,
    max_correspondence_distance,
    sem_th,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """One semantic NN pass on the frozen structure. T: (4, 4) pose
    increment since setup (identity on the first pass — then the result
    is exactly the reference search). Returns
    (src_world (R, P, 4), tgt_world (R, P, 4), accept (R, P))."""
    R, P, _ = setup.q0.shape
    M = setup.cxp.shape[1]
    K = M // 27
    dt = setup.q0.dtype
    xyz0 = setup.q0[..., :3]
    q_w = (
        jnp.einsum("ij,rpj->rpi", T[:3, :3], xyz0, precision="highest")
        + T[:3, 3][None, None, :]
    )
    lab = setup.q0[..., 3]
    # movers: queries whose current voxel differs from their setup row.
    # A move of ONE voxel keeps the true NN inside the row's gathered
    # 27-neighborhood for any gate < voxel_size, so such queries stay
    # matched against the (slightly off-center) setup candidates — the
    # same truncation class as the reference's own 27-voxel search
    # (VoxelHashMap.cpp:88). Only moves BEYOND the neighbor shell drop.
    # Round-3 lesson: dropping all movers (round 1-2) was a feedback
    # loop — a normal first-iteration increment of a few cm crosses a
    # boundary for ~10-25% of queries, the drop is spatially biased in
    # the motion direction, the solve degrades, the next guess worsens,
    # more movers drop; ncorr collapsed within ~5 frames on the city
    # bench while the map and search were provably healthy
    # (scripts/city_nn_probe.py).
    moved = jnp.any(
        jnp.abs(
            trunc_div(q_w, voxel_size)
            - setup.center[None, None, :]
            - setup.row_rel[:, None, :]
        )
        > 1,
        axis=-1,
    )
    used = setup.grid_used & ~moved

    # all distance math runs in ROW-LOCAL frame (row voxel origin): values
    # stay within ~2-3 voxel sizes, exact in f32. Per-lane dequantization:
    # c_local = neighbor_offset(lane // K) * v + c_int16 * (v / QSCALE).
    origin = setup.row_origin_abs  # (R, 3)
    q_loc = q_w - origin[:, None, :]
    offs = (
        jnp.repeat(hm._NEIGHBOR_OFFSETS, K, axis=0).astype(dt) * voxel_size
    )  # (M, 3) static per-lane neighbor offset, meters
    scale = voxel_size / hm.QSCALE

    # dequantize to (R, M) f32 planes and take DIRECT differences: XLA
    # fuses dx^2 + dy^2 + dz^2, the semantic weighting and the argmin
    # into one reduction over the candidate lanes (no cancellation, no
    # degenerate K=3 matmul)
    cm = setup.clp >= 0
    cxf = setup.cxp.astype(dt) * scale + offs[None, :, 0]
    cyf = setup.cyp.astype(dt) * scale + offs[None, :, 1]
    czf = setup.czp.astype(dt) * scale + offs[None, :, 2]
    cli = setup.clp.astype(jnp.int32)
    labi = lab.astype(jnp.int32)
    dx = cxf[:, None, :] - q_loc[..., 0:1]  # (R, P, M)
    dy = cyf[:, None, :] - q_loc[..., 1:2]
    dz = czf[:, None, :] - q_loc[..., 2:3]
    d2 = dx * dx + dy * dy + dz * dz

    sem = (cli[:, None, :] == labi[:, :, None]) | (
        cli[:, None, :] * labi[:, :, None] == 0
    )
    inf = jnp.asarray(jnp.finfo(d2.dtype).max, d2.dtype)
    d2w = jnp.where(sem, d2 * sem_th, d2)
    d2w = jnp.where(cm[:, None, :], d2w, inf)

    best = jnp.argmin(d2w, axis=-1)  # (R, P) first minimum, like the ref
    any_cand = jnp.any(cm, axis=-1)  # (R,)
    pick = lambda plane: jnp.take_along_axis(plane, best, axis=1)  # (R, P)
    tgt_loc = jnp.stack([pick(cxf), pick(cyf), pick(czf)], axis=-1)
    tgt_grid = jnp.concatenate(
        [tgt_loc + origin[:, None, :], pick(cli).astype(dt)[..., None]],
        axis=-1,
    )  # (R, P, 4) world
    d_true = jnp.linalg.norm(tgt_loc - q_loc, axis=-1)
    accept_grid = (
        used & any_cand[:, None] & (d_true < max_correspondence_distance)
    )

    src_grid = jnp.concatenate([q_w, lab[..., None]], axis=-1)
    return src_grid, tgt_grid, accept_grid


def get_correspondences_fast(
    state: hm.MapState,
    tables: ProbeTables,
    query: jax.Array,
    valid: jax.Array,
    voxel_size,
    max_correspondence_distance,
    sem_th,
    probe_depth: int,
    unique_voxel_rows: int = 4096,
    queries_per_voxel: int = 8,
    overflow_rows: int = 1024,
) -> tuple[jax.Array, jax.Array]:
    """Drop-in fast replacement for hm.get_correspondences. query: (N, 4).
    Returns (target (N, 4), accept (N,)). Setup + identity apply: a single
    pass is exactly the reference search (no query can have 'moved')."""
    n = query.shape[0]
    setup = corr_setup(
        state, tables, query, valid, voxel_size, probe_depth,
        unique_voxel_rows, queries_per_voxel, overflow_rows,
    )
    _, tgt_grid, accept_grid = corr_apply(
        setup, jnp.eye(4, dtype=query.dtype), voxel_size,
        max_correspondence_distance, sem_th,
    )
    R = setup.grid_used.shape[0]
    # back to original query order: one int32 scatter builds the inverse
    # permutation, the payloads move by gather
    row_c = jnp.where(setup.row < R, setup.row, 0)
    tgt_sorted = tgt_grid[row_c, setup.col]  # (N, 4)
    acc_sorted = jnp.where(
        setup.row < R, accept_grid[row_c, setup.col], False
    )
    pos = jnp.arange(n, dtype=jnp.int32)
    inv_order = (
        jnp.zeros((n,), jnp.int32).at[setup.order].set(
            pos, unique_indices=True
        )
    )
    out_tgt = tgt_sorted[inv_order]
    out_acc = acc_sorted[inv_order]
    return out_tgt, out_acc
