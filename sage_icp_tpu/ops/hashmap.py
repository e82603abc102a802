"""Semantic voxel-hash local map as a fixed-capacity open-addressing table
in device arrays — the accelerator replacement for the reference's
tsl::robin_map<Voxel, VoxelBlock> (cpp/sage_icp/core/VoxelHashMap.{hpp,cpp}).

Design
------
The reference is a pointer-world hash map mutated point-by-point under TBB.
Here the map is three dense arrays:

    keys:   int32[C, 3]    voxel coordinate of each slot
    counts: int32[C]       live points in the slot's block (0 = free)
    points: int16[C, 4, K] the block buffer, PLANAR [x|y|z|label] planes,
                           K = basic+critical

Block points are stored QUANTIZED: xyz as int16 voxel-local offsets
(point - voxel_key * voxel_size, full int16 scale = one voxel => worst
case error voxel_size / 32767 / 2 ~ 0.015 mm, three orders of magnitude
below LiDAR noise) and the label as int16. This halves every hot byte
stream over the f32 layout: the map buffer itself (donation copies), the
per-solve candidate gathers, the per-ICP-iteration kernel reads, and the
insert read-modify-write — all memory-bound streams. World coordinates are reconstructed on demand from the
slot's key; all distance math then runs in voxel-local frame where f32
is exact.

Collision handling is bounded linear probing with probe depth D: a voxel
with hash h may live in any slot [h, h+D) mod C. Lookups always inspect all
D candidate slots (vectorized gather + compare), so slot reuse after culling
("tombstones") requires no special casing: any slot with count == 0 is
claimable, and a probe window is never early-terminated.

Parallel insertion resolves claim races GPU-hash-map style: each round,
every unresolved new voxel scatter-mins its id into a claim array at its
current probe slot, gathers back to see who won, and losers advance to the
next probe offset. All shapes static; overflowing voxels/points are
dropped — and COUNTED: insert(with_stats=True) returns an InsertStats
with the unique-voxel overflow, claim-loop failures, and per-voxel
incoming truncation, surfaced per frame through StepAux so a fixed-shape
deployment can observe (and alert on) capacity pressure.

Reproduced reference semantics:
  * spatial hash (x*73856093 ^ y*19349663 ^ z*83492791) & (C-1)
    (VoxelHashMap.hpp:72-77 — the reference masks to 2^20 regardless of
    robin_map's own capacity; we mask to our table capacity)
  * voxel coord = static_cast<int>(p / voxel_size): truncation toward zero
    (VoxelHashMap.cpp:52-54,165)
  * VoxelBlock::AddPoint basic/critical/label-0 retention policy
    (VoxelHashMap.hpp:45-70):
      - count < basic            -> append
      - label == 0               -> drop
      - label in basic_labels    -> overwrite first stored label-0 point
      - else (critical class)    -> append while count < basic+critical,
                                    else overwrite first label-0 point
  * RemovePointsFarFromLocation: a block is erased iff its FIRST point is
    farther than max_distance from the origin (VoxelHashMap.cpp:176-184)
  * GetCorrespondences: brute-force nearest point over the 3^3 = 27
    neighboring voxels; squared distance is scaled by sem_th iff labels
    match or either label is 0 (argmin on the scaled metric), acceptance
    tests the UNWEIGHTED distance < max_correspondence_distance
    (VoxelHashMap.cpp:48-130, the :88/:111 subtlety)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sage_icp_tpu.ops import routing
from sage_icp_tpu.ops.scan import INVALID_COORD, trunc_div

# Probe depth for bounded linear probing. With capacity >= 2x expected live
# voxels, the probability of a probe-window overflow is negligible.
DEFAULT_PROBE_DEPTH = 16


class InsertStats(NamedTuple):
    """Per-frame overflow counters (all i32 scalars). A fixed-shape map
    drops work silently when undersized — these make every drop visible:
      * unique_overflow: distinct incoming voxels beyond
        insert_unique_capacity (their points are not inserted)
      * claim_failures: new voxels whose probe window was exhausted
        (all probe_depth triangular-offset slots taken — table too full)
      * incoming_truncated: points beyond max_incoming_per_voxel within
        one voxel's segment this frame (policy never saw them)
    """

    unique_overflow: jax.Array
    claim_failures: jax.Array
    incoming_truncated: jax.Array


class MapState(NamedTuple):
    """Fixed-capacity semantic voxel map. All leaves are device arrays."""

    keys: jax.Array  # int32[C, 3]
    counts: jax.Array  # int32[C]
    points: jax.Array  # int16[C, 4, K] PLANAR quantized voxel-local planes
    #                      [x*K | y*K | z*K | label*K]: a flat (C, 4K) view
    #                      is gather-ready for the correspondence engine and
    #                      the insert kernel slices components as contiguous
    #                      K-lane spans
    # each block's FIRST point, kept as a side table so the distance cull
    # (remove_far) reads 3 MB instead of striding the whole block buffer
    first_pts: jax.Array  # f32[C, 3]
    # OPTIONAL toroidal dense index (see grid_probe): voxel -> slot in ONE
    # 8-byte-row gather instead of a D-deep hash-window probe. None when
    # the map was created with dense_grid=False (scratch maps, fallbacks).
    grid: jax.Array | None = None  # int32[2^22, 2] rows [slot | hi-check]
    #                                slot -1 = empty cell

    @property
    def capacity(self) -> int:
        return self.counts.shape[0]

    @property
    def points_per_voxel(self) -> int:
        return self.points.shape[2]


# Key sentinel for never-used slots: no real voxel coordinate can equal it
# (truncated coords of live points are bounded by max_range / voxel_size,
# and masked points sit at +INVALID_COORD).
EMPTY_KEY = -(1 << 20)


# int16 full-scale = one voxel size (quantized local offsets span (-v, v)
# because trunc_div voxel origins put locals in (-v, v), not [0, v)).
QSCALE = 32767.0


# Toroidal dense-index geometry: 8 bits for x and y (256-voxel span), 6
# for z (64-voxel span). The range-culled local map spans at most
# 2*local_map_range/voxel_size voxels (250 at the KITTI 100 m / 0.8 m
# setting) horizontally and far less vertically, so modular indexing is
# alias-free among LIVE voxels; stale/ancient cells are disambiguated by
# the high-bits checksum in grid_hi.
GRID_XY_BITS = 8
GRID_Z_BITS = 6
GRID_SIZE = 1 << (2 * GRID_XY_BITS + GRID_Z_BITS)  # 2^22 cells


def grid_index(keys: jax.Array) -> jax.Array:
    """Voxel coords (…, 3) -> toroidal dense-grid cell index."""
    kx, ky, kz = keys[..., 0], keys[..., 1], keys[..., 2]
    return (
        ((kx & ((1 << GRID_XY_BITS) - 1)) << (GRID_XY_BITS + GRID_Z_BITS))
        | ((ky & ((1 << GRID_XY_BITS) - 1)) << GRID_Z_BITS)
        | (kz & ((1 << GRID_Z_BITS) - 1))
    )


def grid_hi_code(keys: jax.Array) -> jax.Array:
    """Checksum of the coordinate bits ABOVE the torus period — two voxels
    in the same cell always differ here (hash-mixed; wraparound int32)."""
    hx = keys[..., 0] >> GRID_XY_BITS
    hy = keys[..., 1] >> GRID_XY_BITS
    hz = keys[..., 2] >> GRID_Z_BITS
    return (
        hx * jnp.int32(73856093)
        ^ hy * jnp.int32(19349663)
        ^ hz * jnp.int32(83492791)
    )


def create(
    capacity: int, points_per_voxel: int, dtype=jnp.float32,
    dense_grid: bool = False,
) -> MapState:
    assert capacity & (capacity - 1) == 0, "capacity must be a power of two"
    return MapState(
        keys=jnp.full((capacity, 3), EMPTY_KEY, dtype=jnp.int32),
        counts=jnp.zeros((capacity,), dtype=jnp.int32),
        points=jnp.zeros((capacity, 4, points_per_voxel), dtype=jnp.int16),
        first_pts=jnp.full((capacity, 3), INVALID_COORD, dtype=dtype),
        grid=(
            jnp.concatenate(
                [
                    jnp.full((GRID_SIZE, 1), -1, jnp.int32),
                    jnp.zeros((GRID_SIZE, 1), jnp.int32),
                ],
                axis=1,
            )
            if dense_grid
            else None
        ),
    )


def grid_probe(
    state: MapState, query_keys: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Dense-index lookup: (found, slot (clamped 0)) for voxel keys
    (…, 3). ONE 8-byte-row gather into the torus + a checksum compare
    replace the D-slot hash-window probe; everything needed rides that
    one row (a first version with separate slot/checksum/count gathers
    was slower than the window probe on the accelerator this was first
    written for; not measured on the H100). Block emptiness (culled voxels) is
    NOT resolved here: the fast correspondence path reads validity from
    the sanitized label lane (-1 beyond each block's count) and insert
    re-reads counts[slot] itself. Entries whose slot was re-claimed by
    another voxel are cleared at claim time, so a checksum match is
    definitive."""
    t = grid_index(query_keys)
    g = state.grid[t]  # (…, 2) one row gather
    slot = g[..., 0]
    found = (slot >= 0) & (g[..., 1] == grid_hi_code(query_keys))
    return found, jnp.where(found, slot, 0)


def quantize_points(
    points: jax.Array, vkeys: jax.Array, voxel_size, out_dtype=jnp.float32
) -> jax.Array:
    """(…, 4) f32 world xyz+label -> (…, 4) int16 quantized-local + label.
    vkeys: (…, 3) int32 the points' voxel coords (trunc_div semantics)."""
    local = points[..., :3] - vkeys.astype(points.dtype) * voxel_size
    q = jnp.clip(
        jnp.round(local * (QSCALE / voxel_size)), -QSCALE, QSCALE
    ).astype(jnp.int16)
    lab = points[..., 3:4].astype(jnp.int16)
    return jnp.concatenate([q, lab], axis=-1)


def dequantize_points(
    stored: jax.Array, vkeys: jax.Array, voxel_size, dtype=jnp.float32
) -> jax.Array:
    """Inverse of quantize_points: (…, 4) int16 -> (…, 4) f32 world."""
    xyz = (
        stored[..., :3].astype(dtype) * (voxel_size / QSCALE)
        + vkeys.astype(dtype) * voxel_size
    )
    return jnp.concatenate([xyz, stored[..., 3:4].astype(dtype)], axis=-1)


def dequantize_blocks(
    stored: jax.Array, vkeys: jax.Array, voxel_size, dtype=jnp.float32
) -> jax.Array:
    """(…, 4, K) int16 planar block planes -> (…, K, 4) f32 world points.
    vkeys: (…, 3) the blocks' voxel coords."""
    xyz = (
        stored[..., :3, :].astype(dtype) * (voxel_size / QSCALE)
        + vkeys[..., :, None].astype(dtype) * voxel_size
    )  # (…, 3, K)
    lab = stored[..., 3:4, :].astype(dtype)
    return jnp.moveaxis(jnp.concatenate([xyz, lab], axis=-2), -2, -1)


# Bump whenever hash_keys (or slot-placement semantics) changes: slot
# positions are baked into checkpoints, so a checkpoint written under a
# different layout loads with every entry unfindable. v3 = triangular
# probing (round 3); v2 = Fibonacci high-bits mixing (round 2); v1 =
# low-bits 3-prime XOR (round 1).
HASH_LAYOUT_VERSION = 3


def probe_offset(d):
    """Triangular probe offset for round d: 0, 1, 3, 6, 10, ...

    Linear probing suffers primary clustering: occupied runs attract
    further insertions, so the probability that probe_depth CONSECUTIVE
    slots are all full is far higher than load^depth (measured: one lost
    voxel per ~500 at load 0.53 with depth 12 — a claim failure silently
    drops the voxel's points, tests/test_hashmap.py caught it against the
    oracle). Triangular offsets d(d+1)/2 sample a spread of slots, so a
    full window needs depth INDEPENDENT collisions (~load^depth); on a
    power-of-two table the sequence visits all slots (classic quadratic
    probing property). The probe windows (correspondence_fast.build_probe_
    tables) roll at the same offsets — build and probe costs unchanged."""
    return (d * (d + 1)) // 2


def hash_keys(keys: jax.Array, capacity: int) -> jax.Array:
    """Spatial hash (reference VoxelHashMap.hpp:72-77) + Fibonacci mixing.

    The reference's chained std::unordered_map tolerates a weak hash; an
    open-addressing table does not. Masking the 3-prime XOR to its LOW
    bits clusters structured voxel grids badly: on the bench corridor at
    load 0.17 serial linear probing already exhausts an 8-slot window for
    8% of keys (simulated on the host). Multiplying by 2^32/phi and
    taking the HIGH bits decorrelates the lattice: failures drop ~12x at
    equal load. Semantics are unchanged (any hash is correct; insert,
    lookup and the probe windows all route through this function)."""
    k = keys.astype(jnp.uint32)
    h = (
        k[..., 0] * jnp.uint32(73856093)
        ^ k[..., 1] * jnp.uint32(19349663)
        ^ k[..., 2] * jnp.uint32(83492791)
    )
    bits = int(capacity).bit_length() - 1
    h = (h * jnp.uint32(2654435769)) >> jnp.uint32(32 - bits)
    return h.astype(jnp.int32)


def lookup(
    state: MapState, query_keys: jax.Array, probe_depth: int = DEFAULT_PROBE_DEPTH
) -> jax.Array:
    """Find slots of voxel keys. query_keys: int32[..., 3] -> int32[...]
    slot index, or -1 when absent. Inspects all D probe slots at once."""
    cap = state.capacity
    h = hash_keys(query_keys, cap)  # (...,)
    offs = probe_offset(jnp.arange(probe_depth, dtype=jnp.int32))
    slots = (h[..., None] + offs) & (cap - 1)  # (..., D)
    cand = state.keys[slots]  # (..., D, 3)
    match = jnp.all(cand == query_keys[..., None, :], axis=-1)  # (..., D)
    # a free slot (count 0) with a stale matching key is still "the" slot
    # for that key: reusing it keeps at most one copy of each key alive.
    any_match = jnp.any(match, axis=-1)
    first = jnp.argmax(match, axis=-1)
    slot = jnp.take_along_axis(slots, first[..., None], axis=-1)[..., 0]
    return jnp.where(any_match, slot, -1)


def _unique_voxels_of_points(
    points: jax.Array, valid: jax.Array, voxel_size
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Sort points by voxel (carrying the point planes as sort payloads —
    no post-sort gather), find segment heads.

    Returns (points_sorted (N,4), voxel_keys_sorted (N,3), head (N,) bool,
    valid_sorted (N,)). Stability preserves scan order within a voxel —
    the retention policy is order-sensitive."""
    v = trunc_div(points[:, :3], voxel_size)  # (N, 3)
    # Offset to a frame-local box so coords pack into sortable uint32 pairs.
    vmin = jnp.min(jnp.where(valid[:, None], v, 2**20), axis=0)
    vo = jnp.clip(v - vmin, 0, 4095)  # 12 bits/axis within a frame
    key_hi = vo[:, 0].astype(jnp.uint32)
    key_lo = vo[:, 1].astype(jnp.uint32) * jnp.uint32(4096) + vo[:, 2].astype(
        jnp.uint32
    )
    big = jnp.uint32(0xFFFFFFFF)
    key_hi = jnp.where(valid, key_hi, big)
    key_lo = jnp.where(valid, key_lo, big)
    kh, kl, sx, sy, sz, sl = jax.lax.sort(
        (key_hi, key_lo, points[:, 0], points[:, 1], points[:, 2],
         points[:, 3]),
        num_keys=2,
        is_stable=True,
    )
    pts_sorted = jnp.stack([sx, sy, sz, sl], axis=-1)
    val_sorted = kh != big
    vkeys_sorted = trunc_div(pts_sorted[:, :3], voxel_size)
    head = jnp.concatenate(
        [jnp.array([True]), (kh[1:] != kh[:-1]) | (kl[1:] != kl[:-1])]
    )
    return pts_sorted, vkeys_sorted, head, val_sorted


def insert(
    state: MapState,
    points: jax.Array,
    valid: jax.Array,
    voxel_size,
    basic_points: int,
    basic_label_mask: jax.Array,
    max_incoming_per_voxel: int = 24,
    probe_depth: int = DEFAULT_PROBE_DEPTH,
    unique_voxel_capacity: int | None = None,
    tables=None,
    kernel_mode: str | None = None,  # ops/routing mode of the retention
    #   policy (None = the backend's route: the kernel on a GPU, the XLA
    #   while_loop on the CPU)
    basic_labels: tuple | None = None,  # static label set: enables the
    #                                     compare-chain classification
    #                                     (no per-point LUT gather)
    with_stats: bool = False,  # also return InsertStats overflow counters
    mesh=None,  # jax.sharding.Mesh: shard the policy phase's row axis
    #   across this mesh (see "multi-chip" note below)
    shard_axis: str = "points",
) -> MapState:
    """AddPoints with the reference's per-block retention policy.

    points: (N, 4) world-frame xyz+label; valid: (N,).
    basic_label_mask: bool[L] — True for labels in basic_parts_labels.

    Policy is applied in scan order per voxel: the incoming points are
    sorted by voxel, each voxel's segment is identified, and round r
    applies the r-th point of every segment simultaneously — sequential
    semantics per voxel, full vectorization across voxels. Rounds run in a
    while_loop bounded by the ACTUAL max points-per-voxel this frame (at
    steady state 2-8, far below the static cap), and all per-round work
    operates on the compacted unique-voxel arrays, not the full point set.

    Multi-chip (mesh != None): the policy phase — the block gathers, the
    incoming-window gathers, and the Pallas policy kernel — is sharded
    over the compact ROW axis (U/n rows per device, shard_map around the
    kernel; GSPMD propagates the row sharding into the surrounding
    gathers), then the updated blocks all-gather for the replicated
    write-back. Rows are independent, so the sharded result is EXACTLY
    the single-device result. This deliberately deviates from a
    hash-prefix-sharded table: triangular
    probing crosses any slot-range partition (h + d(d+1)/2 lands up to
    66 slots past h), so prefix-local claims can race across shard
    boundaries — two devices claiming one physical slot for different
    voxels — while row-sharding the policy work removes the same
    replicated cost (the dominant insert phase) with no such hazard and
    no all-to-all. The claim loop (1-2 scatter rounds at steady state)
    and the O(C) cull stay replicated. U must divide by n_devices
    (parallel/sharding.pad_config_for_mesh enforces this).
    """
    cap = state.capacity
    kmax = state.points_per_voxel
    n = points.shape[0]
    if unique_voxel_capacity is None:
        unique_voxel_capacity = n
    U = unique_voxel_capacity

    pts_sorted, vkeys, head, val_sorted = _unique_voxels_of_points(
        points, valid, voxel_size
    )

    # --- compact unique voxels ------------------------------------------------
    head_valid = head & val_sorted
    pos = jnp.arange(n, dtype=jnp.int32)
    u_rank = jnp.cumsum(head_valid) - 1  # rank among valid heads
    u_src = jnp.where(head_valid & (u_rank < U), u_rank, U)  # drop overflow
    head_pos = jnp.full((U,), n, dtype=jnp.int32).at[u_src].set(
        pos, mode="drop", unique_indices=True
    )
    # unique keys by GATHER from the head positions (scatters are slow)
    ukeys = vkeys[jnp.minimum(head_pos, n - 1)]
    n_unique = jnp.sum(head_valid.astype(jnp.int32))
    u_live = jnp.arange(U, dtype=jnp.int32) < jnp.minimum(n_unique, U)
    # exact per-voxel incoming count: every sorted valid point scatter-adds
    # into its segment id (non-decreasing -> sorted-indices fast path)
    pt_u = jnp.cumsum(head_valid) - 1
    seg_idx = jnp.where(val_sorted & (pt_u < U), pt_u, U)
    seg_len = (
        jnp.zeros((U,), jnp.int32)
        .at[seg_idx]
        .add(1, mode="drop", indices_are_sorted=True)
    )

    # --- resolve a slot per unique voxel (lookup, then claim races) ---------
    if state.grid is not None:
        # toroidal dense index: one row gather per voxel
        found_u, slots_u = grid_probe(state, ukeys)
        slot_u = jnp.where(u_live & found_u, slots_u, -1)
    elif tables is not None:
        # packed-window probe (see ops.correspondence_fast): one wide-row
        # gather per voxel instead of D tiny key gathers
        from sage_icp_tpu.ops import correspondence_fast as cf

        rel_u = ukeys - tables.center[None, :]
        found_u, slots_u = cf.probe(
            tables, ukeys, cf.pack_rel(rel_u), probe_depth
        )
        slot_u = jnp.where(u_live & found_u, slots_u, -1)
    else:
        slot_u = jnp.where(u_live, lookup(state, ukeys, probe_depth), -1)
    need_claim = u_live & (slot_u < 0)
    h = hash_keys(ukeys, cap)
    taken = state.counts > 0  # live slots can't be claimed
    # ...nor can slots already resolved THIS frame by the pre-claim lookup:
    # a culled block being revived in place (count 0, key still matching)
    # would otherwise collide with a claimant and two rows would write one
    # slot (silent data loss under the unique-indices write-back)
    pre = u_live & (slot_u >= 0)
    taken = taken.at[jnp.where(pre, slot_u, cap)].set(
        True, mode="drop", unique_indices=True
    )
    uid = jnp.arange(U, dtype=jnp.int32)

    # rounds run only while someone is unresolved: at steady state almost
    # every arriving voxel either exists already or claims in round 0-1,
    # so this while_loop does 1-2 iterations instead of probe_depth
    def claim_cond(carry):
        d, slot_u, _ = carry
        return (d < probe_depth) & jnp.any(need_claim & (slot_u < 0))

    def claim_round(carry):
        d, slot_u, taken = carry
        unresolved = need_claim & (slot_u < 0)
        s = (h + probe_offset(d)) & (cap - 1)
        eligible = unresolved & ~taken[s]
        # scatter-min of uid resolves races between distinct voxels
        claim = jnp.full((cap,), jnp.iinfo(jnp.int32).max, dtype=jnp.int32)
        claim = claim.at[jnp.where(eligible, s, cap)].min(uid, mode="drop")
        won = eligible & (claim[s] == uid)
        slot_u = jnp.where(won, s, slot_u)
        taken = taken.at[jnp.where(won, s, cap)].set(
            True, mode="drop", unique_indices=True
        )
        return d + 1, slot_u, taken

    _, slot_u, _ = jax.lax.while_loop(
        claim_cond, claim_round, (jnp.asarray(0, jnp.int32), slot_u, taken)
    )

    # write the claimed keys (stale keys in reused slots are overwritten);
    # a reused slot may hold a stale count from a culled block -> reset 0
    newly = need_claim & (slot_u >= 0)
    wnew = jnp.where(newly, slot_u, cap)
    new_keys = state.keys.at[wnew].set(ukeys, mode="drop", unique_indices=True)
    new_counts = state.counts.at[wnew].set(0, mode="drop", unique_indices=True)

    # --- maintain the toroidal dense index ----------------------------------
    grid = state.grid
    if grid is not None:
        # a re-claimed slot's PREVIOUS owner (a culled voxel) may still have
        # a grid entry pointing here — clear it, unless that cell was since
        # taken over by some other live voxel
        old_keys = state.keys[jnp.where(newly, slot_u, 0)]  # pre-overwrite
        had_owner = newly & jnp.any(old_keys != EMPTY_KEY, axis=-1)
        t_old = grid_index(old_keys)
        still_ours = grid[t_old, 0] == slot_u
        grid = grid.at[
            jnp.where(had_owner & still_ours, t_old, GRID_SIZE), 0
        ].set(-1, mode="drop")
        # (re)write entries for every voxel touched this frame; distinct
        # live voxels occupy distinct cells (range-culled span < period)
        t_new = jnp.where(u_live & (slot_u >= 0), grid_index(ukeys),
                          GRID_SIZE)
        rows = jnp.stack([slot_u, grid_hi_code(ukeys)], axis=-1)
        grid = grid.at[t_new].set(rows, mode="drop", unique_indices=True)

    has_slot = u_live & (slot_u >= 0)
    rounds = jnp.minimum(
        jnp.max(jnp.where(u_live, seg_len, 0)), max_incoming_per_voxel
    )
    stats = InsertStats(
        unique_overflow=jnp.maximum(n_unique - U, 0).astype(jnp.int32),
        claim_failures=jnp.sum((need_claim & (slot_u < 0)).astype(jnp.int32)),
        incoming_truncated=jnp.sum(
            jnp.where(
                u_live,
                jnp.maximum(seg_len - max_incoming_per_voxel, 0),
                0,
            )
        ).astype(jnp.int32),
    ) if with_stats else None

    # --- retention policy on a COMPACT per-frame buffer ---------------------
    # The policy rounds mutate only the <= U touched voxels; running them
    # directly on the (C, K, 4) table would make every round rewrite the
    # whole ~84 MB block buffer. Instead: gather the touched blocks once
    # (wide 320 B rows), run all rounds on the (U, K, 4) compact buffer,
    # scatter back once.
    num_labels = basic_label_mask.shape[0]
    kidx = jnp.arange(kmax, dtype=jnp.int32)
    slot_c = jnp.where(has_slot, slot_u, 0)  # safe gather index
    points2 = state.points.reshape(cap, 4 * kmax)
    compact = points2[slot_c].reshape(U, 4, kmax)  # (U, 4, K) int16 planes
    ccounts = new_counts[slot_c]  # (U,)
    uidx = jnp.arange(U, dtype=jnp.int32)
    # --- fused policy kernel: all rounds in one launch instead of one
    # lax.while_loop iteration per incoming rank ---------------------------
    Rmax = max_incoming_per_voxel
    mode = routing.resolve(kernel_mode)
    if mode != routing.XLA:
        from sage_icp_tpu.ops import pallas_insert as pik

        lab_s = jnp.clip(
            pts_sorted[:, 3].astype(jnp.int32), 0, num_labels - 1
        )
        if basic_labels is not None:
            from sage_icp_tpu.ops.scan import label_in_set

            is_basic_s = label_in_set(lab_s, basic_labels)
        else:
            is_basic_s = basic_label_mask[lab_s]  # per-point LUT gather
        cls_s = jnp.where(lab_s == 0, 0, jnp.where(is_basic_s, 1, 2))
        pq_all = quantize_points(pts_sorted, vkeys, voxel_size)  # (N, 4)
        enc = (lab_s | (cls_s << pik.CLS_SHIFT)).astype(jnp.int16)
        # each row's incoming points are CONTIGUOUS in the voxel-sorted
        # array: Rmax cheap rolls build per-COMPONENT (N, Rmax) window
        # tables and each incoming plane comes from ONE wide-row gather
        # (planar, rank-major per component). Window wrap-around rows
        # are gated by seglen in the kernel.
        hp_c = jnp.minimum(head_pos, n - 1)

        def inc_plane(comp):
            win = jnp.concatenate(
                [jnp.roll(comp, -r)[:, None] for r in range(Rmax)], axis=1
            )  # (N, Rmax)
            return win[hp_c]  # (U, Rmax)

        inc_x = inc_plane(pq_all[:, 0])
        inc_y = inc_plane(pq_all[:, 1])
        inc_z = inc_plane(pq_all[:, 2])
        inc_e = inc_plane(enc)
        seglen_eff = jnp.where(
            has_slot, jnp.minimum(seg_len, Rmax), 0
        )[:, None]
        interpret = mode == routing.INTERPRET
        if mesh is not None and shard_axis in mesh.shape:
            # row-sharded policy: each device runs the kernel on its
            # U/n-row shard (see the multi-chip note in the docstring)
            from jax import shard_map
            from jax.sharding import PartitionSpec as P

            n_dev = mesh.shape[shard_axis]
            assert U % n_dev == 0, (
                f"insert_unique_capacity {U} must divide evenly across "
                f"{n_dev} devices (parallel.sharding.pad_config_for_mesh)"
            )

            def _policy_local(bx_, by_, bz_, bl_, cnt_, seg_,
                              ix_, iy_, iz_, ie_, r_):
                return pik.apply_policy(
                    bx_, by_, bz_, bl_, cnt_, seg_, ix_, iy_, iz_, ie_, r_,
                    n_rounds=Rmax, basic=basic_points, interpret=interpret,
                )

            row = P(shard_axis)
            bx, by, bz, bl, cnt2 = shard_map(
                _policy_local, mesh=mesh,
                in_specs=(row,) * 10 + (P(),),
                out_specs=(row, row, row, row, row),
                check_vma=False,
            )(
                compact[:, 0, :], compact[:, 1, :], compact[:, 2, :],
                compact[:, 3, :], ccounts[:, None], seglen_eff,
                inc_x, inc_y, inc_z, inc_e,
                rounds,
            )
        else:
            bx, by, bz, bl, cnt2 = pik.apply_policy(
                compact[:, 0, :], compact[:, 1, :], compact[:, 2, :],
                compact[:, 3, :], ccounts[:, None], seglen_eff,
                inc_x, inc_y, inc_z, inc_e, rounds,
                n_rounds=Rmax, basic=basic_points, interpret=interpret,
            )
        compact = jnp.stack([bx, by, bz, bl], axis=1)
        ccounts = cnt2[:, 0]
        out = _insert_writeback(
            state, points2, compact, ccounts, has_slot, slot_u, ukeys,
            new_keys, new_counts, grid, voxel_size, cap, kmax, U,
        )
        return (out, stats) if with_stats else out

    # live label-0 slots, maintained INCREMENTALLY across rounds so each
    # round touches ~(U,K) bools instead of re-reading the compact buffer
    blk_labels0 = compact[:, 3, :].astype(jnp.int32)
    zero_live0 = (blk_labels0 == 0) & (kidx[None, :] < ccounts[:, None])

    def policy_cond(carry):
        r, _, _, _ = carry
        return r < rounds

    def policy_body(carry):
        r, ccounts, compact, zero_live = carry
        act = has_slot & (r < seg_len)
        p = pts_sorted[jnp.minimum(head_pos + r, n - 1)]  # (U, 4) f32 world
        pq = quantize_points(p, ukeys, voxel_size)  # (U, 4) int16 local
        lab = jnp.clip(p[:, 3].astype(jnp.int32), 0, num_labels - 1)
        is_basic = basic_label_mask[lab]
        cnt = ccounts
        has_zero = jnp.any(zero_live, axis=-1)
        first_zero = jnp.argmax(zero_live, axis=-1)

        append_basic = cnt < basic_points
        drop_zero = ~append_basic & (lab == 0)
        overwrite_b = ~append_basic & (lab != 0) & is_basic
        append_crit = ~append_basic & (lab != 0) & ~is_basic & (cnt < kmax)
        overwrite_c = ~append_basic & (lab != 0) & ~is_basic & (cnt >= kmax)

        do_append = act & (append_basic | append_crit)
        do_overwrite = act & (overwrite_b | overwrite_c) & has_zero & ~drop_zero
        target = jnp.where(do_append, cnt, first_zero)
        write = do_append | do_overwrite
        # dense one-hot blend instead of a 2D scatter: writing one point
        # per row is an elementwise pass over the compact buffer
        onehot_t = kidx[None, :] == target[:, None]  # (U, K)
        sel = write[:, None] & onehot_t
        compact = jnp.where(sel[:, None, :], pq[:, :, None], compact)
        # written slot becomes zero-live iff the written label is 0 (an
        # appended unknown point); an overwrite target stops being zero
        zero_live = jnp.where(sel, (lab == 0)[:, None], zero_live)
        ccounts = ccounts + do_append.astype(jnp.int32)
        return r + 1, ccounts, compact, zero_live

    _, ccounts, compact, _ = jax.lax.while_loop(
        policy_cond,
        policy_body,
        (jnp.asarray(0, jnp.int32), ccounts, compact, zero_live0),
    )
    out = _insert_writeback(
        state, points2, compact, ccounts, has_slot, slot_u, ukeys,
        new_keys, new_counts, grid, voxel_size, cap, kmax, U,
    )
    return (out, stats) if with_stats else out


def _insert_writeback(
    state, points2, compact, ccounts, has_slot, slot_u, ukeys, new_keys,
    new_counts, grid, voxel_size, cap, kmax, U
):
    """Write the policy-mutated compact blocks back into the table (slots
    are unique across live rows: lookups return distinct slots for
    distinct keys and claim races have a single winner per slot).

    The label plane is SANITIZED on the way out: lanes at or beyond the
    block's count get label -1, so the fast correspondence path can read
    per-lane validity straight from storage (no counts gather per probed
    neighbor — see grid_probe)."""
    kidx2 = jnp.arange(kmax, dtype=jnp.int32)
    lab_plane = jnp.where(
        kidx2[None, :] < ccounts[:, None],
        compact[:, 3, :],
        jnp.int16(-1),
    )
    compact = jnp.concatenate(
        [compact[:, :3, :], lab_plane[:, None, :]], axis=1
    )
    wslot2 = jnp.where(has_slot, slot_u, cap)
    new_points = points2.at[wslot2].set(
        compact.reshape(U, 4 * kmax), mode="drop", unique_indices=True
    ).reshape(cap, 4, kmax)
    new_counts = new_counts.at[wslot2].set(
        ccounts, mode="drop", unique_indices=True
    )
    first_world = (
        compact[:, :3, 0].astype(state.first_pts.dtype)
        * (voxel_size / QSCALE)
        + ukeys.astype(state.first_pts.dtype) * voxel_size
    )  # each block's FIRST point, world frame
    new_first = state.first_pts.at[wslot2].set(
        first_world, mode="drop", unique_indices=True
    )
    return MapState(
        keys=new_keys, counts=new_counts, points=new_points,
        first_pts=new_first, grid=grid,
    )


def remove_far(state: MapState, origin: jax.Array, max_distance) -> MapState:
    """Erase blocks whose FIRST point is > max_distance from origin
    (reference VoxelHashMap.cpp:176-184).

    Culled blocks are ERASED, not just emptied: keys go to EMPTY_KEY and
    first_pts to the sentinel, so no probe (hash window, packed window,
    lookup) can ever match them again — the fast correspondence path reads
    per-lane validity from the sanitized label plane, which stays stale in
    storage until the slot is reclaimed, and a matchable stale key would
    silently resurrect deleted map data on revisits (the reference erases
    the robin_map entry outright). The dense grid's cell for each killed
    voxel is cleared likewise."""
    first = state.first_pts
    d2 = jnp.sum((first - origin[None, :]) ** 2, axis=-1)
    live = state.counts > 0
    kill = live & (d2 > max_distance * max_distance)
    killn = kill[:, None]
    grid = state.grid
    if grid is not None:
        cap = state.capacity
        t = grid_index(state.keys)
        # only clear cells still owned by the killed slot (a later claimant
        # may have overwritten the cell for its own voxel)
        still = grid[t, 0] == jnp.arange(cap, dtype=jnp.int32)
        grid = grid.at[jnp.where(kill & still, t, GRID_SIZE), 0].set(
            -1, mode="drop"
        )
    return state._replace(
        counts=jnp.where(kill, 0, state.counts),
        keys=jnp.where(killn, EMPTY_KEY, state.keys),
        first_pts=jnp.where(
            killn, jnp.asarray(INVALID_COORD, state.first_pts.dtype),
            state.first_pts,
        ),
        grid=grid,
    )


def clear(state: MapState) -> MapState:
    return create(
        state.capacity, state.points_per_voxel, state.first_pts.dtype,
        dense_grid=state.grid is not None,
    )


def is_empty(state: MapState) -> jax.Array:
    return ~jnp.any(state.counts > 0)


def pointcloud(state: MapState, voxel_size) -> tuple[jax.Array, jax.Array]:
    """Flatten all live points (dequantized to world frame):
    returns ((C*K, 4), (C*K,) mask)."""
    kidx = jnp.arange(state.points_per_voxel, dtype=jnp.int32)
    mask = kidx[None, :] < state.counts[:, None]
    world = dequantize_blocks(state.points, state.keys, voxel_size)
    return world.reshape(-1, 4), mask.reshape(-1)


# 27-neighborhood offsets, static constant (reference VoxelHashMap.cpp:57-63).
_NEIGHBOR_OFFSETS = jnp.array(
    [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    dtype=jnp.int32,
)


def get_correspondences(
    state: MapState,
    query: jax.Array,
    valid: jax.Array,
    voxel_size,
    max_correspondence_distance,
    sem_th,
    probe_depth: int = DEFAULT_PROBE_DEPTH,
) -> tuple[jax.Array, jax.Array]:
    """Semantic nearest-neighbor search over the 27 neighboring voxels.

    query: (N, 4); returns (target (N, 4), accept (N,) bool). Matches the
    reference metric exactly: argmin over sem_th-scaled squared distance,
    acceptance via unweighted Euclidean distance (VoxelHashMap.cpp:88,111).
    """
    kmax = state.points_per_voxel
    v = trunc_div(query[:, :3], voxel_size)  # (N, 3)
    nb = v[:, None, :] + _NEIGHBOR_OFFSETS[None, :, :]  # (N, 27, 3)
    slots = lookup(state, nb, probe_depth)  # (N, 27)
    found = slots >= 0
    safe = jnp.where(found, slots, 0)
    # a found slot's key equals the probed neighbor coord, so dequantize
    # against nb directly (no key gather needed)
    cand = dequantize_blocks(
        state.points[safe], nb, voxel_size, query.dtype
    )  # (N, 27, K, 4) world
    cnt = state.counts[safe]  # (N, 27)
    kidx = jnp.arange(kmax, dtype=jnp.int32)
    cmask = found[..., None] & (kidx[None, None, :] < cnt[..., None])  # (N,27,K)

    diff = cand[..., :3] - query[:, None, None, :3]
    d2 = jnp.sum(diff * diff, axis=-1)  # (N, 27, K)
    ql = query[:, 3].astype(jnp.int32)
    cl = cand[..., 3].astype(jnp.int32)
    sem = (cl == ql[:, None, None]) | (cl * ql[:, None, None] == 0)
    d2w = jnp.where(sem, d2 * sem_th, d2)
    inf = jnp.asarray(jnp.finfo(d2.dtype).max, d2.dtype)
    d2w = jnp.where(cmask, d2w, inf)

    flat_w = d2w.reshape(d2w.shape[0], -1)
    best = jnp.argmin(flat_w, axis=-1)  # (N,)
    any_cand = jnp.any(cmask.reshape(cmask.shape[0], -1), axis=-1)
    tgt = jnp.take_along_axis(
        cand.reshape(cand.shape[0], -1, 4), best[:, None, None], axis=1
    )[:, 0, :]
    d2_true = jnp.take_along_axis(
        d2.reshape(d2.shape[0], -1), best[:, None], axis=1
    )[:, 0]
    accept = (
        valid
        & any_cand
        & (jnp.sqrt(d2_true) < max_correspondence_distance)
    )
    return tgt, accept
