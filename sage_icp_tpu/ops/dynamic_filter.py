"""Dynamic-vehicle filter: remove moving vehicles, keep parked ones.

Accelerator re-design of the reference's PCL pipeline
(cpp/sage_icp/core/Preprocessing.cpp:95-172):

  reference                           | this implementation
  ------------------------------------+----------------------------------
  EuclideanClusterExtraction          | connected components over a 0.5 m
  (tolerance 0.5 m, min size 5)       | DENSE voxel grid of vehicle cells:
                                      | 27-connectivity min-label diffusion
                                      | as 3x3x3 reduce_window min-pooling
  KdTreeFLANN radiusSearch (0.5 m)    | exact distance test against the
  against the full scan, per cluster  | landmark points gathered from the
  point, counting landmark-labeled    | 27 neighboring 0.5 m cells (a
  (parking/sidewalk 44/48) neighbors  | radius-0.5 sphere fits inside the
                                      | 27-cell box): one fused compare-
                                      | and-count reduction per query slot
  keep cluster iff neighbor count     | identical decision rule, summed
  > dy_th * cluster_size              | per cluster via scatter-add

A cluster whose summed landmark-neighbor count exceeds dy_th * size is a
parked ("static") vehicle and is kept; every other vehicle-class point is
removed. Non-vehicle points always pass through. Voxel connectivity links
points up to sqrt(3)*0.5 m apart vs the reference's exact 0.5 m tolerance —
a slightly coarser clustering that merges near-adjacent vehicles; the
keep/remove decision is dominated by the landmark test, so trajectories
match within noise.

Why dense grids: an earlier implementation reused the open-addressing
hash machinery for its scratch structures, which made every step a
latency-bound class of work: per-probe element gathers for the
27-neighbor lookups, 24 rounds of (V, 27) component gathers, the policy
while_loop of the scratch inserts, and a materialized (Nv, 27, K) radius
test. Vehicle/landmark labels only exist within label_max_range
(Preprocessing.cpp:103 zeroes labels beyond it), so the whole problem
fits a DENSE 0.5 m grid of static extent: neighbor lookup becomes direct
indexing, component diffusion becomes shifted-window min-pooling (zero
gathers), per-class "inserts" become one stable sort + segment ranks
each, and the radius test counts over deduplicated query rows. Same
decision semantics.

Out-of-grid points (|z - z_center| beyond the grid's 16 m span — no
labeled point is ever that far off the sensor plane) PASS THROUGH and
are counted in the overflow stat, like cap overflows.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from sage_icp_tpu.ops.scan import INVALID_COORD, label_in_set, trunc_div

CLUSTER_TOLERANCE = 0.5  # reference Preprocessing.cpp:133
MIN_CLUSTER_SIZE = 5  # reference Preprocessing.cpp:134
SEARCH_RADIUS = 0.5  # reference Preprocessing.cpp:148

# fixed capacities for the per-frame scratch structures
_LMK_VOXEL_CAP = 4096  # distinct 0.5 m cells holding landmark points
_LMK_PER_VOXEL = 32  # landmark points stored per cell
_CC_ITERS = 24  # min-diffusion rounds (cluster diameter bound, cells)
_VEH_PTS_CAP = 16384  # vehicle-class points per scan (within label range)
_VEH_ROW_CAP = 4096  # distinct 0.5 m cells holding vehicle points
_VEH_PER_ROW = 48  # vehicle query slots per cell row (a 0.5 m cell on a
#   dense car face at KITTI point density holds ~10-20 returns; 16 slots
#   overflowed ~18 points/frame on the density-1.3 bench world and 32
#   still clipped a few points on later frames — the overflow counter
#   rides the bench honesty guard, so the cap carries real margin; the
#   radius count costs rows x 27K x P compares)
_LMK_PTS_CAP = 49152  # landmark-class points per scan
_GRID_NZ = 32  # z cells: 16 m span around the sensor plane


def _label_in(labels: jax.Array, wanted: tuple) -> jax.Array:
    # compare chain, not a LUT gather
    return label_in_set(labels, wanted)


@functools.lru_cache(maxsize=None)
def _grid_nx(label_max_range: float) -> int:
    """Cells per horizontal axis: labeled points lie within
    label_max_range of the sensor (labels beyond it are zeroed before
    this filter runs, reference Preprocessing.cpp:103)."""
    half = int(np.ceil((label_max_range + 2.0) / CLUSTER_TOLERANCE))
    return 2 * half


def _cell_lin(points, nx):
    """(N,) linearized 0.5 m grid cell per point + in-grid mask."""
    c = trunc_div(points[:, :3], CLUSTER_TOLERANCE)  # (N, 3)
    gx = c[:, 0] + nx // 2
    gy = c[:, 1] + nx // 2
    gz = c[:, 2] + _GRID_NZ // 2
    ok = (
        (gx >= 0) & (gx < nx) & (gy >= 0) & (gy < nx)
        & (gz >= 0) & (gz < _GRID_NZ)
    )
    lin = (gx * nx + gy) * _GRID_NZ + gz
    return jnp.where(ok, lin, 0), ok


def _sort_class(points, member, key_lin, n_keep):
    """Stable sort the scan so `member` points come first, grouped by
    grid cell; returns the leading n_keep rows' (cell, xyz, original
    position, live mask, segment head)."""
    n = points.shape[0]
    BIG = jnp.int32(2**30)
    key = jnp.where(member, key_lin, BIG)
    pos = jnp.arange(n, dtype=jnp.int32)
    k_s, pos_s, xs, ys, zs = jax.lax.sort(
        (key, pos, points[:, 0], points[:, 1], points[:, 2]),
        num_keys=1, is_stable=True,
    )
    k_s, pos_s = k_s[:n_keep], pos_s[:n_keep]
    xyz = jnp.stack([xs[:n_keep], ys[:n_keep], zs[:n_keep]], axis=1)
    live = k_s != BIG
    head = jnp.concatenate([jnp.array([True]), k_s[1:] != k_s[:-1]]) & live
    return k_s, xyz, pos_s, live, head


def radius_count(cx, cy, cz, queries, used, r2) -> jax.Array:
    """Per query slot, the number of candidates of its row within
    sqrt(r2); 0 for unused slots.

    cx/cy/cz: (R, M) f32 candidate coords (invalid lanes at >= 1e9);
    queries: (R, 3*P) f32 packed [x y z]; used: (R, P) int32.
    Returns (R, P) f32. XLA fuses the (R, P, M) compare into the count
    reduction, so the distances never reach device memory."""
    R, M = cx.shape
    q = queries.reshape(R, -1, 3)
    dx = cx[:, None, :] - q[..., 0:1]
    dy = cy[:, None, :] - q[..., 1:2]
    dz = cz[:, None, :] - q[..., 2:3]
    near = dx * dx + dy * dy + dz * dz <= r2
    return jnp.sum(near, axis=-1, dtype=jnp.float32) * used.astype(
        jnp.float32
    )


def filter_dynamic_vehicles(points, valid, config, with_stats: bool = False):
    """points: (N, 4) cropped scan; valid: (N,). Returns (points, valid')
    with moving-vehicle points masked out (+ the pass-through overflow
    count when with_stats)."""
    n = points.shape[0]
    nx = _grid_nx(float(config.label_max_range))
    G = nx * nx * _GRID_NZ
    labels = points[:, 3].astype(jnp.int32)
    vehicle_labels = tuple(config.voxel_labels[config.dynamic_vehicle_voxid])
    lin, in_grid = _cell_lin(points, nx)
    is_vehicle = valid & _label_in(labels, vehicle_labels)
    is_landmark = valid & _label_in(
        labels, tuple(config.dynamic_remove_landmark)
    )

    # ---- landmark storage: one stable sort -> (UL, K) f32 planes --------
    UL, K = _LMK_VOXEL_CAP, _LMK_PER_VOXEL
    lk, lxyz, _, llive, lhead = _sort_class(
        points, is_landmark & in_grid, lin, _LMK_PTS_CAP
    )
    m = lk.shape[0]
    posm = jnp.arange(m, dtype=jnp.int32)
    l_head_valid = lhead & llive
    lu_rank = jnp.cumsum(l_head_valid) - 1
    lu_src = jnp.where(l_head_valid & (lu_rank < UL), lu_rank, UL)
    l_head_pos = jnp.full((UL + 1,), m, jnp.int32).at[lu_src].set(
        posm, mode="drop", unique_indices=True
    )[:UL]
    # per-row segment length (for lane validity)
    l_seg_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(l_head_valid, posm, 0)
    )
    l_rank = posm - l_seg_start
    pt_u = jnp.cumsum(l_head_valid) - 1
    l_seg_idx = jnp.where(llive & (pt_u < UL), pt_u, UL)
    l_seg_len = (
        jnp.zeros((UL + 1,), jnp.int32)
        .at[l_seg_idx]
        .add(1, mode="drop", indices_are_sorted=True)[:UL]
    )
    # window rows: each row's first K points are contiguous in the sorted
    # array -> K cheap rolls + ONE wide-row gather (the fast gather class)
    rec = lxyz  # (m, 3)
    rec_win = jnp.concatenate(
        [jnp.roll(rec, -k, axis=0) for k in range(K)], axis=1
    )  # (m, 3K)
    lrow_pos = jnp.minimum(l_head_pos, m - 1)
    lrows = rec_win[lrow_pos].reshape(UL, K, 3)  # (UL, K, 3)
    kidx = jnp.arange(K, dtype=jnp.int32)
    lane_valid = (
        (l_head_pos < m)[:, None]
        & (kidx[None, :] < jnp.minimum(l_seg_len, K)[:, None])
    )
    SENT = jnp.float32(1.0e9)  # invalid lanes fail any radius test
    lrows = jnp.where(lane_valid[:, :, None], lrows, SENT)
    # +1 sentinel row for empty neighbor cells
    lplanes = jnp.concatenate(
        [lrows, jnp.full((1, K, 3), SENT)], axis=0
    )  # (UL+1, K, 3)
    # cell -> landmark row index (default UL = the sentinel row)
    l_cells = lk[lrow_pos]
    grid_l = jnp.full((G + 1,), UL, jnp.int32).at[
        jnp.where(l_head_pos < m, l_cells, G)
    ].set(jnp.arange(UL, dtype=jnp.int32), mode="drop", unique_indices=True)[
        :G
    ]

    # ---- vehicle side: one stable sort -> compacted, cell-grouped ------
    vk, vxyz, vpos, vlive, vhead = _sort_class(
        points, is_vehicle & in_grid, lin, _VEH_PTS_CAP
    )
    mv = vk.shape[0]
    posv = jnp.arange(mv, dtype=jnp.int32)
    v_head_valid = vhead & vlive

    # ---- connected components on the dense occupancy grid --------------
    # occupancy + component seed = own linear cell id; 27-connectivity
    # min-diffusion as 3x3x3 min-pooling (zero gathers, pure VPU)
    BIGC = jnp.int32(2**30)
    comp0 = jnp.full((G,), BIGC, jnp.int32).at[
        jnp.where(v_head_valid, vk, G)
    ].min(jnp.where(v_head_valid, vk, BIGC), mode="drop")
    occ3 = (comp0 != BIGC).reshape(nx, nx, _GRID_NZ)
    comp3 = comp0.reshape(nx, nx, _GRID_NZ)

    def diffuse(_, c):
        # init_value must be a CONCRETE scalar (reduce_window rejects
        # traced init values)
        pooled = jax.lax.reduce_window(
            c, np.int32(2**30), jax.lax.min, (3, 3, 3), (1, 1, 1), "SAME"
        )
        return jnp.where(occ3, jnp.minimum(c, pooled), BIGC)

    comp3 = jax.lax.fori_loop(0, _CC_ITERS, diffuse, comp3)
    comp_flat = comp3.reshape(G)

    # per-point cluster id + cluster sizes (ids are grid cells: scatter
    # into a (G+1,) accumulator)
    pcomp = jnp.where(vlive, comp_flat[jnp.minimum(vk, G - 1)], G)
    sizes = jnp.zeros((G + 1,), jnp.int32).at[
        jnp.where(vlive, pcomp, G)
    ].add(1, mode="drop")

    # ---- landmark neighbor count, deduplicated by query cell -----------
    VR, P = _VEH_ROW_CAP, _VEH_PER_ROW
    vu_rank = jnp.cumsum(v_head_valid) - 1
    v_seg_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(v_head_valid, posv, 0)
    )
    v_rank = posv - v_seg_start
    vrow = jnp.where(vlive & (vu_rank < VR), vu_rank, VR)
    vcol = jnp.minimum(v_rank, P - 1)
    in_slot = vlive & (vrow < VR) & (v_rank < P)
    # query grid by GATHER from head positions (row r's queries start at
    # head_pos[r]): P rolls of the (mv, 3) sorted coords
    vu_src = jnp.where(v_head_valid & (vu_rank < VR), vu_rank, VR)
    v_head_pos = jnp.full((VR + 1,), mv, jnp.int32).at[vu_src].set(
        posv, mode="drop", unique_indices=True
    )[:VR]
    q_win = jnp.concatenate(
        [jnp.roll(vxyz, -p_, axis=0) for p_ in range(P)], axis=1
    )  # (mv, 3P)
    vrow_pos = jnp.minimum(v_head_pos, mv - 1)
    qrows = q_win[vrow_pos]  # (VR, 3P)
    v_seg_idx = jnp.where(vlive & (vu_rank < VR), vu_rank, VR)
    v_seg_len = (
        jnp.zeros((VR + 1,), jnp.int32)
        .at[v_seg_idx]
        .add(1, mode="drop", indices_are_sorted=True)[:VR]
    )
    pidx = jnp.arange(P, dtype=jnp.int32)
    q_used = (
        (v_head_pos < mv)[:, None]
        & (pidx[None, :] < jnp.minimum(v_seg_len, P)[:, None])
    ).astype(jnp.int32)

    # 27 neighbor cells per query row -> landmark rows -> candidate planes
    row_cell = vk[vrow_pos]  # (VR,) linear cell
    gz = row_cell % _GRID_NZ
    gy = (row_cell // _GRID_NZ) % nx
    gx = row_cell // (_GRID_NZ * nx)
    from sage_icp_tpu.ops import hashmap as hm

    off = hm._NEIGHBOR_OFFSETS  # (27, 3)
    ngx = gx[:, None] + off[None, :, 0]
    ngy = gy[:, None] + off[None, :, 1]
    ngz = gz[:, None] + off[None, :, 2]
    nok = (
        (ngx >= 0) & (ngx < nx) & (ngy >= 0) & (ngy < nx)
        & (ngz >= 0) & (ngz < _GRID_NZ) & (v_head_pos < mv)[:, None]
    )
    nlin = jnp.where(nok, (ngx * nx + ngy) * _GRID_NZ + ngz, 0)
    lrow_idx = jnp.where(nok, grid_l[nlin], UL)  # (VR, 27); UL = sentinel
    cand = lplanes[lrow_idx]  # (VR, 27, K, 3) — wide-row gather
    M = 27 * K
    cand = jnp.swapaxes(cand.reshape(VR * 27, K, 3), 1, 2)  # (VR*27,3,K)
    cand = jnp.swapaxes(cand.reshape(VR, 27, 3, K), 1, 2).reshape(VR, 3, M)

    counts = radius_count(
        cand[:, 0, :], cand[:, 1, :], cand[:, 2, :], qrows, q_used,
        SEARCH_RADIUS * SEARCH_RADIUS,
    )  # (VR, P) f32

    # per sorted vehicle point -> its slot's count; slot-overflow points
    # contribute 0 to the cluster total (counted below)
    flat = counts.reshape(-1)
    n_near = jnp.where(
        in_slot,
        flat[jnp.minimum(vrow * P + vcol, VR * P - 1)].astype(jnp.int32),
        0,
    )
    lmk_total = jnp.zeros((G + 1,), jnp.int32).at[
        jnp.where(vlive, pcomp, G)
    ].add(n_near, mode="drop")

    dy_th = jnp.asarray(config.dynamic_vehicle_filter_th, points.dtype)
    static_cluster = (sizes >= MIN_CLUSTER_SIZE) & (
        lmk_total.astype(points.dtype) > dy_th * sizes.astype(points.dtype)
    )
    keep_sorted = vlive & static_cluster[jnp.minimum(pcomp, G)]

    # ---- map the verdict back to the original scan order ----------------
    keep_full = jnp.zeros((n,), bool).at[
        jnp.where(vlive, vpos, n)
    ].set(keep_sorted, mode="drop", unique_indices=True)
    clustered = jnp.zeros((n,), bool).at[
        jnp.where(vlive, vpos, n)
    ].set(True, mode="drop", unique_indices=True)
    # pass-through: vehicle points never clustered (cap overflow / out of
    # grid) — the reference clusters every vehicle point and mostly keeps
    # parked ones; silently deleting the overflow removed valid static
    # points in dense traffic. Counted so capacity pressure is visible.
    passthrough = is_vehicle & ~clustered
    new_valid = valid & (~is_vehicle | keep_full | passthrough)
    pts = jnp.where(new_valid[:, None], points, INVALID_COORD)
    # overflow = never-clustered vehicle points (cap / out-of-grid) plus
    # clustered points whose query slot overflowed P (their n_near was
    # not counted into the cluster total)
    overflow = jnp.sum(passthrough.astype(jnp.int32)) + jnp.sum(
        (vlive & ~in_slot).astype(jnp.int32)
    )
    if with_stats:
        return pts, new_valid, overflow
    return pts, new_valid
