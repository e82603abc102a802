"""Parity tests: device voxel hash map vs the numpy oracle that mirrors
reference cpp/sage_icp/core/VoxelHashMap.{hpp,cpp} semantics."""

import numpy as np
import jax.numpy as jnp
import pytest

from conftest import KERNEL_MODES
from sage_icp_tpu.ops import hashmap as hm
from sage_icp_tpu.ops import routing
from oracle import OracleVoxelMap

VOXEL = 1.0
BASIC = 4
CRITICAL = 3
BASIC_LABELS = [40, 44, 48, 49, 50, 70, 72]


def make_mask(labels=BASIC_LABELS, n=260):
    m = np.zeros(n, dtype=bool)
    m[labels] = True
    return jnp.asarray(m)


def mk_state(cap=1024):
    return hm.create(cap, BASIC + CRITICAL)


def insert_np(state, pts):
    n = len(pts)
    return hm.insert(
        state,
        jnp.asarray(pts, dtype=jnp.float32),
        jnp.ones((n,), dtype=bool),
        VOXEL,
        BASIC,
        make_mask(),
    )


def sorted_rows(a):
    a = np.asarray(a, dtype=np.float64).round(4)
    return a[np.lexsort(a.T)] if len(a) else a


def state_pointcloud(state):
    pts, mask = hm.pointcloud(state, VOXEL)
    return np.asarray(pts)[np.asarray(mask)]


def random_scan(rng, n, spread=8.0, labels=(0, 40, 44, 50, 10, 80, 81)):
    xyz = rng.uniform(-spread, spread, size=(n, 3))
    lab = rng.choice(labels, size=n).astype(np.float64)
    return np.concatenate([xyz, lab[:, None]], axis=1)


def test_insert_single_points_match_oracle(rng):
    pts = random_scan(rng, 200)
    state = insert_np(mk_state(), pts)
    oracle = OracleVoxelMap(VOXEL, 100.0, BASIC, CRITICAL, BASIC_LABELS)
    oracle.add_points(pts)
    got = sorted_rows(state_pointcloud(state))
    ref = sorted_rows(oracle.pointcloud())
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_retention_policy_exact_sequence():
    """Drive one voxel through the full policy state machine."""
    oracle = OracleVoxelMap(VOXEL, 100.0, BASIC, CRITICAL, BASIC_LABELS)
    state = mk_state()
    # all in voxel (0,0,0): fill basic with label-0, then exercise
    # basic-label overwrite, critical append, critical overwrite
    seq = []
    for i in range(BASIC):  # fills basic part, two label-0 among them
        lab = 0.0 if i % 2 == 0 else 40.0
        seq.append([0.1 + 0.01 * i, 0.1, 0.1, lab])
    seq.append([0.5, 0.5, 0.5, 0.0])  # label 0, count full -> drop
    seq.append([0.6, 0.6, 0.6, 44.0])  # basic label -> overwrite first 0
    for i in range(CRITICAL):  # critical appends
        seq.append([0.7, 0.7, 0.7 - 0.01 * i, 10.0])
    seq.append([0.8, 0.8, 0.8, 81.0])  # critical, full -> overwrite label-0
    seq.append([0.9, 0.9, 0.9, 81.0])  # no label-0 left -> drop
    seq = np.array(seq)
    oracle.add_points(seq)
    state = insert_np(state, seq)
    got = sorted_rows(state_pointcloud(state))
    ref = sorted_rows(oracle.pointcloud())
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_incremental_inserts_match_oracle(rng):
    state = mk_state()
    oracle = OracleVoxelMap(VOXEL, 100.0, BASIC, CRITICAL, BASIC_LABELS)
    for _ in range(4):
        pts = random_scan(rng, 150)
        state = insert_np(state, pts)
        oracle.add_points(pts)
    got = sorted_rows(state_pointcloud(state))
    ref = sorted_rows(oracle.pointcloud())
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_remove_far(rng):
    pts = random_scan(rng, 100, spread=30.0)
    state = insert_np(mk_state(), pts)
    oracle = OracleVoxelMap(VOXEL, 20.0, BASIC, CRITICAL, BASIC_LABELS)
    oracle.add_points(pts)
    origin = np.array([5.0, 0.0, 0.0], dtype=np.float32)
    state = hm.remove_far(state, jnp.asarray(origin), 20.0)
    oracle.remove_far(origin)
    got = sorted_rows(state_pointcloud(state))
    ref = sorted_rows(oracle.pointcloud())
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_slot_reuse_after_cull(rng):
    """Culled slots must be reclaimable without duplicating keys."""
    state = mk_state(cap=256)
    pts = random_scan(rng, 120, spread=10.0)
    state = insert_np(state, pts)
    state = hm.remove_far(state, jnp.zeros(3), 0.01)  # cull everything
    assert bool(hm.is_empty(state))
    # re-insert the same points: every voxel must come back exactly once
    state = insert_np(state, pts)
    oracle = OracleVoxelMap(VOXEL, 100.0, BASIC, CRITICAL, BASIC_LABELS)
    oracle.add_points(pts)
    got = sorted_rows(state_pointcloud(state))
    ref = sorted_rows(oracle.pointcloud())
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_correspondences_match_oracle(rng):
    map_pts = random_scan(rng, 300, spread=10.0)
    state = insert_np(mk_state(), map_pts)
    oracle = OracleVoxelMap(VOXEL, 100.0, BASIC, CRITICAL, BASIC_LABELS)
    oracle.add_points(map_pts)

    queries = random_scan(rng, 64, spread=10.0)
    max_dist, sem_th = 1.5, 0.4
    tgt, accept = hm.get_correspondences(
        state,
        jnp.asarray(queries, dtype=jnp.float32),
        jnp.ones((64,), dtype=bool),
        VOXEL,
        max_dist,
        sem_th,
    )
    src_ref, tgt_ref = oracle.get_correspondences(queries, max_dist, sem_th)
    acc = np.asarray(accept)
    assert acc.sum() == len(src_ref)
    got_pairs = np.concatenate([queries[acc], np.asarray(tgt)[acc]], axis=1)
    ref_pairs = np.concatenate([src_ref, tgt_ref], axis=1)
    np.testing.assert_allclose(
        sorted_rows(got_pairs), sorted_rows(ref_pairs), atol=1e-3
    )


def test_correspondences_semantic_weighting_changes_winner():
    """A same-label farther point must beat a different-label closer point
    when sem_th shrinks the weighted distance (VoxelHashMap.cpp:88)."""
    state = mk_state()
    pts = np.array(
        [
            [0.30, 0.5, 0.5, 10.0],  # different label, closer to query
            [0.70, 0.5, 0.5, 40.0],  # same label, farther
        ]
    )
    state = insert_np(state, pts)
    q = np.array([[0.45, 0.5, 0.5, 40.0]], dtype=np.float32)
    tgt, accept = hm.get_correspondences(
        state, jnp.asarray(q), jnp.ones((1,), dtype=bool), VOXEL, 2.0, 0.1
    )
    assert bool(accept[0])
    # weighted: same-label 0.25^2*0.1 = 0.00625 < diff-label 0.15^2 = 0.0225
    assert abs(float(tgt[0, 0]) - 0.70) < 1e-4  # int16-quantized storage

    # with sem_th = 1 the truly closest wins
    tgt2, _ = hm.get_correspondences(
        state, jnp.asarray(q), jnp.ones((1,), dtype=bool), VOXEL, 2.0, 1.0
    )
    assert abs(float(tgt2[0, 0]) - 0.30) < 1e-4


def test_correspondence_acceptance_uses_unweighted_distance():
    """Weighted distance < gate < true distance must be REJECTED
    (VoxelHashMap.cpp:111 uses the unweighted norm)."""
    state = mk_state()
    pts = np.array([[1.0, 0.5, 0.5, 40.0]])
    state = insert_np(state, pts)
    q = np.array([[0.2, 0.5, 0.5, 40.0]], dtype=np.float32)  # dist 0.8
    # weighted d2 = 0.64*0.01 = 0.0064 (sqrt = 0.08 < 0.5 gate)
    _, accept = hm.get_correspondences(
        state, jnp.asarray(q), jnp.ones((1,), dtype=bool), VOXEL, 0.5, 0.01
    )
    assert not bool(accept[0])


def test_negative_coords_truncation():
    """static_cast<int> truncates toward zero: -0.4/1.0 -> voxel 0, not -1."""
    state = mk_state()
    pts = np.array([[-0.4, -0.4, -0.4, 40.0], [0.4, 0.4, 0.4, 50.0]])
    state = insert_np(state, pts)
    # both truncate to voxel (0,0,0) -> one block with two points
    assert int(np.asarray(state.counts).sum()) == 2
    live = np.asarray(state.counts) > 0
    assert live.sum() == 1


@pytest.mark.parametrize("kernel_mode", KERNEL_MODES, indirect=True)
@pytest.mark.parametrize(
    "kmax,ucap,n_pts,spread,basic",
    [
        # spread 2.5 -> at most 6^3 = 216 distinct voxels < the 256-row
        # capacity, so the oracle comparison sees no capacity-drop effects
        (BASIC + CRITICAL, 256, 640, 2.5, BASIC),
        # the PRODUCTION block size K=40 (not a power of two: the kernel
        # masks a 64-lane tile) over 768 rows of 32-row blocks
        (40, 768, 4000, 6.0, 20),
    ],
    ids=["k8", "k40"],
)
def test_policy_kernel_matches_xla_loop(rng, kernel_mode, kmax, ucap,
                                        n_pts, spread, basic):
    """The retention-policy kernel (ops/pallas_insert.py) must be
    state-identical to the reference-shaped lax.while_loop path (the CPU
    route), bit for bit."""
    pts = random_scan(rng, n_pts, spread=spread)
    n = len(pts)
    args = (
        jnp.asarray(pts, dtype=jnp.float32),
        jnp.ones((n,), dtype=bool),
        VOXEL,
        basic,
        make_mask(),
    )
    a = hm.insert(hm.create(2048, kmax), *args, unique_voxel_capacity=ucap,
                  kernel_mode=kernel_mode)
    b = hm.insert(hm.create(2048, kmax), *args, unique_voxel_capacity=ucap,
                  kernel_mode=routing.XLA)
    np.testing.assert_array_equal(np.asarray(a.counts), np.asarray(b.counts))
    np.testing.assert_array_equal(np.asarray(a.points), np.asarray(b.points))
    np.testing.assert_array_equal(np.asarray(a.keys), np.asarray(b.keys))
    np.testing.assert_array_equal(
        np.asarray(a.first_pts), np.asarray(b.first_pts)
    )
    if kmax == BASIC + CRITICAL:
        # and the kernel path still matches the oracle end to end
        oracle = OracleVoxelMap(VOXEL, 100.0, BASIC, CRITICAL, BASIC_LABELS)
        oracle.add_points(pts)
        np.testing.assert_allclose(
            sorted_rows(state_pointcloud(a)),
            sorted_rows(oracle.pointcloud()), atol=1e-3,
        )


def test_dense_grid_matches_window_lookup(rng):
    """grid_probe must agree with the D-probe hash lookup through insert,
    cull, slot reuse, and voxel revisit (the stale-entry edge cases)."""
    st = hm.create(256, BASIC + CRITICAL, dense_grid=True)

    def check(state, keys):
        f, s = hm.grid_probe(state, jnp.asarray(keys, jnp.int32))
        f, s = np.asarray(f), np.asarray(s)
        cnts = np.asarray(state.counts)
        ref = np.asarray(hm.lookup(state, jnp.asarray(keys, jnp.int32)))
        live = (ref >= 0) & (cnts[np.maximum(ref, 0)] > 0)
        got_live = f & (cnts[s] > 0)
        np.testing.assert_array_equal(got_live, live)
        # where both live, slots must agree
        np.testing.assert_array_equal(s[live], ref[live])
        # sanitized storage: lanes at/beyond count carry label -1, so a
        # found block exposes exactly `count` valid lanes
        if live.any():
            labs = np.asarray(state.points)[s[live], 3, :]
            assert ((labs != -1).sum(axis=1) == cnts[s[live]]).all()

    def ins(state, pts):
        p = np.asarray(pts, dtype=np.float32)
        return hm.insert(
            state, jnp.asarray(p), jnp.ones(len(p), bool), VOXEL, BASIC,
            make_mask(), unique_voxel_capacity=128, kernel_mode=routing.XLA,
        )

    # fill a near region
    near = random_scan(rng, 120, spread=4.0)
    st = ins(st, near)
    probes = trunc = np.unique(
        np.trunc(near[:, :3] / VOXEL).astype(np.int32), axis=0
    )
    check(st, probes)
    # cull everything far from a new origin -> stale grid entries
    st = hm.remove_far(st, jnp.asarray([100.0, 0.0, 0.0]), 20.0)
    check(st, probes)  # culled: live lookups must say empty
    # insert a far region: claims reuse culled slots
    far = random_scan(rng, 120, spread=4.0)
    far[:, 0] += 100.0
    st = ins(st, far)
    fprobes = np.unique(
        np.trunc(far[:, :3] / VOXEL).astype(np.int32), axis=0
    )
    check(st, fprobes)
    check(st, probes)  # old voxels: no ghost hits through reused slots
    # revisit the original region (loop closure)
    st = hm.remove_far(st, jnp.asarray([0.0, 0.0, 0.0]), 20.0)
    st = ins(st, near)
    check(st, probes)
    check(st, fprobes)


def test_remove_far_erases_keys(rng):
    """Culled blocks must be unfindable by every probe path (keys erased,
    first_pts reset) — see ops/hashmap.remove_far."""
    pts = random_scan(rng, 500, spread=10.0)
    state = insert_np(mk_state(), pts)
    culled = hm.remove_far(state, jnp.zeros(3), 4.0)
    killed = (np.asarray(state.counts) > 0) & (np.asarray(culled.counts) == 0)
    assert killed.any()
    assert (np.asarray(culled.keys)[killed] == hm.EMPTY_KEY).all()
    # lookup can no longer find the culled voxels
    kk = jnp.asarray(np.asarray(state.keys)[killed])
    slots = hm.lookup(culled, kk)
    assert (np.asarray(slots) == -1).all()
