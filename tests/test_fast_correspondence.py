"""Equivalence: the voxel-grouped correspondence engine must match the
reference-shaped path (which is itself oracle-verified in test_hashmap)."""

import numpy as np
import jax.numpy as jnp

from sage_icp_tpu.ops import hashmap as hm
from sage_icp_tpu.ops import correspondence_fast as cf
from sage_icp_tpu.ops.scan import trunc_div

VOXEL = 1.0
K = 7


def build_map(rng, n=600, spread=12.0):
    state = hm.create(2048, K)
    xyz = rng.uniform(-spread, spread, size=(n, 3))
    lab = rng.choice([0, 40, 44, 50, 10, 80], size=n).astype(np.float64)
    pts = np.concatenate([xyz, lab[:, None]], axis=1)
    state = hm.insert(
        state,
        jnp.asarray(pts, dtype=jnp.float32),
        jnp.ones((n,), dtype=bool),
        VOXEL,
        4,
        jnp.zeros(260, dtype=bool).at[jnp.asarray([40, 44, 50])].set(True),
    )
    return state


def compare(rng, n_query=256, sem_th=0.4, max_dist=1.5, P=4, Q=512, OV=64):
    state = build_map(rng)
    q = np.concatenate(
        [
            rng.uniform(-12, 12, size=(n_query, 3)),
            rng.choice([0, 40, 50, 10], size=(n_query, 1)),
        ],
        axis=1,
    ).astype(np.float32)
    valid = np.ones(n_query, dtype=bool)
    valid[-20:] = False
    qj = jnp.asarray(q)
    vj = jnp.asarray(valid)

    tgt_ref, acc_ref = hm.get_correspondences(
        state, qj, vj, VOXEL, max_dist, sem_th, 16
    )
    center = trunc_div(jnp.zeros(3), VOXEL)
    tables = cf.build_probe_tables(state, center, 16)
    tgt_fast, acc_fast = cf.get_correspondences_fast(
        state, tables, qj, vj, VOXEL, max_dist, sem_th, 16,
        unique_voxel_rows=Q, queries_per_voxel=P, overflow_rows=OV,
    )
    return (
        np.asarray(tgt_ref), np.asarray(acc_ref),
        np.asarray(tgt_fast), np.asarray(acc_fast),
    )


def test_fast_matches_reference_path(rng):
    tgt_ref, acc_ref, tgt_fast, acc_fast = compare(rng)
    np.testing.assert_array_equal(acc_fast, acc_ref)
    np.testing.assert_allclose(tgt_fast[acc_ref], tgt_ref[acc_ref], atol=1e-4)


def test_fast_matches_with_sem_th_one(rng):
    tgt_ref, acc_ref, tgt_fast, acc_fast = compare(rng, sem_th=1.0)
    np.testing.assert_array_equal(acc_fast, acc_ref)
    np.testing.assert_allclose(tgt_fast[acc_ref], tgt_ref[acc_ref], atol=1e-4)


def test_fast_handles_overflow_rows(rng):
    # tiny P forces many queries into overflow rows; results must still match
    tgt_ref, acc_ref, tgt_fast, acc_fast = compare(rng, P=1, Q=512, OV=512)
    np.testing.assert_array_equal(acc_fast, acc_ref)
    np.testing.assert_allclose(tgt_fast[acc_ref], tgt_ref[acc_ref], atol=1e-4)


def test_fast_empty_map(rng):
    state = hm.create(512, K)
    q = jnp.asarray(rng.uniform(-5, 5, size=(64, 4)).astype(np.float32))
    tables = cf.build_probe_tables(state, jnp.zeros(3, jnp.int32), 8)
    tgt, acc = cf.get_correspondences_fast(
        state, tables, q, jnp.ones(64, dtype=bool), VOXEL, 1.5, 0.4, 8,
        unique_voxel_rows=128, queries_per_voxel=4, overflow_rows=32,
    )
    assert not np.asarray(acc).any()


def test_fast_path_supported_bounds():
    assert cf.fast_path_supported(0.8, 100.0, 100.0)
    assert not cf.fast_path_supported(0.2, 100.0, 100.0)


def test_fast_path_rejects_culled_blocks(rng):
    """remove_far must ERASE culled blocks (keys + probe visibility), not
    just zero counts: the fast path reads lane validity from the sanitized
    label plane, so a culled block with a matchable key would resurrect
    deleted map data on revisits (the reference erases the entry outright,
    VoxelHashMap.cpp:176-184). Fast and slow paths must agree after a cull."""
    state = build_map(rng, n=600, spread=12.0)
    # cull everything farther than 6 m from the origin
    state = hm.remove_far(state, jnp.zeros(3), 6.0)
    q = np.concatenate(
        [
            rng.uniform(-12, 12, size=(256, 3)),
            rng.choice([0, 40, 50, 10], size=(256, 1)),
        ],
        axis=1,
    ).astype(np.float32)
    qj = jnp.asarray(q)
    vj = jnp.ones(256, dtype=bool)
    tgt_ref, acc_ref = hm.get_correspondences(state, qj, vj, VOXEL, 1.5, 0.4, 16)
    center = trunc_div(jnp.zeros(3), VOXEL)
    tables = cf.build_probe_tables(state, center, 16)
    tgt_fast, acc_fast = cf.get_correspondences_fast(
        state, tables, qj, vj, VOXEL, 1.5, 0.4, 16,
        unique_voxel_rows=512, queries_per_voxel=4, overflow_rows=64,
    )
    acc_ref, acc_fast = np.asarray(acc_ref), np.asarray(acc_fast)
    np.testing.assert_array_equal(acc_ref, acc_fast)
    np.testing.assert_allclose(
        np.asarray(tgt_ref)[acc_ref], np.asarray(tgt_fast)[acc_fast],
        atol=1e-5,
    )
    # queries sitting squarely in culled territory must find nothing
    far = np.linalg.norm(q[:, :3], axis=1) > 6.0 + 2 * VOXEL
    assert not acc_fast[far].any(), "fast path matched culled map data"


def test_corr_setup_counts_dropped_queries(rng):
    """Row/overflow exhaustion must be counted, never silent."""
    state = build_map(rng, n=600, spread=12.0)
    q = np.concatenate(
        [
            rng.uniform(-12, 12, size=(512, 3)),
            rng.choice([0, 40], size=(512, 1)),
        ],
        axis=1,
    ).astype(np.float32)
    center = trunc_div(jnp.zeros(3), VOXEL)
    tables = cf.build_probe_tables(state, center, 16)
    # absurdly small grid: 8 rows x 1 query, 4 overflow rows
    setup = cf.corr_setup(
        state, tables, jnp.asarray(q), jnp.ones(512, dtype=bool), VOXEL, 16,
        unique_voxel_rows=8, queries_per_voxel=1, overflow_rows=4,
    )
    n_seated = int(np.asarray(setup.grid_used).sum())
    n_dropped = int(setup.n_dropped)
    assert n_dropped > 0
    assert n_seated + n_dropped == 512
