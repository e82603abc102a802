"""Tests for the Gauss-Newton ICP core against analytic expectations and a
numpy normal-equations oracle (reference cpp/sage_icp/core/Registration.cpp)."""

import numpy as np
import jax.numpy as jnp
import pytest

from conftest import KERNEL_MODES

from sage_icp_tpu.ops import geometry as geo
from sage_icp_tpu.ops import hashmap as hm
from sage_icp_tpu.ops import registration as reg
from sage_icp_tpu.ops import routing


def np_normal_equations(src, tgt, kernel):
    """Oracle for AlignClouds accumulation (Registration.cpp:59-91)."""
    JTJ = np.zeros((6, 6))
    JTr = np.zeros(6)
    for s4, t4 in zip(src, tgt):
        s, t = s4[:3], t4[:3]
        r = s - t
        J = np.zeros((3, 6))
        J[:, :3] = np.eye(3)
        J[:, 3:] = -np.array(
            [[0, -s[2], s[1]], [s[2], 0, -s[0]], [-s[1], s[0], 0]]
        )
        w = kernel**2 / (kernel + r @ r) ** 2
        JTJ += J.T @ (w * J)
        JTr += J.T @ (w * r)
    return JTJ, JTr


def test_normal_equations_match_oracle(rng):
    n = 50
    src = rng.normal(size=(n, 4)).astype(np.float32) * 5
    tgt = src + rng.normal(size=(n, 4)).astype(np.float32) * 0.1
    kernel = 0.5
    JTJ, JTr = reg.build_normal_equations(
        jnp.asarray(src), jnp.asarray(tgt), jnp.ones(n, dtype=bool), kernel
    )
    JTJ_ref, JTr_ref = np_normal_equations(src, tgt, kernel)
    np.testing.assert_allclose(np.asarray(JTJ), JTJ_ref, rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(JTr), JTr_ref, rtol=2e-3, atol=1e-3)


def test_normal_equations_mask_zeroes_rows(rng):
    n = 20
    src = rng.normal(size=(n, 4)).astype(np.float32)
    tgt = rng.normal(size=(n, 4)).astype(np.float32)
    mask = np.zeros(n, dtype=bool)
    mask[:7] = True
    JTJ, JTr = reg.build_normal_equations(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask), 1.0
    )
    JTJ_ref, JTr_ref = np_normal_equations(src[:7], tgt[:7], 1.0)
    np.testing.assert_allclose(np.asarray(JTJ), JTJ_ref, rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(JTr), JTr_ref, rtol=2e-3, atol=1e-3)


def _make_map_and_frame(rng, n=2000):
    """A 3D structured scene (two walls + floor) so the 6-DoF problem is
    well conditioned, inserted into a map."""
    floor = np.stack(
        [
            rng.uniform(-10, 10, n),
            rng.uniform(-10, 10, n),
            np.zeros(n) + rng.normal(0, 0.01, n),
        ],
        axis=1,
    )
    wall1 = np.stack(
        [
            rng.uniform(-10, 10, n // 2),
            np.full(n // 2, 8.0) + rng.normal(0, 0.01, n // 2),
            rng.uniform(0, 5, n // 2),
        ],
        axis=1,
    )
    wall2 = np.stack(
        [
            np.full(n // 2, -9.0) + rng.normal(0, 0.01, n // 2),
            rng.uniform(-10, 10, n // 2),
            rng.uniform(0, 5, n // 2),
        ],
        axis=1,
    )
    pts = np.concatenate([floor, wall1, wall2]).astype(np.float32)
    labs = np.zeros((len(pts), 1), dtype=np.float32)
    return np.concatenate([pts, labs], axis=1)


def test_icp_recovers_known_transform(rng):
    world = _make_map_and_frame(rng)
    state = hm.create(8192, 8)
    state = hm.insert(
        state,
        jnp.asarray(world),
        jnp.ones(len(world), dtype=bool),
        1.0,
        8,
        jnp.zeros(260, dtype=bool),
    )
    # frame = world points moved by a small known SE3; ICP should undo it
    xi = np.array([0.15, -0.1, 0.05, 0.02, -0.015, 0.03], dtype=np.float32)
    T_true = np.asarray(geo.se3_exp(jnp.asarray(xi)))
    Tinv = np.asarray(geo.se3_inverse(jnp.asarray(T_true)))
    frame = world.copy()
    frame[:, :3] = frame[:, :3] @ Tinv[:3, :3].T + Tinv[:3, 3]

    result = reg.register_frame(
        state,
        jnp.asarray(frame),
        jnp.ones(len(frame), dtype=bool),
        jnp.eye(4, dtype=jnp.float32),
        1.0,
        max_correspondence_distance=1.5,
        kernel=0.5,
        sem_th=1.0,
        max_iterations=100,
    )
    got = np.asarray(result.pose)
    np.testing.assert_allclose(got, T_true, atol=5e-3)
    assert int(result.iterations) < 100


def test_icp_empty_map_returns_initial_guess(rng):
    state = hm.create(256, 4)
    frame = rng.normal(size=(64, 4)).astype(np.float32)
    guess = np.asarray(
        geo.se3_exp(jnp.asarray([1.0, 2.0, 0.5, 0.1, 0.2, 0.3], dtype=jnp.float32))
    )
    result = reg.register_frame(
        state,
        jnp.asarray(frame),
        jnp.ones(64, dtype=bool),
        jnp.asarray(guess),
        1.0,
        1.5,
        0.5,
        1.0,
    )
    np.testing.assert_allclose(np.asarray(result.pose), guess, atol=1e-5)
    assert int(result.iterations) == 1  # one zero-step then termination


@pytest.mark.parametrize("kernel_mode", KERNEL_MODES, indirect=True)
def test_fused_gn_iteration_matches_unfused(rng, kernel_mode):
    """The fully fused GN-iteration kernel (pallas_nn.fused_gn_iteration)
    must produce the same ICP solution as the corr_apply + XLA
    normal-equations body (the CPU route)."""
    world = _make_map_and_frame(rng)
    state = hm.create(8192, 8)
    state = hm.insert(
        state, jnp.asarray(world), jnp.ones(len(world), dtype=bool),
        1.0, 8, jnp.zeros(260, dtype=bool),
    )
    xi = np.array([0.12, -0.08, 0.04, 0.015, -0.01, 0.02], dtype=np.float32)
    T_true = np.asarray(geo.se3_exp(jnp.asarray(xi)))
    Tinv = np.asarray(geo.se3_inverse(jnp.asarray(T_true)))
    frame = world.copy()
    frame[:, :3] = frame[:, :3] @ Tinv[:3, :3].T + Tinv[:3, 3]
    fast = dict(unique_voxel_rows=896, queries_per_voxel=8,
                overflow_rows=128)

    def solve(mode):
        return reg.register_frame(
            state, jnp.asarray(frame), jnp.ones(len(frame), dtype=bool),
            jnp.eye(4, dtype=jnp.float32), 1.0,
            max_correspondence_distance=1.5, kernel=0.5, sem_th=0.5,
            max_iterations=60, fast_params=fast, kernel_mode=mode,
        )

    fused = solve(kernel_mode)
    unfused = solve(routing.XLA)
    np.testing.assert_allclose(
        np.asarray(fused.pose), np.asarray(unfused.pose), atol=1e-4
    )
    np.testing.assert_allclose(np.asarray(fused.pose), T_true, atol=5e-3)
    assert abs(
        int(fused.num_correspondences) - int(unfused.num_correspondences)
    ) <= max(2, int(unfused.num_correspondences) * 0.01)
