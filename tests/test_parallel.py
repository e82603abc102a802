"""Multi-chip sharding tests on the 8-device virtual CPU mesh: the sharded
step must compile, run, and agree with the single-device step."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sage_icp_tpu.models import pipeline as pl
from sage_icp_tpu.parallel import sharding as sh
from sage_icp_tpu.utils import synthetic


def tiny_config():
    return pl.SageConfig(
        scan_capacity=4096,
        frame_capacity=4096,
        source_capacity=1024,
        map_capacity=8192,
        max_icp_iterations=30,
        dynamic_vehicle_filter=False,
        min_range=1.0,
        # shrink the correspondence-engine tiles to the test scale — the
        # production defaults (4096+1024 rows x 27K candidates) dominate
        # CPU compile+run time without adding coverage
        corr_unique_voxel_rows=512,
        corr_overflow_rows=128,
        insert_unique_capacity=2048,
        max_incoming_per_voxel=16,
        probe_depth=8,
    )


def test_mesh_has_8_virtual_devices():
    assert len(jax.devices()) == 8


def test_sharded_step_matches_single_device():
    cfg = tiny_config()
    mesh = sh.make_mesh()
    pts, labs = synthetic.build_world(seed=1, length=60.0)
    gt = synthetic.make_trajectory(3, step=0.5)
    rng = np.random.default_rng(0)
    scans = [
        synthetic.render_scan(pts, labs, gt[i], rng, n_target=3000)
        for i in range(3)
    ]

    single = pl.SageICP(cfg)
    multi = sh.ShardedSageICP(cfg, mesh)
    for s in scans:
        p1 = single.register_frame(s)
        p2 = multi.register_frame(s)
    # identical math (replicated map, psum-reduced normal equations):
    # poses agree to f32 reduction-order noise
    np.testing.assert_allclose(p1, p2, atol=5e-4)


def test_sharded_capacities_are_divisible():
    cfg = tiny_config()
    mesh = sh.make_mesh(n_devices=8)
    padded = sh.pad_config_for_mesh(cfg, mesh)
    assert padded.scan_capacity % 8 == 0
    assert padded.source_capacity % 8 == 0


@pytest.mark.slow
def test_multihost_two_process_agreement(tmp_path):
    """TRUE multi-process execution (SURVEY section 4 plan): two OS
    processes, each owning 2 virtual CPU devices, rendezvous through
    jax.distributed (parallel.sharding.init_distributed) and run the
    sharded step over a 4-device mesh spanning the process boundary —
    the collectives (sort exchange, normal-equation psum, insert-policy
    all-gather) ride the gloo cross-process backend, the CPU stand-in
    for the network between hosts. Both processes must produce the same
    trajectory as the single-process 4-device mesh."""
    import subprocess
    import sys as _sys

    env = dict(**__import__("os").environ)
    env["JAX_PLATFORMS"] = "cpu"
    # the suite's conftest exports 8 virtual devices; each WORKER must
    # own exactly 2 (the worker sets its own flag only when absent)
    env.pop("XLA_FLAGS", None)
    coord = "127.0.0.1:47613"
    procs = [
        subprocess.Popen(
            [_sys.executable, "scripts/multihost_worker.py", str(p), "2",
             coord, str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for p in range(2)
    ]
    outs = [p.communicate(timeout=1500)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o[-3000:]}"
    p0 = np.load(tmp_path / "poses_0.npy")
    p1 = np.load(tmp_path / "poses_1.npy")
    # replicated outputs must agree bit-for-bit across processes
    np.testing.assert_array_equal(p0, p1)
    assert p0.shape == (3, 4, 4)
    assert np.isfinite(p0).all()
    # and with the single-process 4-device mesh (identical math modulo
    # f32 reduction order across the gloo boundary)
    cfg = tiny_config()
    mesh = sh.make_mesh(n_devices=4)
    single = sh.ShardedSageICP(cfg, mesh)
    pts, labs = synthetic.build_world(seed=1, length=60.0)
    gt = synthetic.make_trajectory(3, step=0.5)
    rng = np.random.default_rng(0)
    for i in range(3):
        single.register_frame(
            synthetic.render_scan(pts, labs, gt[i], rng, n_target=3000)
        )
    np.testing.assert_allclose(single.trajectory(), p0, atol=5e-4)


@pytest.mark.slow
def test_sharded_maneuver_equivalence():
    """Full turn/stop/reverse maneuver through ShardedSageICP on the
    8-device mesh vs the single-device step: the WHOLE trajectory must
    agree (3 straight frames on tiny shapes was the
    only sharded-correctness evidence). The maneuver exercises the
    constant-velocity violation, re-anchoring, the adaptive threshold,
    and the cull-revisit path under GSPMD + the row-sharded insert."""
    cfg = tiny_config()
    pts, labs = synthetic.build_world(seed=1, length=60.0)
    gt = synthetic.make_maneuver_trajectory(
        straight=5, turn=6, stop=2, reverse=3, step=0.5,
        start=(0.0, 0.0),
    )
    rng = np.random.default_rng(4)
    scans = [
        synthetic.render_scan(pts, labs, g, rng, n_target=3000) for g in gt
    ]
    single = pl.SageICP(cfg)
    multi = sh.ShardedSageICP(cfg, sh.make_mesh())
    for s in scans:
        single.register_frame(s)
        multi.register_frame(s)
    t1, t2 = single.trajectory(), multi.trajectory()
    # identical math modulo f32 reduction order; a maneuver-long drive
    # accumulates at most a few mm of reduction-order divergence
    d = np.linalg.norm(t1[:, :3, 3] - t2[:, :3, 3], axis=-1)
    assert d.max() < 5e-3, f"sharded trajectory diverged {d.max():.4f} m"
    # the sharded run must be healthy in its own right
    assert int(multi.aux_totals().nonfinite_pose) == 0


def test_sharded_policy_kernel_matches_single_device_loop(rng):
    """The row-sharded retention policy (the kernel under shard_map, one
    U/n-row shard per device; here in the interpreter on 4 virtual
    devices) must leave the map bit-identical to the single-device XLA
    while_loop."""
    from sage_icp_tpu.ops import hashmap as hm
    from sage_icp_tpu.ops import routing

    pts = np.concatenate([
        rng.uniform(-5.0, 5.0, (3000, 3)),
        rng.choice([0, 40, 50, 70], size=(3000, 1)),
    ], axis=1).astype(np.float32)
    args = (jnp.asarray(pts), jnp.ones(len(pts), bool), 1.0, 20,
            jnp.zeros(260, bool).at[jnp.asarray([40, 50])].set(True))
    mesh = sh.make_mesh(n_devices=4)
    a = hm.insert(hm.create(4096, 40), *args, unique_voxel_capacity=1024,
                  mesh=mesh, kernel_mode=routing.INTERPRET)
    b = hm.insert(hm.create(4096, 40), *args, unique_voxel_capacity=1024,
                  kernel_mode=routing.XLA)
    assert int(np.asarray(b.counts > 0).sum()) > 500
    for name in ("keys", "counts", "points", "first_pts"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)))
