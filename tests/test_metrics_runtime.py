"""Tests for KITTI metrics, keyframe extraction, dataset loaders, and the
dynamic-vehicle filter."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from sage_icp_tpu.metrics import kitti as metrics
from sage_icp_tpu.runtime import keyframes as kf
from sage_icp_tpu.datasets import kitti as kitti_ds
from sage_icp_tpu.utils import synthetic


def make_traj(n, step=1.5, yaw_rate=0.002, noise=0.0, rng=None):
    poses = []
    x = y = yaw = 0.0
    for i in range(n):
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        T[0, 3], T[1, 3] = x, y
        if noise and rng is not None:
            T[:3, 3] += rng.normal(0, noise, 3)
        poses.append(T)
        x += step * np.cos(yaw)
        y += step * np.sin(yaw)
        yaw += yaw_rate
    return np.stack(poses)


def test_seq_error_zero_for_identical():
    gt = make_traj(900)
    t_err, r_err = metrics.seq_error(gt, gt.copy())
    assert t_err == pytest.approx(0.0, abs=1e-9)
    assert r_err == pytest.approx(0.0, abs=1e-9)


def test_seq_error_scales_with_noise(rng):
    gt = make_traj(900)
    est = make_traj(900, noise=0.05, rng=rng)
    t_err, _ = metrics.seq_error(gt, est)
    assert 0.0 < t_err < 1.0  # 5 cm noise over >=100 m segments


def test_seq_error_nan_when_too_short():
    gt = make_traj(10)  # < 100 m of travel
    t_err, r_err = metrics.seq_error(gt, gt)
    assert np.isnan(t_err)


def test_ate_invariant_to_rigid_offset(rng):
    gt = make_traj(200)
    # move the whole estimate by a rigid transform: ATE must be ~0
    # (Umeyama alignment removes it, reference Metrics.cpp:169)
    off = np.eye(4)
    c, s = np.cos(0.7), np.sin(0.7)
    off[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    off[:3, 3] = [5.0, -3.0, 1.0]
    est = off[None] @ gt
    ate_rot, ate_trans = metrics.absolute_trajectory_error(gt, est)
    assert ate_trans < 1e-6
    # rotational residual: every frame differs from gt by the constant
    # rotation (alignment only fixes translation RMSE optimally)
    assert ate_rot >= 0.0


def test_ate_measures_noise(rng):
    gt = make_traj(200)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.1, (200, 3))
    _, ate_trans = metrics.absolute_trajectory_error(gt, est)
    assert 0.05 < ate_trans < 0.2


# ---------------- keyframes ----------------


def test_occupancy_grid_basic():
    pts = np.array([[0.0, 0.0, 0.0, 0.0], [10.0, 10.0, 1.0, 0.0]])
    g = kf.points_to_grid(pts)
    assert g.sum() == 2
    # out-of-bounds z is dropped
    pts_far = np.array([[0.0, 0.0, 100.0, 0.0]])
    assert kf.points_to_grid(pts_far).sum() == 0


def test_occ_overlap():
    a = np.zeros((4, 4), dtype=np.int8)
    b = np.zeros((4, 4), dtype=np.int8)
    a[0, :2] = 1
    b[0, :1] = 1
    assert kf.occ_overlap(a, b) == pytest.approx(0.5)


def test_keyframe_extractor_triggers_on_motion(rng):
    ex = kf.KeyframeExtractor(overlap_threshold=0.5)
    pts, labs = synthetic.build_world(seed=2, length=150.0)
    gt = synthetic.make_trajectory(2, step=5.0, accel_frames=1)
    scans = [
        synthetic.render_scan(pts, labs, gt[i], rng, n_target=4000)
        for i in range(2)
    ]
    assert ex.update(scans[0], gt[0]) is True  # first frame is a keyframe
    # same place, small motion: high overlap -> no new keyframe
    assert ex.update(scans[1], gt[1]) is False
    # a 90-degree turn: grid rotates, overlap collapses -> new keyframe
    rot = gt[1].copy()
    c, s = 0.0, 1.0
    rot[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ rot[:3, :3]
    assert ex.update(scans[1], rot) is True


# ---------------- dataset loaders ----------------


def test_kitti_scan_correction_preserves_range(rng):
    xyz = rng.normal(size=(100, 3)) * 20
    out = kitti_ds.correct_kitti_scan(xyz)
    np.testing.assert_allclose(
        np.linalg.norm(out, axis=1), np.linalg.norm(xyz, axis=1), rtol=1e-5
    )
    # rotation angle per point is exactly 0.205 deg
    cosang = np.sum(out * xyz, axis=1) / (
        np.linalg.norm(out, axis=1) * np.linalg.norm(xyz, axis=1)
    )
    ang = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
    # arccos conditioning near 1.0 amplifies f32 rounding; 0.005 deg slack
    np.testing.assert_allclose(ang, 0.205, atol=5e-3)


def test_kitti_reader_roundtrip(tmp_path, rng):
    # synthesize a mini KITTI sequence on disk
    seq_dir = tmp_path / "sequences" / "00"
    (seq_dir / "velodyne").mkdir(parents=True)
    (seq_dir / "labels").mkdir()
    n = 50
    for i in range(2):
        scan = rng.normal(size=(n, 4)).astype(np.float32)
        scan.tofile(seq_dir / "velodyne" / f"{i:06d}.bin")
        lab = (rng.choice([10, 40, 50], size=n).astype(np.int32)
               | (7 << 16))  # instance id in the high bits must be masked
        lab.tofile(seq_dir / "labels" / f"{i:06d}.label")
    (seq_dir / "times.txt").write_text("0.0\n0.1\n")
    (seq_dir / "calib.txt").write_text(
        "Tr: 1 0 0 0 0 1 0 0 0 0 1 0\n"
    )
    (seq_dir / "00.txt").write_text(
        "1 0 0 0 0 1 0 0 0 0 1 0\n1 0 0 1 0 1 0 0 0 0 1 0\n"
    )
    ds = kitti_ds.KittiOdometrySequence(str(tmp_path), 0,
                                        apply_scan_correction=False)
    assert len(ds) == 2
    scan = ds.read_scan(0)
    assert scan.shape == (n, 4)
    assert set(np.unique(scan[:, 3])).issubset({10.0, 40.0, 50.0})
    assert ds.timestamps[0] == 0.0001  # 0.0 -> 0.0001 substitution
    assert ds.gt_poses.shape == (2, 4, 4)
    np.testing.assert_allclose(ds.gt_poses[1][0, 3], 1.0)


# ---------------- dynamic vehicle filter ----------------


def test_dynamic_filter_removes_moving_keeps_parked(rng):
    from sage_icp_tpu.models.pipeline import SageConfig
    from sage_icp_tpu.ops import dynamic_filter as dyn

    cfg = SageConfig()
    # parked car: CAR points sitting on a dense PARKING-labeled patch
    n_car, n_park = 80, 800
    parked = np.stack(
        [
            rng.uniform(10, 13, n_car),
            rng.uniform(4.2, 5.8, n_car),
            rng.uniform(0.1, 0.4, n_car),  # low — near the ground plane
            np.full(n_car, 10.0),
        ],
        axis=1,
    )
    parking_lot = np.stack(
        [
            rng.uniform(9, 14, n_park),
            rng.uniform(3.8, 6.2, n_park),
            rng.uniform(-0.05, 0.25, n_park),
            np.full(n_park, 44.0),
        ],
        axis=1,
    )
    # moving car: CAR points in the middle of the road, no landmarks nearby
    moving = np.stack(
        [
            rng.uniform(30, 33, n_car),
            rng.uniform(-1, 1, n_car),
            rng.uniform(0.3, 1.4, n_car),
            np.full(n_car, 10.0),
        ],
        axis=1,
    )
    road = np.stack(
        [
            rng.uniform(25, 40, n_park),
            rng.uniform(-4, 4, n_park),
            rng.uniform(-0.05, 0.05, n_park),
            np.full(n_park, 40.0),  # ROAD is not a landmark label
        ],
        axis=1,
    )
    pts = np.concatenate([parked, parking_lot, moving, road]).astype(np.float32)
    valid = np.ones(len(pts), dtype=bool)
    out_pts, out_valid = dyn.filter_dynamic_vehicles(
        jnp.asarray(pts), jnp.asarray(valid), cfg
    )
    ov = np.asarray(out_valid)
    labs = pts[:, 3].astype(int)
    xs = pts[:, 0]
    parked_kept = ov[(labs == 10) & (xs < 20)].mean()
    moving_kept = ov[(labs == 10) & (xs > 20)].mean()
    assert parked_kept > 0.9, f"parked car wrongly removed ({parked_kept})"
    assert moving_kept < 0.1, f"moving car wrongly kept ({moving_kept})"
    # non-vehicle points untouched
    assert ov[labs != 10].all()


def test_kitti_raw_reader_roundtrip(tmp_path, rng):
    # synthesize a mini raw drive on disk
    from sage_icp_tpu.datasets import kitti_raw

    drive_dir = tmp_path / "2011_09_26" / "2011_09_26_drive_0001_sync"
    (drive_dir / "velodyne_points" / "data").mkdir(parents=True)
    (drive_dir / "oxts" / "data").mkdir(parents=True)
    n = 40
    for i in range(3):
        scan = rng.normal(size=(n, 4)).astype(np.float32)
        scan.tofile(drive_dir / "velodyne_points" / "data" / f"{i:010d}.bin")
        # lat lon alt roll pitch yaw + filler fields
        rec = f"49.0 {8.43 + i * 1e-5} 112.8 0.0 0.0 0.1" + " 0.0" * 24
        (drive_dir / "oxts" / "data" / f"{i:010d}.txt").write_text(rec)
    ds = kitti_raw.KittiRawSequence(
        str(tmp_path), "2011_09_26", "0001", apply_scan_correction=False
    )
    assert len(ds) == 3
    scan = ds.read_scan(0)
    assert scan.shape == (n, 4)
    assert np.all(scan[:, 3] == 0.0)  # labels come from an external network
    assert ds.gt_poses.shape == (3, 4, 4)
    # first pose re-based to identity; eastward motion increases with lon
    np.testing.assert_allclose(ds.gt_poses[0], np.eye(4), atol=1e-9)
    assert ds.gt_poses[2][0, 3] != 0.0 or ds.gt_poses[2][1, 3] != 0.0
    assert np.linalg.norm(ds.gt_poses[2][:3, 3]) > np.linalg.norm(
        ds.gt_poses[1][:3, 3]
    )
    assert kitti_raw.discover_drives(str(tmp_path)) == [("2011_09_26", "0001")]


def test_estimate_icp_times_regression_recovers_marginal_cost():
    """The t_icp fallback is a per-run regression (no calibration
    constants): t_all = a + b*iters must recover b and
    report t_icp = b*iters, clipped into [0, t_all]."""
    from sage_icp_tpu.runtime.runner import estimate_icp_times

    rng = np.random.default_rng(0)
    iters = rng.integers(3, 40, size=30)
    a, b = 0.012, 0.0007
    tt = a + b * iters + rng.normal(0, 1e-5, size=30)
    est = estimate_icp_times(list(iters), list(tt))
    # skip the compile frames the estimator drops
    err = np.abs(np.asarray(est[2:]) - b * iters[2:])
    assert err.max() < 5e-4, f"regressed t_icp off by {err.max():.2e}"
    # degenerate run (constant iteration count): honest "n/a" (None),
    # not a fabricated number
    est0 = estimate_icp_times([7] * 10, [0.02] * 10)
    assert est0 == [None] * 10


def test_icp_timer_measures_positive_platform_time():
    """IcpTimer replays the solve as its own clocked dispatch — the
    reference's std::chrono span (sageICP.cpp:79-88)."""
    import dataclasses

    from sage_icp_tpu.models import pipeline as pl
    from sage_icp_tpu.runtime.runner import IcpTimer

    cfg = pl.SageConfig(
        scan_capacity=4096, frame_capacity=4096, source_capacity=1024,
        map_capacity=8192, max_icp_iterations=20,
        dynamic_vehicle_filter=False, min_range=1.0,
        corr_unique_voxel_rows=512, corr_overflow_rows=128,
        insert_unique_capacity=1024,
    )
    pts, labs = synthetic.build_world(seed=1, length=40.0)
    gt = synthetic.make_trajectory(3)
    rng = np.random.default_rng(0)
    odom = pl.SageICP(cfg)
    timer = IcpTimer(cfg)
    ts = []
    for i in range(3):
        scan = synthetic.render_scan(pts, labs, gt[i], rng, n_target=2500)
        ts.append(timer.measure(odom.state, scan))
        odom.register_frame(scan)
    assert all(t > 0 for t in ts)
    # the timed replay must not perturb the real trajectory
    assert np.isfinite(odom.trajectory()).all()


def test_label_directory_adapter(tmp_path):
    """Offline model-label ingestion (SURVEY L5): .label (semantic-KITTI
    packed int32) and .npy files pair with scans by sorted order and
    replace the scan's label lane; length mismatches pad with label 0 and
    are counted, not silently corrupted (reference consumes network labels
    via /sem_points, README.md:30-31 — this is the offline analog)."""
    from sage_icp_tpu.datasets.labels import LabelDirectory

    d = tmp_path / "labs"
    d.mkdir()
    # frame 0: .label with instance bits set in the upper 16 (must strip)
    packed = (np.arange(5, dtype=np.int32) + 40) | (7 << 16)
    packed.tofile(d / "000000.label")
    # frame 1: .npy, deliberately SHORT (3 labels for a 5-point scan)
    np.save(d / "000001.npy", np.full(3, 50, dtype=np.int64))
    ld = LabelDirectory(str(d))
    assert len(ld) == 2

    scan = np.concatenate(
        [np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32),
         np.full((5, 1), 99.0, np.float32)], axis=1,
    )
    s0 = ld.apply(0, scan)
    np.testing.assert_array_equal(s0[:, 3], [40, 41, 42, 43, 44])
    assert ld.mismatched_frames == 0
    s1 = ld.apply(1, scan)
    np.testing.assert_array_equal(s1[:, 3], [50, 50, 50, 0, 0])
    assert ld.mismatched_frames == 1
    # past the directory end: all-0 labels, counted
    s2 = ld.apply(2, scan)
    assert (s2[:, 3] == 0).all() and ld.mismatched_frames == 2
    # xyz lanes untouched
    np.testing.assert_array_equal(s1[:, :3], scan[:, :3])
    # wrap() pairs an iterable of scans in order
    wrapped = list(LabelDirectory(str(d)).wrap([scan, scan]))
    np.testing.assert_array_equal(wrapped[0][:, 3], s0[:, 3])
    np.testing.assert_array_equal(wrapped[1][:, 3], s1[:, 3])


def test_label_directory_over_raw_reader(tmp_path, rng):
    """End-to-end reader+adapter integration (the CLI's --labels-dir
    path): a raw drive that emits label-0 scans gains model-produced
    semantics when wrapped by a LabelDirectory — the offline equivalent
    of running the reference's sem_odom launch (network labels) instead
    of the _gt variant."""
    from sage_icp_tpu.datasets import kitti_raw
    from sage_icp_tpu.datasets.labels import LabelDirectory

    drive_dir = tmp_path / "2011_09_26" / "2011_09_26_drive_0002_sync"
    (drive_dir / "velodyne_points" / "data").mkdir(parents=True)
    (drive_dir / "oxts" / "data").mkdir(parents=True)
    labs_dir = tmp_path / "model_labels"
    labs_dir.mkdir()
    n = 32
    for i in range(2):
        scan = rng.normal(size=(n, 4)).astype(np.float32)
        scan.tofile(drive_dir / "velodyne_points" / "data" / f"{i:010d}.bin")
        rec = "49.0 8.43 112.8 0.0 0.0 0.1" + " 0.0" * 24
        (drive_dir / "oxts" / "data" / f"{i:010d}.txt").write_text(rec)
        np.save(labs_dir / f"{i:010d}.npy",
                np.full(n, 40 + i, dtype=np.int32))
    ds = kitti_raw.KittiRawSequence(
        str(tmp_path), "2011_09_26", "0002", apply_scan_correction=False
    )
    ld = LabelDirectory(str(labs_dir))
    wrapped = list(ld.wrap(iter(ds)))
    assert len(wrapped) == 2
    assert np.all(wrapped[0][:, 3] == 40.0)
    assert np.all(wrapped[1][:, 3] == 41.0)
    assert ld.mismatched_frames == 0
    # xyz untouched
    np.testing.assert_array_equal(wrapped[0][:, :3], ds.read_scan(0)[:, :3])
