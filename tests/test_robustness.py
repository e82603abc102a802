"""Accuracy hardening beyond the near-straight base trajectory:
turn-heavy / stop-go / reversing maneuvers, a committed golden-trajectory
regression, a production-preset (kitti capacities) smoke, the overflow
counters firing on deliberately undersized configs, and deskew reducing
ATE on motion-distorted scans.

The reference's accuracy oracle is GT trajectories + the KITTI error math
(reference metrics/Metrics.cpp:140-191); with no KITTI data in this
environment the synthetic oracle is made hard instead."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from sage_icp_tpu.models import pipeline as pl
from sage_icp_tpu.utils import synthetic

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "data", "golden_traj.npz")


def small_config(**kw):
    defaults = dict(
        scan_capacity=16384,
        frame_capacity=16384,
        source_capacity=8192,
        # the whole 160 m fixture world fits under the 100 m cull: with
        # per-frame fresh render sampling the live map approaches ALL
        # ~28.5k of its 0.8 m voxels — 65k slots keep the hash load low
        map_capacity=65536,
        max_icp_iterations=500,  # the reference budget (Registration.cpp:96)
        # — turn frames legitimately take 50-150 iterations of
        # point-to-point creep; a 100 cap left them unconverged and the
        # error compounded frame-over-frame
        dynamic_vehicle_filter=False,
        min_range=1.0,
        # row demand ~= num_source with the P=2 grid (most queries are
        # alone in their 0.8 m voxel; see SageConfig.corr_unique_voxel_rows)
        # — measured fixture maxima at density 1.6 / n_target 14000:
        # raw 14000, ds1 12003, src 5875, insert voxels 8202 (numpy
        # emulation over the maneuver trajectory)
        corr_unique_voxel_rows=8192,
        corr_overflow_rows=512,
        insert_unique_capacity=9216,  # 3 * 256 * 12: packed policy rows
    )
    defaults.update(kw)
    return pl.SageConfig(**defaults)


def drive(config, world, gt, n_target=14000, seed=3, timestamps=None):
    pts, labs = world
    rng = np.random.default_rng(seed)
    odom = pl.SageICP(config)
    for i in range(len(gt)):
        scan = synthetic.render_scan(
            pts, labs, gt[i], rng, n_target=n_target
        )
        ts = timestamps(i, scan) if timestamps is not None else None
        if isinstance(ts, tuple):
            scan, ts = ts
        odom.register_frame(scan, ts)
    return np.stack([np.asarray(p) for p in odom.poses]), odom


def ate_trans(est, gt):
    g0 = np.linalg.inv(gt[0])
    e0 = np.linalg.inv(est[0])
    err = [
        np.linalg.norm((e0 @ e)[:3, 3] - (g0 @ g)[:3, 3])
        for e, g in zip(est, gt)
    ]
    return float(np.sqrt(np.mean(np.square(err)))), err


@pytest.fixture(scope="module")
def city():
    # density 1.6: the round-4 in-domain envelope — the 0.4 m downsample
    # cells must saturate within a frame or two so map voxels are crisp
    # single-pose snapshots, not multi-frame smears (docs/ARCHITECTURE.md)
    return synthetic.build_city_world(seed=2, size=160.0, block=50.0,
                                      density=1.6)


def test_turn_stop_reverse_trajectory(city):
    """Sharp 90-degree turn, full stop, reversal: the constant-velocity
    prediction is violated at the turn and the reversal revisits culled/
    existing map territory — drift must stay bounded through all of it."""
    # 90 degrees over 15 frames = 6 deg/frame = 60 deg/s at 10 Hz — a fast
    # urban turn, ~2x the sharpest KITTI turns. (8 frames = 112 deg/s was
    # beyond any real vehicle and outside the point-to-point basin.)
    gt = synthetic.make_maneuver_trajectory(
        straight=8, turn=15, stop=3, reverse=6, step=0.75
    )
    est, odom = drive(small_config(), city, gt)
    ate, err = ate_trans(est, gt)
    assert ate < 0.30, f"maneuver ATE {ate:.3f} m, per-frame={np.round(err,3)}"
    # the stop segment must not hallucinate motion (frames 23-25 hold
    # still after straight=8 + turn=15)
    stopped = est[24:26]
    dd = np.linalg.norm(stopped[1][:3, 3] - stopped[0][:3, 3])
    assert dd < 0.10, f"moved {dd:.3f} m while stopped"


def test_geometric_preset_tracks_city(city):
    """Geometric KISS-ICP mode (single class group, semantics off —
    BASELINE.json config #1) must track on the city world. Moved from
    test_pipeline (round 5): geometric mode's 1.0 m single-group grid
    yields ~1/3 the ICP sources of semantic mode, below the corridor
    world's forward-constraint budget under the fresh-sampling renderer
    (scripts/r5_corridor_bisect.py — the semantic config tracks the same
    corridor at ATE 0.004)."""
    cfg = small_config(
        voxel_labels=(tuple(range(260)),),
        voxel_size=(1.0,),
        voxel_size_map=1.0,
        sem_th=1.0,
        label_max_range=0.0,
        basic_points_per_voxel=10,
        critical_points_per_voxel=0,
    )
    gt = synthetic.make_trajectory(8, step=1.0)
    est, odom = drive(cfg, city, gt)
    gt_rel = np.linalg.inv(gt[0]) @ gt[7]
    final_err = np.linalg.norm(est[-1][:3, 3] - gt_rel[:3, 3])
    assert final_err < 0.25, f"final drift {final_err:.3f} m"
    assert int(odom.aux_totals().overflow_total()) == 0


def test_golden_trajectory_regression():
    """Committed golden poses: perf work must not silently move the
    answer. Tolerance is loose enough for cross-platform f32 reduction
    order, tight enough to catch any semantic change (regenerate with
    scripts/make_golden.py when a deviation is INTENDED and documented)."""
    world = synthetic.build_world(seed=1, length=80.0)
    gt = synthetic.make_trajectory(12, step=1.0)
    est, _ = drive(small_config(), world, gt, seed=3)
    if not os.path.exists(GOLDEN_PATH):
        pytest.skip("golden file missing — run scripts/make_golden.py")
    golden = np.load(GOLDEN_PATH)["poses"]
    assert golden.shape == est.shape
    dt = np.linalg.norm(golden[:, :3, 3] - est[:, :3, 3], axis=-1)
    assert dt.max() < 0.02, f"drifted from golden by {dt.max():.4f} m"
    dr = np.linalg.norm(golden[:, :3, :3] - est[:, :3, :3], axis=(-2, -1))
    assert dr.max() < 0.02, f"rotation drift from golden {dr.max():.4f}"


def test_overflow_counters_fire_when_undersized(city):
    """A deliberately undersized config must make the drop counters
    nonzero (silent overflow was invisible). Two probes:
    an undersized correspondence grid (corr_dropped fires — and since
    round 4 the collapsed solve is REJECTED, so icp_rejected fires and
    the insert is skipped), and an undersized insert with a healthy
    solve (insert counters fire)."""
    gt = synthetic.make_maneuver_trajectory(straight=4, turn=0, stop=0,
                                            reverse=0)
    cfg = small_config(corr_unique_voxel_rows=64, corr_overflow_rows=32)
    est, odom = drive(cfg, city, gt)
    aux = odom.last_aux
    assert int(aux.corr_dropped) > 0
    assert int(aux.overflow_total()) > 0

    cfg2 = small_config(insert_unique_capacity=256,
                        max_incoming_per_voxel=2)
    est2, odom2 = drive(cfg2, city, gt)
    # aggregate across the drive: once the starved map collapses the
    # solve, the health guard REJECTS the frame and masks its insert —
    # the final frame then reports insert counters of an empty insert
    # (icp_rejected fires instead). The early healthy frames' overflow
    # is only visible in the totals (same aggregation the chunked step
    # applies across its window).
    aux2 = odom2.aux_totals()
    assert int(aux2.insert_unique_overflow) > 0
    assert int(aux2.overflow_total()) > 0

    # and the healthy config reports zero across the board, ALL frames
    est3, odom3 = drive(small_config(), city, gt)
    assert int(odom3.aux_totals().overflow_total()) == 0


def test_recovers_from_garbage_scan_mid_sequence(city):
    """One corrupted scan (every point lifted 25 m — a sensor glitch /
    teleport) must cost ONE frame, not the sequence: the solve-health
    guard rejects the collapsed solve, coasts on the motion model, skips
    the map insert, and the next healthy scan re-locks immediately.
    (Round-3 failure mode: the bad frame's pose fed back through the
    prediction and the map insert, compounding ~2x per frame to NaN by
    frame 30. The reference's only recovery is the manual reinit service,
    OdometryServer.cpp:259-296 — this beats it.)"""
    gt = synthetic.make_trajectory(12, step=1.0)
    pts, labs = city
    rng = np.random.default_rng(3)
    odom = pl.SageICP(small_config())
    rejected_at = []
    # inject at frame 7: past the acceleration ramp (accel_frames=6), so
    # the constant-velocity coast on the rejected frame is cm-accurate
    # (during accel the model lags by the per-frame accel ~0.17 m, which
    # tests the prediction model, not the recovery)
    bad = 7
    for i in range(len(gt)):
        scan = synthetic.render_scan(pts, labs, gt[i], rng, n_target=14000)
        if i == bad:
            scan = scan.copy()
            scan[:, 2] += 25.0  # nothing can match the map
        odom.register_frame(scan)
        a = odom.last_aux
        if int(a.icp_rejected) or int(a.nonfinite_pose):
            rejected_at.append(i)
    est = np.stack([np.asarray(p) for p in odom.poses])
    assert np.isfinite(est).all(), "poses went non-finite"
    assert rejected_at == [bad], f"guard fired at {rejected_at} != [{bad}]"
    # the garbage frame coasts on the motion model (correct to ~cm here),
    # and the frames after it must track ground truth again
    for i in range(bad + 1, len(gt)):
        err = np.linalg.norm(est[i][:3, 3] - (gt[i][:3, 3] - gt[0][:3, 3]))
        assert err < 0.25, f"frame {i} did not re-lock: err={err:.3f} m"


def test_deskew_reduces_ate_on_distorted_scans(city):
    """Render mid-pose scans, distort them with the frame's own motion
    (azimuth sweep phase), and check deskew recovers accuracy
    (reference pipeline/sageICP.cpp:38-51, core/Deskew.cpp:36-50).

    Round-5 fixture migration: this test ran on the
    corridor world through round 3, and at HEAD r4 deskew-ON looked 4.5x
    WORSE there. Root cause was the FIXTURE, not a deskew bug: at step
    1.2 / accel 4 even the UNDISTORTED corridor diverges (clean ATE 1.0+
    by frame 2, scripts/r5_deskew_probe.py) — the fresh-sampling
    renderer leaves its forward DoF under-constrained, and any per-frame
    warp error (deskew consumes ESTIMATED deltas) feeds that slip. On
    the city world the same pipeline deskew cleanly wins at 2.0 m/frame
    (72 km/h; sweep-edge distortion +-1.0 m): measured off=0.089,
    on=0.037 ATE."""
    from sage_icp_tpu.datasets.kitti import azimuth_timestamps
    from sage_icp_tpu.ops import geometry as geo

    gt = synthetic.make_trajectory(12, step=2.0, accel_frames=4)
    pts, labs = city
    rng = np.random.default_rng(5)
    scans, tss = [], []
    for i in range(len(gt)):
        scan = synthetic.render_scan(pts, labs, gt[i], rng, n_target=14000)
        nxt = gt[min(i + 1, len(gt) - 1)]
        delta = np.asarray(
            geo.se3_log(jnp.asarray(np.linalg.inv(gt[i]) @ nxt, jnp.float32))
        )
        ts = azimuth_timestamps(scan[:, :3])
        scans.append(synthetic.skew_scan(scan, delta, ts))
        tss.append(ts)

    def run(deskew):
        cfg = small_config(deskew=deskew)
        odom = pl.SageICP(cfg)
        for s, t in zip(scans, tss):
            odom.register_frame(s, t)
        return np.stack([np.asarray(p) for p in odom.poses])

    ate_off, _ = ate_trans(run(False), gt)
    ate_on, _ = ate_trans(run(True), gt)
    assert ate_on < ate_off * 0.7, (
        f"deskew did not help: on={ate_on:.3f} off={ate_off:.3f}"
    )
    assert ate_on < 0.10, f"deskewed ATE too large: {ate_on:.3f}"


@pytest.mark.slow
def test_production_kitti_preset_smoke(city):
    """Compile + step the REAL kitti preset (262k-slot map, 135k scan
    capacity) for 2 frames on CPU — catches shape/capacity regressions the
    shrunken test configs cannot."""
    cfg = pl.PRESETS["kitti"]
    gt = synthetic.make_trajectory(2, step=1.0)
    pts, labs = city
    rng = np.random.default_rng(0)
    odom = pl.SageICP(cfg)
    for i in range(2):
        scan = synthetic.render_scan(pts, labs, gt[i], rng, n_target=30000)
        odom.register_frame(scan)
    est = odom.trajectory()
    assert est.shape == (2, 4, 4)
    assert np.isfinite(est).all()
    assert int(odom.last_aux.overflow_total()) == 0


@pytest.mark.slow
@pytest.mark.skipif(
    os.environ.get("SAGE_LONGRUN") != "1",
    reason="~50 min on this 1-core CPU host; run with SAGE_LONGRUN=1. "
    "Committed reference numbers: LONGRUN_r05.json (150 frames, "
    "rel_trans 0.022%, ATE 0.022 m, overflow 0).",
)
def test_long_horizon_city_drive():
    """150-frame (~147 m) city drive against the KITTI seq_error/ATE
    oracle — the reference's own verification is full-sequence replay
    (eval/kitti_pub.py:471-482); the 12-32-frame tests cannot catch
    slow drift. Thresholds are the round-5
    measured values (LONGRUN_r05.json) x ~5 margin: loose enough for
    seed/platform noise, tight enough that a real drift regression
    (0.1 m/frame is 100x the margin) fails loudly."""
    import sys

    sys.path.insert(
        0, os.path.join(os.path.dirname(__file__), "..", "scripts")
    )
    from long_run import run

    out, est, gt_rel = run(frames=150, chunk=30, verbose=False)
    assert out["overflow_total"] == 0
    assert out["rel_trans_err_pct"] < 0.12, out
    assert out["rel_rot_err_deg_per_m"] < 0.06, out
    assert out["ate_trans_m"] < 0.12, out
    assert out["final_err_m"] < 0.4, out
