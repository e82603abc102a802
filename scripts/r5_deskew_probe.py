"""Round-5 deskew bisect: why does deskew WORSEN ATE 4.5x on the
distorted-corridor test (tests/test_robustness.py::test_deskew...)?

Variants:
  off     — distorted scans, deskew disabled (test baseline)
  on      — distorted scans, pipeline deskew (estimated delta)
  oracle  — scans host-deskewed with the TRUE per-frame delta, pipeline
            deskew OFF (isolates the op/convention from the delta
            estimator: if oracle ~= clean, the convention is right)
  clean   — undistorted scans, deskew off (domain sanity)
Per-frame error printed for each.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp

from sage_icp_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()
from sage_icp_tpu.models import pipeline as pl
from sage_icp_tpu.utils import synthetic
from sage_icp_tpu.ops import geometry as geo
from sage_icp_tpu.datasets.kitti import azimuth_timestamps


def robu_cfg(**kw):
    d = dict(
        scan_capacity=16384, frame_capacity=16384, source_capacity=8192,
        map_capacity=65536, max_icp_iterations=500,
        dynamic_vehicle_filter=False, min_range=1.0,
        corr_unique_voxel_rows=8192, corr_overflow_rows=512,
        insert_unique_capacity=9216,
    )
    d.update(kw)
    return pl.SageConfig(**d)


def build(step=1.2, accel=4, n=12, seed=5, world_kind="corridor",
          traj="straight"):
    if world_kind == "city":
        world = synthetic.build_city_world(seed=2, size=160.0, block=50.0,
                                           density=1.6)
    else:
        world = synthetic.build_world(seed=1, length=80.0)
    if traj == "turn":
        # sustained urban turn: the rotational intra-scan skew (deg/frame
        # at the sweep edges, x range) is what deskew exists for
        gt = synthetic.make_maneuver_trajectory(
            straight=4, turn=12, stop=0, reverse=0, step=0.9,
            turn_deg=90.0, start=(0.0, 0.0),
        )[:n + 1][:n]
    else:
        gt = synthetic.make_trajectory(n, step=step, accel_frames=accel)
    pts, labs = world
    rng = np.random.default_rng(seed)
    clean, scans, tss, deltas = [], [], [], []
    for i in range(n):
        scan = synthetic.render_scan(pts, labs, gt[i], rng, n_target=14000)
        nxt = gt[min(i + 1, n - 1)]
        delta = np.asarray(
            geo.se3_log(jnp.asarray(np.linalg.inv(gt[i]) @ nxt, jnp.float32))
        )
        ts = azimuth_timestamps(scan[:, :3])
        clean.append(scan)
        scans.append(synthetic.skew_scan(scan, delta, ts))
        tss.append(ts)
        deltas.append(delta)
    return gt, clean, scans, tss, deltas


def run(name, gt, scans, tss, deskew):
    cfg = robu_cfg(deskew=deskew)
    odom = pl.SageICP(cfg)
    g0 = np.linalg.inv(gt[0])
    errs = []
    for i, (s, t) in enumerate(zip(scans, tss)):
        odom.register_frame(s, t)
        est = np.asarray(odom.poses[-1])
        err = np.linalg.norm(est[:3, 3] - (g0 @ gt[i])[:3, 3])
        errs.append(err)
        a = odom.last_aux
        print(f"  [{name}] f{i:02d} err={err:7.3f} "
              f"ncorr={int(a.num_correspondences):5d} "
              f"iters={int(a.icp_iterations):3d} sig={float(a.sigma):6.3f} "
              f"rej={int(a.icp_rejected)}")
    ate = float(np.sqrt(np.mean(np.square(errs))))
    print(f"{name}: ATE={ate:.3f}")
    return ate


if __name__ == "__main__":
    args = sys.argv[1:]
    wk = "city" if "city" in args else "corridor"
    traj = "turn" if "turn" in args else "straight"
    step = 2.0 if "fast" in args else 1.2
    which = [a for a in args if a not in ("city", "turn", "fast")] or [
        "clean", "off", "oracle", "on"]
    gt, clean, scans, tss, deltas = build(world_kind=wk, traj=traj, step=step)
    if "clean" in which:
        run("clean", gt, clean, tss, deskew=False)
    if "off" in which:
        run("off", gt, scans, tss, deskew=False)
    if "oracle" in which:
        oracle = [
            synthetic.skew_scan(s, -d, t)  # undo: skew with -delta
            for s, d, t in zip(scans, deltas, tss)
        ]
        run("oracle", gt, oracle, tss, deskew=False)
    if "on" in which:
        run("on", gt, scans, tss, deskew=True)
