"""Long-horizon accuracy measurement: a 150-frame city drive with the
KITTI seq_error/ATE oracle (reference metrics/Metrics.cpp:140-191 math;
the reference's own verification is full-sequence replay,
eval/kitti_pub.py:471-482). Measures the committed thresholds for
tests/test_robustness.py::test_long_horizon_city_drive.

    python scripts/long_run.py [--frames 150] [--chunk 30]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from sage_icp_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()
from sage_icp_tpu.models import pipeline as pl
from sage_icp_tpu.metrics import kitti as metrics
from sage_icp_tpu.utils import synthetic


def long_city_config():
    """The robustness small_config, map capacity sized for the larger
    260 m long-run world (~52k live voxels under the 100 m cull)."""
    return pl.SageConfig(
        scan_capacity=16384, frame_capacity=16384, source_capacity=8192,
        map_capacity=131072, max_icp_iterations=500,
        dynamic_vehicle_filter=False, min_range=1.0,
        corr_unique_voxel_rows=8192, corr_overflow_rows=512,
        insert_unique_capacity=9216,
    )


def run(frames=150, chunk=30, seed=9, verbose=True):
    world = synthetic.build_city_world(seed=2, size=260.0, block=50.0,
                                       density=1.6)
    pts, labs = world
    # jitter: a perfectly constant-velocity cruise starves the adaptive
    # threshold (docs/ARCHITECTURE.md round-4 finding); curve=0 keeps the
    # 150 m drive inside the road grid
    gt = synthetic.make_trajectory(frames, step=1.0, curve=0.0, jitter=0.1,
                                   seed=11)
    rng = np.random.default_rng(seed)
    odom = pl.SageICP(long_city_config())
    t0 = time.perf_counter()
    scans = []
    for i in range(frames):
        scans.append(
            synthetic.render_scan(pts, labs, gt[i], rng, n_target=14000)
        )
    if verbose:
        print(f"rendered {frames} scans in {time.perf_counter() - t0:.0f}s")
    t0 = time.perf_counter()
    for i in range(0, frames - frames % chunk, chunk):
        odom.register_chunk(scans[i : i + chunk])
        if verbose:
            print(f"  chunk at {i} ({time.perf_counter() - t0:.0f}s)")
    for s in scans[frames - frames % chunk :]:
        odom.register_frame(s, block=False)
    est = odom.trajectory()
    if verbose:
        print(f"drove {frames} frames in {time.perf_counter() - t0:.0f}s")
    gt_rel = np.linalg.inv(gt[0])[None] @ gt
    t_err, r_err = metrics.seq_error(gt_rel, est)
    ate_rot, ate_trans = metrics.absolute_trajectory_error(gt_rel, est)
    aux = odom.aux_totals()
    out = dict(
        frames=frames,
        rel_trans_err_pct=float(t_err),
        rel_rot_err_deg_per_m=float(r_err),
        ate_trans_m=float(ate_trans),
        overflow_total=int(aux.overflow_total()),
        final_err_m=float(
            np.linalg.norm(est[-1][:3, 3] - gt_rel[-1][:3, 3])
        ),
    )
    return out, est, gt_rel


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--chunk", type=int, default=30)
    args = ap.parse_args()
    out, est, gt_rel = run(frames=args.frames, chunk=args.chunk)
    import json

    print(json.dumps(out, indent=2))
