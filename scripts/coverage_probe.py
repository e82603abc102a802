"""Per-frame MAP-COVERAGE probe around a divergence onset: for each
frame, BEFORE registering it, ask the exact host KDTree how many of the
frame's ICP sources have an in-gate nearest neighbor in the current map
at (a) the GROUND-TRUTH pose and (b) the motion-model guess — then
register and print the estimated-pose error.

If in-gate coverage at the TRUE pose dips at the onset frame, the map /
world geometry genuinely lost coverage (insert or render issue). If
coverage at gt stays high while the solve still wanders, the failure is
the solve path (guess chain / gating / basin).

Also bins the NON-covered sources by range to show WHERE coverage fails.

Env: PROBE_START/PROBE_END (default 12/26), PROBE_DENSITY (0.7),
PROBE_PRESET (city), PROBE_GATE (default = 3*sigma actual).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import dataclasses

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
from scipy.spatial import cKDTree

from sage_icp_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()
from sage_icp_tpu.models import pipeline as pl
from sage_icp_tpu.ops import hashmap as hm
from sage_icp_tpu.ops import scan as scan_ops
from sage_icp_tpu.utils import synthetic

F0 = int(os.environ.get("PROBE_START", "12"))
F1 = int(os.environ.get("PROBE_END", "26"))
cfg = dataclasses.replace(
    pl.PRESETS[os.environ.get("PROBE_PRESET", "city")],
    quantized_scan_upload=True,
)
world_pts, world_labs = synthetic.build_city_world(
    seed=0, size=420.0, density=float(os.environ.get("PROBE_DENSITY", "0.7"))
)
gt = synthetic.make_trajectory(F1 + 1, step=1.0)
rng = np.random.default_rng(0)
scans = [
    synthetic.render_scan(world_pts, world_labs, gt[i], rng,
                          n_target=120000, max_range=100.0)
    for i in range(F1 + 1)
]

odom = pl.SageICP(cfg)


def sources_of(scan):
    buf = np.full((cfg.scan_capacity, 4), scan_ops.INVALID_COORD, np.float32)
    n = min(len(scan), cfg.scan_capacity)
    buf[:n] = scan[:n, :4]
    pts = jnp.asarray(buf)
    vmask = jnp.asarray(buf[:, 0] < 1e6)
    cropped, crop_valid = scan_ops.preprocess(
        pts, vmask, cfg.max_range, cfg.min_range, cfg.label_max_range)
    (src, src_valid), _ = pl.voxelize(cropped, crop_valid, cfg)
    return np.asarray(src)[np.asarray(src_valid)]


for i in range(F1 + 1):
    if i >= F0:
        # current map as a KDTree
        map_pts, map_mask = hm.pointcloud(odom.state.map, cfg.voxel_size_map)
        mp = np.asarray(map_pts)[np.asarray(map_mask)][:, :3]
        tree = cKDTree(mp)
        src = sources_of(scans[i])
        st = odom.state
        sigma = float(np.asarray(pl._adaptive_sigma(
            st.threshold,
            jnp.asarray(int(st.num_poses) > 0),
            cfg)[0]))
        gate = float(os.environ.get("PROBE_GATE", 3.0 * sigma))
        guess = np.asarray(st.last_pose) @ (
            np.linalg.inv(np.asarray(st.prev_pose)) @ np.asarray(st.last_pose))
        gt_rel = gt[i].copy()
        gt_rel[:3, 3] -= gt[0][:3, 3]  # odometry frame starts at identity
        rows = []
        for tag, pose in (("gt", gt_rel), ("guess", guess)):
            s = src[:, :3] @ pose[:3, :3].T + pose[:3, 3]
            d, _ = tree.query(s, k=1, distance_upper_bound=gate)
            ok = np.isfinite(d)
            r = np.linalg.norm(src[:, :3], axis=1)
            miss = ~ok
            bins = [(r[miss] < 20).sum(), ((r[miss] >= 20) & (r[miss] < 50)).sum(),
                    (r[miss] >= 50).sum()]
            rows.append(f"{tag}: cov={ok.mean():.3f} miss(r<20)={bins[0]} "
                        f"miss(20-50)={bins[1]} miss(>50)={bins[2]}")
        print(f"f{i:03d} nsrc={len(src)} sigma={sigma:.3f} gate={gate:.3f} | "
              + " | ".join(rows), flush=True)
    odom.register_frame(scans[i])
    a = odom.last_aux
    t = np.asarray(odom.poses[-1])[:3, 3]
    err = np.linalg.norm(t - (gt[i][:3, 3] - gt[0][:3, 3]))
    if i >= F0:
        print(f"      -> est err={err:.3f} iters={int(a.icp_iterations)} "
              f"ncorr={int(a.num_correspondences)}", flush=True)
