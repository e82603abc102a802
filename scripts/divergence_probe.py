"""Anatomy of the f020-f021 city-world divergence: rebuild the exact
bench state at frame F, then run the GN solve ITERATION BY ITERATION on
the host with full diagnostics — per-iteration pose increment, JTJ
eigenvalue spectrum (degenerate directions), residual statistics, and an
exact-KDTree NN cross-check against the device search.

Env: PROBE_FRAME (default 20), PROBE_DENSITY (0.7), PROBE_PRESET (city),
PROBE_SIGMA (override sigma; default = pipeline's adaptive value),
PROBE_ITERS (default 120).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import dataclasses

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from sage_icp_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()
from sage_icp_tpu.models import pipeline as pl
from sage_icp_tpu.ops import geometry as geo
from sage_icp_tpu.ops import hashmap as hm
from sage_icp_tpu.ops import scan as scan_ops
from sage_icp_tpu.utils import synthetic

F = int(os.environ.get("PROBE_FRAME", "20"))
cfg = dataclasses.replace(
    pl.PRESETS[os.environ.get("PROBE_PRESET", "city")],
    quantized_scan_upload=True,
)
world_pts, world_labs = synthetic.build_city_world(
    seed=0, size=420.0, density=float(os.environ.get("PROBE_DENSITY", "0.7"))
)
gt = synthetic.make_trajectory(F + 1, step=1.0)
rng = np.random.default_rng(0)
scans = [
    synthetic.render_scan(world_pts, world_labs, gt[i], rng,
                          n_target=120000, max_range=100.0)
    for i in range(F + 1)
]

odom = pl.SageICP(cfg)
for i in range(F):
    odom.register_frame(scans[i])
tr = odom.trajectory()
print(f"state rebuilt: f{F-1} t={np.round(tr[-1][:3,3],3)} "
      f"gt={np.round(gt[F-1][:3,3],3)}")

# --- extract everything to host ------------------------------------------
st = odom.state
map_pts, map_mask = hm.pointcloud(st.map, cfg.voxel_size_map)
map_pts = np.asarray(map_pts)[np.asarray(map_mask)]
print(f"map: {len(map_pts)} pts, {int(np.asarray((st.map.counts>0).sum()))} voxels")

# source points for frame F via the pipeline's own preprocessing
buf = np.full((cfg.scan_capacity, 4), scan_ops.INVALID_COORD, np.float32)
n = min(len(scans[F]), cfg.scan_capacity)
buf[:n] = scans[F][:n, :4]
pts = jnp.asarray(buf)
valid = jnp.asarray(buf[:, 0] < 1e6)
cropped, crop_valid = scan_ops.preprocess(
    pts, valid, cfg.max_range, cfg.min_range, cfg.label_max_range)
(source, source_valid), _ = pl.voxelize(cropped, crop_valid, cfg)
src = np.asarray(source)[np.asarray(source_valid)]
print(f"frame {F}: {len(src)} sources")

# pipeline's sigma at this frame
motion = np.linalg.norm(
    (np.linalg.inv(np.asarray(st.first_pose)) @ np.asarray(st.last_pose))[:3, 3])
has_moved = int(st.num_poses) > 0 and motion > 5.0 * cfg.min_motion_th
sigma, _ = pl._adaptive_sigma(st.threshold, jnp.asarray(has_moved), cfg)
sigma = float(np.asarray(sigma))
if "PROBE_SIGMA" in os.environ:
    sigma = float(os.environ["PROBE_SIGMA"])
gate, kernel = 3.0 * sigma, sigma / 3.0
print(f"sigma={sigma:.4f} gate={gate:.3f} kernel={kernel:.4f}")

prediction = np.linalg.inv(np.asarray(st.prev_pose)) @ np.asarray(st.last_pose)
guess = np.asarray(st.last_pose) @ prediction
print(f"initial guess t={np.round(guess[:3,3],3)} gt t={np.round(gt[F][:3,3],3)}")

# --- host-side exact-NN GN loop -------------------------------------------
from scipy.spatial import cKDTree

tree = cKDTree(map_pts[:, :3])
map_lab = map_pts[:, 3].astype(np.int32)
sem_th = cfg.sem_th


def hat(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def se3_exp(x):
    return np.asarray(geo.se3_exp(jnp.asarray(x, jnp.float32)))


pose = guess.copy()
src_l = src[:, 3].astype(np.int32)
n_iters = int(os.environ.get("PROBE_ITERS", "120"))
for it in range(n_iters):
    s = src[:, :3] @ pose[:3, :3].T + pose[:3, 3]
    # exact semantic NN: query k nearest, apply semantic weighting to d2
    d, idx = tree.query(s, k=8, distance_upper_bound=gate)
    ok = np.isfinite(d)
    idxc = np.where(ok, idx, 0)
    same = (map_lab[idxc] == src_l[:, None]) | (
        map_lab[idxc] * src_l[:, None] == 0)
    d2w = np.where(ok, d * d * np.where(same, sem_th, 1.0), np.inf)
    best = np.argmin(d2w, axis=1)
    bidx = idxc[np.arange(len(s)), best]
    bd = d[np.arange(len(s)), best]
    accept = np.isfinite(bd) & (bd < gate)
    tgt = map_pts[bidx, :3]
    r = s - tgt
    r2 = np.sum(r * r, axis=1)
    w = np.where(accept, kernel**2 / (kernel + r2) ** 2, 0.0)
    J = np.zeros((len(s), 3, 6))
    J[:, :, :3] = np.eye(3)
    for i3 in range(3):
        pass
    J[:, 0, 4], J[:, 0, 5] = s[:, 2], -s[:, 1]
    J[:, 1, 3], J[:, 1, 5] = -s[:, 2], s[:, 0]
    J[:, 2, 3], J[:, 2, 4] = s[:, 1], -s[:, 0]
    Jf = J.reshape(-1, 6)
    Wf = np.repeat(w, 3)
    JTJ = Jf.T @ (Jf * Wf[:, None])
    JTr = Jf.T @ (r.reshape(-1) * Wf)
    x = np.linalg.solve(JTJ + 1e-8 * np.eye(6), -JTr)
    pose = se3_exp(x) @ pose
    if it < 12 or it % 10 == 0 or np.linalg.norm(x) < 1e-4:
        ev = np.linalg.eigvalsh(JTJ / max(accept.sum(), 1))
        terr = pose[:3, 3] - gt[F][:3, 3]
        terr[2] += 1.8  # sensor height offset (odometry frame starts at 0)
        print(
            f"it{it:3d} |x|={np.linalg.norm(x):.2e} nacc={accept.sum()} "
            f"terr={np.round(terr,3)} med_r={np.median(np.sqrt(r2[accept])):.3f} "
            f"ev={np.array2string(ev, formatter={'float': lambda v: f'{v:.2e}'})} "
            f"dx={np.round(x,4)}"
        )
    if np.linalg.norm(x) < 1e-4:
        break
terr = pose[:3, 3] - gt[F][:3, 3]
terr[2] += 1.8
print(f"FINAL terr={np.round(terr,4)} (exact-NN host oracle)")
