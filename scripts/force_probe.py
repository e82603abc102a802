"""Decompose the point-to-point GM-weighted FORCE at a divergence onset.

Replays frames 0..F-1 through the real pipeline, then for frame F FROM
THE GROUND-TRUTH POSE computes exact host NN matches (cKDTree, gate =
3*sigma) and prints, per (sector x range x label) bucket:
  count, mean weighted residual vector (what the normal equations feel),
  and each bucket's contribution to the translational gradient J^T W r.
Then prints the GN first increments from gt. The bucket whose weighted
residual points along the observed drift direction (+x forward) is the
culprit.

Env: PROBE_FRAME (15), PROBE_DENSITY (0.7), PROBE_PRESET (city).
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

F = int(os.environ.get("PROBE_FRAME", "15"))
cfg = dataclasses.replace(
    pl.PRESETS[os.environ.get("PROBE_PRESET", "city")],
    quantized_scan_upload=True,
)
world_pts, world_labs = synthetic.build_city_world(
    seed=0, size=420.0, density=float(os.environ.get("PROBE_DENSITY", "0.7"))
)
gt = synthetic.make_trajectory(F + 1, step=1.0)
rng = np.random.default_rng(0)
scans = [synthetic.render_scan(world_pts, world_labs, gt[i], rng,
                               n_target=120000, max_range=100.0)
         for i in range(F + 1)]
odom = pl.SageICP(cfg)
for i in range(F):
    odom.register_frame(scans[i])
st = odom.state
est_err = np.asarray(st.last_pose)[:3, 3] - (gt[F - 1][:3, 3] - gt[0][:3, 3])
print(f"state err at f{F-1}: {np.round(est_err, 4)}")

map_pts, map_mask = hm.pointcloud(st.map, cfg.voxel_size_map)
mp = np.asarray(map_pts)[np.asarray(map_mask)]
tree = cKDTree(mp[:, :3])
map_lab = mp[:, 3].astype(np.int32)

buf = np.full((cfg.scan_capacity, 4), scan_ops.INVALID_COORD, np.float32)
n = min(len(scans[F]), cfg.scan_capacity)
buf[:n] = scans[F][:n, :4]
pts = jnp.asarray(buf)
cropped, cval = scan_ops.preprocess(
    pts, pts[:, 0] < 1e6, cfg.max_range, cfg.min_range, cfg.label_max_range)
(src_j, sval_j), _ = pl.voxelize(cropped, cval, cfg)
src = np.asarray(src_j)[np.asarray(sval_j)]

sigma = float(np.asarray(pl._adaptive_sigma(
    st.threshold, jnp.asarray(True), cfg)[0]))
gate, kernel, sem_th = 3.0 * sigma, sigma / 3.0, cfg.sem_th
print(f"sigma={sigma:.4f} gate={gate:.3f} kernel={kernel:.4f} nsrc={len(src)}")

gt_rel = gt[F].copy()
gt_rel[:3, 3] -= gt[0][:3, 3]
if os.environ.get("PROBE_FROM", "gt") == "guess":
    start = np.asarray(st.last_pose) @ (
        np.linalg.inv(np.asarray(st.prev_pose)) @ np.asarray(st.last_pose))
    print(f"decomposing at GUESS, terr={np.round(start[:3,3]-gt_rel[:3,3],4)}")
else:
    start = gt_rel
s_world = src[:, :3] @ start[:3, :3].T + start[:3, 3]
src_l = src[:, 3].astype(np.int32)

# exact semantic NN (k=8 covers the weighted-argmin reordering)
d, idx = tree.query(s_world, k=8, distance_upper_bound=gate)
ok = np.isfinite(d)
idxc = np.where(ok, idx, 0)
same = (map_lab[idxc] == src_l[:, None]) | (map_lab[idxc] * src_l[:, None] == 0)
d2w = np.where(ok, d * d * np.where(same, sem_th, 1.0), np.inf)
best = np.argmin(d2w, axis=1)
ar = np.arange(len(s_world))
bidx = idxc[ar, best]
bd = d[ar, best]
accept = np.isfinite(bd) & (bd < gate)
tgt = mp[bidx, :3]
r = s_world - tgt  # residual; gradient direction for the pose shift
w = np.where(accept, kernel**2 / (kernel + (bd * bd)) ** 2, 0.0)

rloc = np.linalg.norm(src[:, :3], axis=1)
ahead = src[:, 0] > 0  # sensor frame +x = travel direction
range_bins = [(0, 20), (20, 50), (50, 101)]
print(f"total accepted {accept.sum()}/{len(src)}  "
      f"total weighted force {np.round((w[:, None] * r).sum(0), 4)}")
for lo, hi in range_bins:
    for a, atag in ((ahead, "ahead"), (~ahead, "behind")):
        m = accept & a & (rloc >= lo) & (rloc < hi)
        if m.sum() == 0:
            continue
        f = (w[m, None] * r[m]).sum(0)
        print(f"  r[{lo:3d},{hi:3d}) {atag:6s}: n={m.sum():5d} "
              f"meanw={w[m].mean():.3f} force={np.round(f, 4)} "
              f"mean_r={np.round(r[m].mean(0), 4)}")
# by label among accepted
for lab in np.unique(src_l[accept]):
    m = accept & (src_l == lab)
    f = (w[m, None] * r[m]).sum(0)
    print(f"  label {lab:3d}: n={m.sum():5d} force={np.round(f, 4)}")

# GN steps from the chosen start pose
pose = start.copy()
for it in range(8):
    s_all = src[:, :3] @ pose[:3, :3].T + pose[:3, 3]
    d, idx = tree.query(s_all, k=8, distance_upper_bound=gate)
    ok = np.isfinite(d)
    idxc = np.where(ok, idx, 0)
    same = (map_lab[idxc] == src_l[:, None]) | (
        map_lab[idxc] * src_l[:, None] == 0)
    d2w = np.where(ok, d * d * np.where(same, sem_th, 1.0), np.inf)
    best = np.argmin(d2w, axis=1)
    bidx = idxc[ar, best]
    bd = d[ar, best]
    acc = np.isfinite(bd) & (bd < gate)
    tgtT = mp[bidx, :3]
    rr = s_all - tgtT
    ww = np.where(acc, kernel**2 / (kernel + bd * bd) ** 2, 0.0)
    J = np.zeros((len(s_all), 3, 6))
    J[:, 0, 0] = J[:, 1, 1] = J[:, 2, 2] = 1.0
    J[:, 0, 4], J[:, 0, 5] = s_all[:, 2], -s_all[:, 1]
    J[:, 1, 3], J[:, 1, 5] = -s_all[:, 2], s_all[:, 0]
    J[:, 2, 3], J[:, 2, 4] = s_all[:, 1], -s_all[:, 0]
    Jf = J.reshape(-1, 6)
    Wf = np.repeat(ww, 3)
    JTJ = Jf.T @ (Jf * Wf[:, None])
    JTr = Jf.T @ (rr.reshape(-1) * Wf)
    x = np.linalg.solve(JTJ + 1e-8 * np.eye(6), -JTr)
    from sage_icp_tpu.ops import geometry as geo
    pose = np.asarray(geo.se3_exp(jnp.asarray(x, jnp.float32))) @ pose
    terr = pose[:3, 3] - gt_rel[:3, 3]
    print(f"GN it{it}: |x|={np.linalg.norm(x):.2e} nacc={acc.sum()} "
          f"terr={np.round(terr, 4)}")
