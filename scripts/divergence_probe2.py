"""Component cross-check at the divergence frame: which half is wrong —
the device correspondence search or the f32 normal equations?

Rebuilds the f020 state like divergence_probe.py, then runs four GN
loops (python-level iteration, 60 iters max):
  A. host exact-NN search + f64 solve      (known good)
  B. device get_correspondences + f64 solve
  C. host exact-NN search + f32 device normal equations/solve
  D. device get_correspondences + f32 device normal equations/solve
and prints the per-iteration terr trace for each.

Env: PROBE_FRAME (default 20), PROBE_DENSITY (0.7), PROBE_PRESET (city).
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
from sage_icp_tpu.ops import geometry as geo
from sage_icp_tpu.ops import hashmap as hm
from sage_icp_tpu.ops import registration as reg
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
st = odom.state

map_pts, map_mask = hm.pointcloud(st.map, cfg.voxel_size_map)
map_pts = np.asarray(map_pts)[np.asarray(map_mask)]
tree = cKDTree(map_pts[:, :3])
map_lab = map_pts[:, 3].astype(np.int32)

buf = np.full((cfg.scan_capacity, 4), scan_ops.INVALID_COORD, np.float32)
n = min(len(scans[F]), cfg.scan_capacity)
buf[:n] = scans[F][:n, :4]
pts = jnp.asarray(buf)
vmask = jnp.asarray(buf[:, 0] < 1e6)
cropped, crop_valid = scan_ops.preprocess(
    pts, vmask, cfg.max_range, cfg.min_range, cfg.label_max_range)
(source_j, source_valid_j), _ = pl.voxelize(cropped, crop_valid, cfg)
src_np = np.asarray(source_j)
val_np = np.asarray(source_valid_j)

motion = np.linalg.norm(
    (np.linalg.inv(np.asarray(st.first_pose)) @ np.asarray(st.last_pose))[:3, 3])
has_moved = int(st.num_poses) > 0 and motion > 5.0 * cfg.min_motion_th
sigma = float(np.asarray(
    pl._adaptive_sigma(st.threshold, jnp.asarray(has_moved), cfg)[0]))
gate, kernel, sem_th = 3.0 * sigma, sigma / 3.0, cfg.sem_th
guess = np.asarray(st.last_pose) @ (
    np.linalg.inv(np.asarray(st.prev_pose)) @ np.asarray(st.last_pose))
print(f"sigma={sigma:.4f} sources={val_np.sum()}")

dev_corr = jax.jit(lambda q: hm.get_correspondences(
    st.map, q, source_valid_j, cfg.voxel_size_map, gate, sem_th,
    cfg.probe_depth))
dev_ne = jax.jit(lambda s, t, a: reg.build_normal_equations(s, t, a, kernel))
dev_solve = jax.jit(reg.solve_increment)


def host_search(s_xyz, src_l):
    d, idx = tree.query(s_xyz, k=8, distance_upper_bound=gate)
    ok = np.isfinite(d)
    idxc = np.where(ok, idx, 0)
    same = (map_lab[idxc] == src_l[:, None]) | (
        map_lab[idxc] * src_l[:, None] == 0)
    d2w = np.where(ok, d * d * np.where(same, sem_th, 1.0), np.inf)
    best = np.argmin(d2w, axis=1)
    bidx = idxc[np.arange(len(s_xyz)), best]
    bd = d[np.arange(len(s_xyz)), best]
    accept = np.isfinite(bd) & (bd < gate)
    return map_pts[bidx, :3], accept


def host_ne(s_xyz, tgt, accept):
    r = s_xyz - tgt
    r2 = np.sum(r * r, axis=1)
    w = np.where(accept, kernel**2 / (kernel + r2) ** 2, 0.0)
    J = np.zeros((len(s_xyz), 3, 6))
    J[:, 0, 0] = J[:, 1, 1] = J[:, 2, 2] = 1.0
    J[:, 0, 4], J[:, 0, 5] = s_xyz[:, 2], -s_xyz[:, 1]
    J[:, 1, 3], J[:, 1, 5] = -s_xyz[:, 2], s_xyz[:, 0]
    J[:, 2, 3], J[:, 2, 4] = s_xyz[:, 1], -s_xyz[:, 0]
    Jf = J.reshape(-1, 6)
    Wf = np.repeat(w, 3)
    JTJ = Jf.T @ (Jf * Wf[:, None])
    JTr = Jf.T @ (r.reshape(-1) * Wf)
    return JTJ, JTr


def run(search, solve, tag, iters=60):
    pose = guess.copy()
    src_l = src_np[:, 3].astype(np.int32)
    for it in range(iters):
        s_all = src_np[:, :3] @ pose[:3, :3].T + pose[:3, 3]
        if search == "host":
            s_xyz = s_all[val_np]
            tgt, accept = host_search(s_xyz, src_l[val_np])
            if solve == "f64":
                JTJ, JTr = host_ne(s_xyz, tgt, accept)
                x = np.linalg.solve(JTJ + 1e-8 * np.eye(6), -JTr)
            else:
                s4 = np.concatenate(
                    [s_xyz, src_np[val_np, 3:4]], 1).astype(np.float32)
                t4 = np.concatenate(
                    [tgt, np.zeros((len(tgt), 1))], 1).astype(np.float32)
                JTJ, JTr = dev_ne(jnp.asarray(s4), jnp.asarray(t4),
                                  jnp.asarray(accept))
                x = np.asarray(dev_solve(JTJ, JTr))
            nacc = int(accept.sum())
        else:
            moved = np.concatenate([s_all, src_np[:, 3:4]], 1).astype(
                np.float32)
            tgt_j, acc_j = dev_corr(jnp.asarray(moved))
            if solve == "f64":
                tgt_np = np.asarray(tgt_j)[:, :3]
                acc_np = np.asarray(acc_j)
                JTJ, JTr = host_ne(s_all, tgt_np, acc_np & val_np)
                x = np.linalg.solve(JTJ + 1e-8 * np.eye(6), -JTr)
            else:
                JTJ, JTr = dev_ne(jnp.asarray(moved, jnp.float32), tgt_j,
                                  acc_j)
                x = np.asarray(dev_solve(JTJ, JTr))
            nacc = int(np.asarray(acc_j).sum())
        pose = np.asarray(geo.se3_exp(jnp.asarray(x, jnp.float32))) @ pose
        nx = float(np.linalg.norm(np.asarray(x)))
        if it < 6 or it % 10 == 0 or nx < 1e-4:
            terr = pose[:3, 3] - gt[F][:3, 3]
            terr[2] += 1.8
            print(f"[{tag}] it{it:3d} |x|={nx:.2e} nacc={nacc} "
                  f"terr={np.round(terr, 4)}")
        if nx < 1e-4:
            break
    terr = pose[:3, 3] - gt[F][:3, 3]
    terr[2] += 1.8
    print(f"[{tag}] FINAL it={it} terr={np.round(terr, 4)}")


run("host", "f64", "A host+f64")
run("dev", "f64", "B devsearch+f64")
run("host", "f32", "C hostsearch+f32")
run("dev", "f32", "D dev+f32")
