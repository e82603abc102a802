"""Decompose the correspondence residual field at the divergence onset.

Replays frames 0..N-1, then at frame N reproduces the pipeline's ICP
inputs (initial guess, sigma) and dumps, per range/label bucket: count,
mean residual vector (src - tgt, world frame), mean |r|, and the
Geman-McClure-weighted mean (what the solve actually feels). Then runs
the GN loop manually, printing each increment.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import dataclasses

import jax.numpy as jnp
import numpy as np

from sage_icp_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()
from sage_icp_tpu.models import pipeline as pl
from sage_icp_tpu.ops import correspondence_fast as cf
from sage_icp_tpu.ops import geometry as geo
from sage_icp_tpu.ops import registration as reg
from sage_icp_tpu.ops import scan as scan_ops
from sage_icp_tpu.utils import synthetic

N = int(os.environ.get("PROBE_FRAME", "16"))
cfg = dataclasses.replace(pl.PRESETS["synthetic"], quantized_scan_upload=True)
world_pts, world_labs = synthetic.build_world(seed=0, length=260.0, density=2.0)
gt = synthetic.make_trajectory(N + 1, step=1.0)
rng = np.random.default_rng(0)
scans = [synthetic.render_scan(world_pts, world_labs, gt[i], rng,
                               n_target=120000, max_range=100.0)
         for i in range(N + 1)]

odom = pl.SageICP(cfg)
for i in range(N):
    odom.register_frame(scans[i])
sigma = float(odom.last_aux.sigma)
st = odom.state
prediction = np.asarray(geo.se3_inverse(st.prev_pose) @ st.last_pose)
initial_guess = np.asarray(st.last_pose) @ prediction
print(f"frame {N}: sigma={sigma:.3f} gate={3*sigma:.3f} "
      f"kernel={sigma/3:.4f}", flush=True)
print(f"guess t={initial_guess[:3, 3]}", flush=True)

# pipeline-identical preprocessing of frame N
pts = np.full((cfg.scan_capacity, 4), scan_ops.INVALID_COORD, np.float32)
n = min(len(scans[N]), cfg.scan_capacity)
pts[:n] = scans[N][:n, :4]
pj = jnp.asarray(pts)
valid = pj[:, 0] < 1e6
cropped, cval = scan_ops.preprocess(
    pj, valid, cfg.max_range, cfg.min_range, cfg.label_max_range
)
(src, sval), _ = pl.voxelize(cropped, cval, cfg)
Tg = jnp.asarray(initial_guess, jnp.float32)
src_w = geo.transform_points(Tg, src)
center = scan_ops.trunc_div(Tg[:3, 3], cfg.voxel_size_map)
tables = cf.build_probe_tables(st.map, center, cfg.probe_depth)
setup = cf.corr_setup(
    st.map, tables, src_w, sval, cfg.voxel_size_map, cfg.probe_depth,
    unique_voxel_rows=cfg.corr_unique_voxel_rows,
    queries_per_voxel=cfg.corr_queries_per_voxel,
    overflow_rows=cfg.corr_overflow_rows,
)
sg, tg, ag = cf.corr_apply(
    setup, jnp.eye(4), cfg.voxel_size_map, 3.0 * sigma, cfg.sem_th
)
sgf = np.asarray(sg).reshape(-1, 4)
tgf = np.asarray(tg).reshape(-1, 4)
agf = np.asarray(ag).reshape(-1)
srcp = sgf[agf]
tgtp = tgf[agf]
res = srcp[:, :3] - tgtp[:, :3]
r2 = (res ** 2).sum(1)
k = sigma / 3
w = (k * k) / (k + r2) ** 2
pos = np.asarray(Tg[:3, 3])
rng_q = np.linalg.norm(srcp[:, :3] - pos[None], axis=1)
print(f"accepted {agf.sum()} of {int(np.asarray(sval).sum())}", flush=True)
for lo, hi in [(0, 15), (15, 30), (30, 50), (50, 70), (70, 101)]:
    m = (rng_q >= lo) & (rng_q < hi)
    if m.sum() == 0:
        continue
    mr = res[m]
    mw = w[m]
    wm = (mr * mw[:, None]).sum(0) / mw.sum()
    print(f"range {lo:3d}-{hi:3d}: n={m.sum():5d} mean_res="
          f"{np.round(mr.mean(0), 4)} wmean={np.round(wm, 4)} "
          f"mean|r|={np.linalg.norm(mr, axis=1).mean():.3f} "
          f"wsum={mw.sum():.1f}", flush=True)

# manual GN iterations from the guess
icp = reg.register_frame(
    st.map, src, sval, Tg, cfg.voxel_size_map, 3.0 * sigma, sigma / 3.0,
    cfg.sem_th, max_iterations=cfg.max_icp_iterations,
    probe_depth=cfg.probe_depth,
    fast_params=dict(
        unique_voxel_rows=cfg.corr_unique_voxel_rows,
        queries_per_voxel=cfg.corr_queries_per_voxel,
        overflow_rows=cfg.corr_overflow_rows,
    ),
    tables=tables,
)
print(f"full solve: iters={int(icp.iterations)} "
      f"ncorr={int(icp.num_correspondences)} "
      f"t={np.asarray(icp.pose)[:3, 3]}", flush=True)
print(f"gt t={gt[N][:3, 3] - gt[0][:3, 3] * np.array([1, 1, 1])}", flush=True)
