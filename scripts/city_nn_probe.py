"""Why does ncorr decay on the city world while the pose is perfect?

Replays N frames of the kitti-preset city bench, then at frame N:
  * runs the pipeline correspondence pass (corr_setup + corr_apply)
  * computes the EXACT NN distance of every source point against the
    full map pointcloud on the host (scipy cKDTree)
and buckets the disagreements: a query whose exact NN is within the
gate but which the pipeline rejected is a SEARCH loss (probe/grid bug);
a query whose exact NN is beyond the gate is a MAP loss (content never
inserted / culled).
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
from sage_icp_tpu.ops import hashmap as hm
from sage_icp_tpu.ops import scan as scan_ops
from sage_icp_tpu.utils import synthetic

N = int(os.environ.get("PROBE_FRAME", "20"))
cfg = dataclasses.replace(pl.PRESETS["kitti"], quantized_scan_upload=True)
world_pts, world_labs = synthetic.build_city_world(seed=0, size=420.0,
                                                   density=2.0)
gt = synthetic.make_trajectory(N + 1, step=1.0)
rng = np.random.default_rng(0)
scans = [synthetic.render_scan(world_pts, world_labs, gt[i], rng,
                               n_target=120000, max_range=100.0)
         for i in range(N + 1)]

odom = pl.SageICP(cfg)
for i in range(N):
    odom.register_frame(scans[i])
    a = odom.last_aux
    print(f"  replay f{i}: sigma={float(a.sigma):.6f} "
          f"iters={int(a.icp_iterations)} "
          f"ncorr={int(a.num_correspondences)}", flush=True)
sigma = float(odom.last_aux.sigma)
st = odom.state
prediction = np.asarray(geo.se3_inverse(st.prev_pose) @ st.last_pose)
initial_guess = np.asarray(st.last_pose) @ prediction
print(f"frame {N}: sigma={sigma:.3f} gate={3 * sigma:.3f}", flush=True)

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
print("setup n_dropped:", int(setup.n_dropped), flush=True)
sg, tg, ag = cf.corr_apply(
    setup, jnp.eye(4), cfg.voxel_size_map, 3.0 * sigma, cfg.sem_th
)
# unsort back to query order is not needed: work on the grid directly
sgf = np.asarray(sg).reshape(-1, 4)
agf = np.asarray(ag).reshape(-1)
used = np.asarray(setup.grid_used).reshape(-1)

# host-side exact NN over the live map content
mp, mmask = hm.pointcloud(st.map, cfg.voxel_size_map)
mp = np.asarray(mp)[np.asarray(mmask)]
print(f"map points {len(mp)}, live voxels "
      f"{int(np.asarray((st.map.counts > 0).sum()))}", flush=True)
from scipy.spatial import cKDTree  # noqa: E402

tree = cKDTree(mp[:, :3])
q = sgf[used]
acc = agf[used]
d_exact, _ = tree.query(q[:, :3], k=1)
gate = 3.0 * sigma
pos = np.asarray(Tg[:3, 3])
rng_q = np.linalg.norm(q[:, :3] - pos[None], axis=1)
print(f"queries seated {used.sum()}  accepted {acc.sum()}", flush=True)
for lo, hi in [(0, 15), (15, 30), (30, 50), (50, 70), (70, 101)]:
    m = (rng_q >= lo) & (rng_q < hi)
    if m.sum() == 0:
        continue
    rej = m & ~acc
    search_loss = rej & (d_exact < gate * 0.98)
    map_loss = rej & (d_exact >= gate * 0.98)
    print(
        f"range {lo:3d}-{hi:3d}: n={m.sum():5d} acc={(m & acc).sum():5d} "
        f"search_loss={search_loss.sum():5d} map_loss={map_loss.sum():5d} "
        f"median_dexact_rej="
        f"{np.median(d_exact[rej]) if rej.sum() else float('nan'):.3f}",
        flush=True,
    )
# where do search losses sit relative to their voxel / the 27-neighborhood?
sl = (~acc) & (d_exact < gate * 0.98)
if sl.sum():
    print(f"TOTAL search losses {sl.sum()}: pipeline rejected though exact "
          f"NN within gate — sample d_exact "
          f"{np.round(np.sort(d_exact[sl])[:10], 3)}", flush=True)

# --- now the actual solve: does it walk away from a 99%-acceptance start?
from sage_icp_tpu.ops import registration as reg  # noqa: E402

kernel_th = sigma / 3.0
# manual GN iterations via the XLA (corr_apply) path
T_icp = jnp.eye(4)
for it in range(8):
    sg_i, tg_i, ag_i = cf.corr_apply(
        setup, T_icp, cfg.voxel_size_map, gate, cfg.sem_th
    )
    sflat = sg_i.reshape(-1, 4)[:, :3]
    tflat = tg_i.reshape(-1, 4)[:, :3]
    aflat = ag_i.reshape(-1)
    JTJ, JTr = reg.build_normal_equations(
        jnp.where(aflat[:, None], sflat, 0.0),
        jnp.where(aflat[:, None], tflat, 0.0),
        aflat, kernel_th,
    )
    x = reg.solve_increment(JTJ, JTr)
    dT = geo.se3_exp(x)
    T_icp = dT @ T_icp
    print(f"  manual iter {it}: ncorr={int(aflat.sum())} "
          f"|x|={float(jnp.linalg.norm(x)):.5f} "
          f"t={np.asarray(T_icp)[:3, 3].round(4)}", flush=True)

icp = reg.register_frame(
    st.map, src, sval, Tg, cfg.voxel_size_map, gate, kernel_th,
    cfg.sem_th, max_iterations=cfg.max_icp_iterations,
    probe_depth=cfg.probe_depth,
    fast_params=dict(
        unique_voxel_rows=cfg.corr_unique_voxel_rows,
        queries_per_voxel=cfg.corr_queries_per_voxel,
        overflow_rows=cfg.corr_overflow_rows,
    ),
    tables=tables,
)
print(f"register_frame (fused): iters={int(icp.iterations)} "
      f"ncorr={int(icp.num_correspondences)} "
      f"dt={np.asarray(icp.pose)[:3, 3] - np.asarray(Tg)[:3, 3]}",
      flush=True)
print(f"gt dt={(np.linalg.inv(gt[0]) @ gt[N])[:3, 3] - initial_guess[:3, 3]}",
      flush=True)
