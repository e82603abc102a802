"""Reproduce and dissect a nonfinite_pose event: rebuild state through
PROBE_FRAME-1 with the real pipeline, then run the ICP solve alone on
frame PROBE_FRAME and print the raw pose matrix, iteration count, and
correspondence count — plus a sweep over max_iterations to find the
iteration at which the pose degenerates.

Env: PROBE_FRAME (16), PROBE_DENSITY (0.7), PROBE_PRESET (city).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import dataclasses
from functools import partial

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from sage_icp_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()
from sage_icp_tpu.models import pipeline as pl
from sage_icp_tpu.ops import scan as scan_ops
from sage_icp_tpu.utils import synthetic

F = int(os.environ.get("PROBE_FRAME", "16"))
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
    a = odom.last_aux
    print(f"f{i:03d} iters={int(a.icp_iterations)} "
          f"nonfin={int(a.nonfinite_pose)} rej={int(a.icp_rejected)}",
          flush=True)
st = odom.state

buf = np.full((cfg.scan_capacity, 4), scan_ops.INVALID_COORD, np.float32)
n = min(len(scans[F]), cfg.scan_capacity)
buf[:n] = scans[F][:n, :4]
pts = jnp.asarray(buf)
valid = pts[:, 0] < 1e6
ts = jnp.zeros((cfg.scan_capacity,), jnp.float32)

prep_fn = jax.jit(partial(pl.prepare_icp_inputs, config=cfg))
prep = prep_fn(st, pts, valid, ts)
print("guess:", np.round(np.asarray(prep["initial_guess"]), 4), flush=True)
print("sigma:", float(np.asarray(prep["sigma"])), flush=True)

for mi in (1, 2, 5, 10, 20, 50, 100, 200, 500):
    c = dataclasses.replace(cfg, max_icp_iterations=mi)
    icp = jax.jit(partial(pl.run_icp, config=c))(st.map, prep)
    P = np.asarray(icp.pose)
    R = P[:3, :3]
    ortho = float(np.sum((R.T @ R - np.eye(3)) ** 2))
    print(f"max_iter={mi:3d}: iters={int(icp.iterations)} "
          f"ncorr={int(icp.num_correspondences)} finite={np.isfinite(P).all()} "
          f"ortho={ortho:.2e} t={np.round(P[:3, 3], 3)}", flush=True)
    if not np.isfinite(P).all():
        print(P, flush=True)
        break
