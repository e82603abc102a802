"""Round-5 bisect: why does the corridor 12-frame run diverge at HEAD?

Matrix over (config, n_target): the pipeline-test config (small caps,
100 iters) vs the robustness/golden config (big caps, 500 iters), at
n_target 9000 vs 14000. Prints per-frame error + aux counters.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from sage_icp_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()
from sage_icp_tpu.models import pipeline as pl
from sage_icp_tpu.utils import synthetic


def pipe_cfg(**kw):
    d = dict(
        scan_capacity=16384, frame_capacity=16384, source_capacity=4096,
        map_capacity=32768, max_icp_iterations=100,
        dynamic_vehicle_filter=False, min_range=1.0,
        corr_unique_voxel_rows=4096, corr_overflow_rows=512,
        insert_unique_capacity=4096,
    )
    d.update(kw)
    return pl.SageConfig(**d)


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


def run(name, cfg, n_target, n_frames=12, seed=3, verbose=True):
    world = synthetic.build_world(seed=1, length=80.0)
    pts, labs = world
    rng = np.random.default_rng(seed)
    gt = synthetic.make_trajectory(n_frames, step=1.0)
    odom = pl.SageICP(cfg)
    g0 = np.linalg.inv(gt[0])
    errs = []
    for i in range(n_frames):
        scan = synthetic.render_scan(pts, labs, gt[i], rng, n_target=n_target)
        odom.register_frame(scan)
        a = odom.last_aux
        est = np.asarray(odom.poses[-1])
        err = np.linalg.norm(est[:3, 3] - (g0 @ gt[i])[:3, 3])
        errs.append(err)
        if verbose:
            print(
                f"  f{i:02d} err={err:7.3f} nsrc={int(a.num_source):5d} "
                f"ncorr={int(a.num_correspondences):5d} "
                f"iters={int(a.icp_iterations):3d} sig={float(a.sigma):6.3f} "
                f"ovf={int(a.overflow_total())} drop={int(a.corr_dropped)} "
                f"claim={int(a.insert_claim_failures)} rej={int(a.icp_rejected)}"
            )
    ate = float(np.sqrt(np.mean(np.square(errs))))
    print(f"{name}: ATE={ate:.3f}")
    return ate


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("all", "A"):
        run("A pipe_cfg@9000", pipe_cfg(), 9000)
    if which in ("all", "B"):
        run("B pipe_cfg@14000", pipe_cfg(), 14000)
    if which in ("all", "C"):
        run("C robu_cfg@9000", robu_cfg(), 9000)
    if which in ("all", "D"):
        run("D robu_cfg@14000 (golden)", robu_cfg(), 14000)
