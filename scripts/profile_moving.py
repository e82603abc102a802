"""Moving-chunk ICP cost slope: time chunks of 10 real consecutive scans
at several max_icp_iterations caps to get ms/iteration under real motion."""

import os, sys, time
import dataclasses as dc
import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sage_icp_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()
from sage_icp_tpu.models import pipeline as pl
from sage_icp_tpu.ops import scan as scan_ops
from sage_icp_tpu.utils import synthetic


def main():
    cfg = pl.PRESETS["synthetic"]
    print("devices:", jax.devices(), flush=True)
    world_pts, world_labs = synthetic.build_world(seed=0, length=260.0, density=2)
    gt = synthetic.make_trajectory(22, step=1.0)
    rng = np.random.default_rng(0)
    odom = pl.SageICP(cfg)
    for i in range(10):
        odom.register_frame(synthetic.render_scan(
            world_pts, world_labs, gt[i], rng, n_target=120000))
    state = odom.state
    cap = cfg.scan_capacity
    movbuf = np.full((10, cap, 4), scan_ops.INVALID_COORD, dtype=np.float32)
    for i in range(10):
        s = synthetic.render_scan(world_pts, world_labs, gt[10 + i], rng,
                                  n_target=120000)
        movbuf[i, : len(s)] = s[:cap]
    dev_scans = jnp.asarray(movbuf)
    jax.block_until_ready(dev_scans)

    for iters in (1, 3, 6, 9, 500):
        config = dc.replace(cfg, max_icp_iterations=iters)
        step = pl.make_chunk_step(config, 10)
        stA = jax.tree.map(jnp.copy, state)
        _, poses, _ = step(stA, dev_scans)
        jax.block_until_ready(poses)
        stB = jax.tree.map(jnp.copy, state)
        t0 = time.perf_counter()
        _, poses, aux = step(stB, dev_scans)
        np.asarray(poses[-1])
        dt = (time.perf_counter() - t0) / 10 * 1e3
        print(f"max_iters={iters:4d}  {dt:8.2f} ms/frame  "
              f"(last frame iters={int(aux.icp_iterations)})", flush=True)


if __name__ == "__main__":
    main()
