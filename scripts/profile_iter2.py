"""TRUE per-ICP-iteration cost in the full chunked step: force the exact
iteration count by zeroing the convergence threshold (every frame then
runs exactly max_icp_iterations), and difference two caps."""

import os, sys, time
import dataclasses as dc
import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sage_icp_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()
from sage_icp_tpu.models import pipeline as pl
from sage_icp_tpu.ops import registration as reg
from sage_icp_tpu.ops import scan as scan_ops
from sage_icp_tpu.utils import synthetic


def main():
    reg.ESTIMATION_THRESHOLD = 0.0  # never converge: iters == cap exactly
    cfg = pl.PRESETS["synthetic"]
    print("devices:", jax.devices(), flush=True)
    world_pts, world_labs = synthetic.build_world(seed=0, length=260.0,
                                                  density=2)
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

    results = {}
    for iters in (6, 12, 22):
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
        results[iters] = dt
        print(f"forced iters={iters:3d}  {dt:8.2f} ms/frame  "
              f"(aux iters={int(aux.icp_iterations)})", flush=True)
    ks = sorted(results)
    for a, b in zip(ks, ks[1:]):
        print(f"  per-iter {a}->{b}: "
              f"{(results[b]-results[a])/(b-a):6.3f} ms", flush=True)


if __name__ == "__main__":
    main()
