"""Phase-level profiling: time each pipeline stage in isolation to find
the bottleneck. Run on the GPU: python scripts/profile_phases.py"""

import os
import sys
import time


import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sage_icp_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()
from sage_icp_tpu.models import pipeline as pl
from sage_icp_tpu.ops import hashmap as hm
from sage_icp_tpu.ops import registration as reg
from sage_icp_tpu.ops import scan as scan_ops
from sage_icp_tpu.utils import synthetic


def timeit(name, fn, *args, n=10):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    print(f"{name:40s} {dt * 1000:9.2f} ms")
    return out, dt


def main():
    cfg = pl.SageConfig(dynamic_vehicle_filter=False, min_range=2.0)
    print("devices:", jax.devices())

    world_pts, world_labs = synthetic.build_world(seed=0, length=260.0)
    gt = synthetic.make_trajectory(12, step=1.0)
    rng = np.random.default_rng(0)

    odom = pl.SageICP(cfg)
    for i in range(10):  # fill the map to steady state
        scan = synthetic.render_scan(world_pts, world_labs, gt[i], rng,
                                     n_target=120000)
        odom.register_frame(scan)
    a = odom.last_aux
    print("steady state: n_ds=", int(a.num_frame_ds), "n_src=",
          int(a.num_source), "iters=", int(a.icp_iterations),
          "ncorr=", int(a.num_correspondences), "sigma=", float(a.sigma))

    state = odom.state
    scan = synthetic.render_scan(world_pts, world_labs, gt[10], rng,
                                 n_target=120000)
    cap = cfg.scan_capacity
    buf = np.full((cap, 4), scan_ops.INVALID_COORD, dtype=np.float32)
    buf[: len(scan)] = scan
    val = np.zeros((cap,), dtype=bool)
    val[: len(scan)] = True
    pts = jnp.asarray(buf)
    valid = jnp.asarray(val)
    ts = jnp.zeros((cap,), jnp.float32)

    # ---- phases ----
    lut = scan_ops.make_label_group_lut(list(map(list, cfg.voxel_labels)))
    sizes = jnp.asarray(cfg.voxel_size, dtype=jnp.float32)

    pre = jax.jit(lambda p, v: scan_ops.preprocess(
        p, v, cfg.max_range, cfg.min_range, cfg.label_max_range))
    (cropped, crop_valid), _ = timeit("preprocess (crop)", pre, pts, valid)

    ds1 = jax.jit(lambda p, v: scan_ops.voxel_downsample(
        p, v, lut, sizes, 0.5, cfg.frame_capacity))
    (frame_ds, frame_valid), _ = timeit("downsample 0.5x (135k->65k)", ds1,
                                        cropped, crop_valid)

    ds2 = jax.jit(lambda p, v: scan_ops.voxel_downsample(
        p, v, lut, sizes, 1.5, cfg.source_capacity))
    (source, source_valid), _ = timeit("downsample 1.5x (65k->16k)", ds2,
                                       frame_ds, frame_valid)

    mask = pl._basic_label_mask(cfg)
    ins = jax.jit(lambda st, p, v: hm.insert(
        st, p, v, cfg.voxel_size_map, cfg.basic_points_per_voxel, mask,
        cfg.max_incoming_per_voxel, cfg.probe_depth))
    timeit("map insert (65k pts)", ins, state.map, frame_ds, frame_valid)

    rem = jax.jit(lambda st: hm.remove_far(st, jnp.zeros(3), cfg.local_map_range))
    timeit("map remove_far", rem, state.map)

    corr = jax.jit(lambda st, q, v: hm.get_correspondences(
        st, q, v, cfg.voxel_size_map, 0.75, cfg.sem_th, cfg.probe_depth))
    (tgt, acc), dt_corr = timeit("correspondences (1 gather pass)",
                                 corr, state.map, source, source_valid)

    ne = jax.jit(lambda s, t, m: reg.build_normal_equations(s, t, m, 0.08))
    timeit("normal equations (16k pts)", ne, source, tgt, acc)

    icp = jax.jit(lambda st, s, v: reg.register_frame(
        st, s, v, jnp.eye(4, dtype=jnp.float32), cfg.voxel_size_map,
        0.75, 0.08, cfg.sem_th, 500, cfg.probe_depth))
    res, dt_icp = timeit("full ICP solve", icp, state.map, source, source_valid, n=5)
    print("   icp iterations:", int(res.iterations))

    step = pl.make_step(cfg, donate=False)
    timeit("FULL STEP", step, state, pts, valid, ts, n=5)


if __name__ == "__main__":
    main()
