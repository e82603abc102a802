"""KITTI-scale phase profile on the GPU — replicates the bench's kitti
phase (kitti preset, city world at density 1.3) and splits the per-frame
cost: staged-device chunk compute vs host upload, then the isolated
phases (prep, ICP solve at fixed iteration caps, insert, remove_far,
probe tables), to find where the wall time goes beyond the phases.

    python scripts/profile_kitti.py [--density 1.3] [--frames 20]
"""

import argparse
import dataclasses as dc
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp


from sage_icp_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()
from sage_icp_tpu.models import pipeline as pl
from sage_icp_tpu.ops import hashmap as hm
from sage_icp_tpu.utils import synthetic


def timeit(name, fn, *args, n=8):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    print(f"{name:46s} {dt * 1000:9.2f} ms", flush=True)
    return out, dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--density", type=float, default=1.3)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--chunk", type=int, default=10)
    args = ap.parse_args()

    qup = os.environ.get("BENCH_QUPLOAD", "1") == "1"
    cfg = dc.replace(pl.PRESETS["kitti"], quantized_scan_upload=qup)
    print("devices:", jax.devices(), flush=True)
    t0 = time.perf_counter()
    world = synthetic.build_city_world(seed=0, size=420.0,
                                       density=args.density)
    print(f"world built in {time.perf_counter() - t0:.0f}s "
          f"({len(world[0])} pts)", flush=True)

    n_warm = 10
    n_total = n_warm + args.frames + args.chunk
    gt = synthetic.make_trajectory(n_total, step=1.0)
    rng = np.random.default_rng(0)
    scans = [
        synthetic.render_scan(world[0], world[1], gt[i], rng,
                              n_target=120000)
        for i in range(n_total)
    ]
    odom = pl.SageICP(cfg)
    for i in range(n_warm):
        odom.register_frame(scans[i])
    a = odom.last_aux
    print(f"steady: n_ds={int(a.num_frame_ds)} n_src={int(a.num_source)} "
          f"iters={int(a.icp_iterations)} ncorr={int(a.num_correspondences)} "
          f"sigma={float(a.sigma):.3f}", flush=True)

    # ---- host pad + upload cost --------------------------------------------
    W = args.chunk
    t0 = time.perf_counter()
    padded = odom.pad_chunk(scans[n_warm : n_warm + W])
    t_pad = time.perf_counter() - t0
    print(f"host pad_chunk ({W} frames)                    "
          f"{t_pad / W * 1000:9.2f} ms/frame", flush=True)
    t0 = time.perf_counter()
    dev = jax.device_put(padded)
    jax.block_until_ready(dev)
    t_up = time.perf_counter() - t0
    print(f"upload {padded.nbytes / 1e6:.1f} MB ({W} frames)              "
          f"{t_up / W * 1000:9.2f} ms/frame", flush=True)

    # ---- chunked step on PRE-STAGED device scans (pure compute) ------------
    step = pl.make_chunk_step(cfg, W)
    st = jax.tree.map(jnp.copy, odom.state)
    st, poses, _ = step(st, dev)  # compile
    jax.block_until_ready(poses)
    # fresh state copies per run (donation): time K dispatches
    K = 3
    states = [jax.tree.map(jnp.copy, odom.state) for _ in range(K)]
    devs = [jax.device_put(padded) for _ in range(K)]
    jax.block_until_ready((states, devs))
    t0 = time.perf_counter()
    for k in range(K):
        _, poses, _ = step(states[k], devs[k])
    jax.block_until_ready(poses)
    dt = (time.perf_counter() - t0) / (K * W)
    print(f"chunked step, staged scans (compute-only)      "
          f"{dt * 1000:9.2f} ms/frame", flush=True)

    # ---- register_chunk as the bench does it (upload + compute) ------------
    t0 = time.perf_counter()
    odom.register_chunk(padded)
    odom.trajectory()
    dt = (time.perf_counter() - t0) / W
    print(f"register_chunk incl upload (bench path)        "
          f"{dt * 1000:9.2f} ms/frame", flush=True)

    # ---- isolated phases ----------------------------------------------------
    state = odom.state
    from sage_icp_tpu.ops import scan as scan_ops

    buf = np.full((cfg.scan_capacity, 4), scan_ops.INVALID_COORD,
                  np.float32)
    s = scans[n_warm + W]
    buf[: len(s)] = s[:, :4]
    val = np.zeros((cfg.scan_capacity,), bool)
    val[: len(s)] = True
    pts = jnp.asarray(buf)
    valid = jnp.asarray(val)
    ts = jnp.zeros((cfg.scan_capacity,), jnp.float32)

    prep_fn = jax.jit(lambda st_, p, v, t: pl.prepare_icp_inputs(
        st_, p, v, t, cfg))
    prep, _ = timeit("prepare_icp_inputs (deskew..tables)", prep_fn,
                     state, pts, valid, ts)

    for iters in (1, 2, 5, 10):
        icp_fn = jax.jit(lambda m, pr, it=iters: pl.run_icp(
            m, pr, dc.replace(cfg, max_icp_iterations=it)))
        timeit(f"run_icp max_iters={iters}", icp_fn, state.map, prep)

    mask = pl._basic_label_mask(cfg)
    ins = jax.jit(lambda st_, p, v: hm.insert(
        st_, p, v, cfg.voxel_size_map, cfg.basic_points_per_voxel, mask,
        cfg.max_incoming_per_voxel, cfg.probe_depth,
        unique_voxel_capacity=min(cfg.insert_unique_capacity,
                                  cfg.frame_capacity),
        basic_labels=cfg.basic_parts_labels))
    wf = jax.jit(lambda pose, f: jax.tree.map(
        lambda x: x, (pose, f)))  # no-op placeholder
    frame_ds, frame_valid = prep["frame_ds"], prep["frame_valid"]
    from sage_icp_tpu.ops import geometry as geo

    world_frame = jax.jit(geo.transform_points)(prep["initial_guess"],
                                                frame_ds)
    timeit("map insert (frame_ds)", ins, state.map, world_frame,
           frame_valid)

    rem = jax.jit(lambda st_: hm.remove_far(
        st_, jnp.zeros(3), cfg.local_map_range))
    timeit("remove_far", rem, state.map)

    from sage_icp_tpu.ops import correspondence_fast as cf
    from sage_icp_tpu.ops.scan import trunc_div

    tbl = jax.jit(lambda m, c: cf.build_probe_tables(m, c, cfg.probe_depth))
    center = trunc_div(prep["initial_guess"][:3, 3], cfg.voxel_size_map)
    timeit("build_probe_tables", tbl, state.map, center)

    setup_fn = jax.jit(lambda m, t, q, v: cf.corr_setup(
        m, t, q, v, cfg.voxel_size_map, cfg.probe_depth,
        unique_voxel_rows=cfg.corr_unique_voxel_rows,
        queries_per_voxel=cfg.corr_queries_per_voxel,
        overflow_rows=cfg.corr_overflow_rows))
    tables = tbl(state.map, center)
    src_anchor = jax.jit(geo.transform_points)(prep["initial_guess"],
                                               prep["source"])
    timeit("corr_setup (sort+probe+gather+planes)", setup_fn,
           state.map, tables, src_anchor, prep["source_valid"])


if __name__ == "__main__":
    main()
