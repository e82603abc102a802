"""Benchmark: steady-state LiDAR odometry throughput on one NVIDIA GPU.

Prints the device (JAX platform, device kind and count, and the cards'
name and power limit from nvidia-smi), then ONE JSON line:
  {"metric": "scans_per_sec", "value": N, "unit": "scans/s",
   "kitti_scale_scans_per_sec": M, ..., "device": {...}}

Exits non-zero when JAX finds no GPU: a CPU run is not a measurement.

TWO workloads, both the full semantic pipeline, both on the Manhattan-
grid city world (structure in all directions; the corridor world is
FORWARD-DEGENERATE for this class of odometry — the reference algorithm
itself diverges on it):
  * value — the "city" preset: capacities fitted to the city world's
    measured occupancy at density 0.7 (fixed shapes sized per
    deployment, like sizing for a known sensor); ~39k live map voxels,
    ~10k ICP sources per frame.
  * kitti_scale_scans_per_sec — the PRODUCTION "kitti" preset (262,144
    map slots, 135k scan capacity) at density 1.3, whose per-frame
    point counts match the real KITTI steady state (in-range raw ~89k,
    frame downsample ~60k vs KITTI ~53k, sources ~15k, live map ~49k
    voxels vs KITTI's ~50-100k; scripts/world_occupancy.py).

Every phase asserts the overflow counters (StepAux), summed over every
frame, are zero — a fixed-shape pipeline must not silently truncate its
workload — and that the trajectory tracked (ATE < 1 m).
"""

import dataclasses
import json
import os
import time

import numpy as np


def run_phase(config, world, n_warmup, n_frames, n_points, chunk, label):
    """Warm up with per-frame steps, then time chunked steps. Returns
    (scans_per_sec, live map voxels, ATE in m, the SageICP instance)."""
    import jax

    from sage_icp_tpu.models import pipeline as pl
    from sage_icp_tpu.utils import synthetic

    odom = pl.SageICP(config)
    world_pts, world_labs = world
    # one CONTINUOUS trajectory: per-frame warmup, then a chunked-step
    # compile warmup, then the timed frames (re-registering earlier scans
    # would teleport the vehicle backwards and spoil the map)
    n_frames -= n_frames % chunk
    n_total = n_warmup + chunk + n_frames
    gt = synthetic.make_trajectory(n_total, step=1.0)
    rng = np.random.default_rng(0)
    scans = [
        synthetic.render_scan(
            world_pts, world_labs, gt[i], rng, n_target=n_points,
            max_range=min(100.0, config.max_range),
        )
        for i in range(n_total)
    ]

    # warmup: jit compile + map fill
    for i in range(n_warmup):
        odom.register_frame(scans[i])
    # compile + warm the chunked step on the NEXT chunk of the trajectory
    odom.register_chunk(scans[n_warmup : n_warmup + chunk])
    odom.trajectory()

    padded = [
        odom.pad_chunk(scans[i : i + chunk])
        for i in range(n_warmup + chunk, n_total, chunk)
    ]
    # double-buffered uploads: dispatch chunk i's compute (async), then
    # push chunk i+1 to the device while it works. BENCH_OVERLAP=0
    # reverts to upload-then-dispatch.
    overlap = os.environ.get("BENCH_OVERLAP", "1") == "1"
    t0 = time.perf_counter()
    if overlap and padded:
        dev = jax.device_put(padded[0])
        for i in range(len(padded)):
            odom.register_chunk(dev)  # async dispatch
            if i + 1 < len(padded):
                dev = jax.device_put(padded[i + 1])
    else:
        for p in padded:
            odom.register_chunk(p)
    # fetching the final trajectory synchronizes everything, so the wall
    # clock covers every frame end to end
    odom.trajectory()
    elapsed = time.perf_counter() - t0

    scans_per_sec = n_frames / elapsed
    # ---- honesty guards: the fixed capacities must not silently drop
    # work on ANY frame (aux_totals sums the counters over all frames)
    aux = odom.aux_totals()
    assert int(aux.num_frame_ds) < config.frame_capacity * 0.95, (
        f"[{label}] frame capacity overflow — preset undersized"
    )
    assert int(aux.num_source) < config.source_capacity * 0.95, (
        f"[{label}] source capacity overflow — preset undersized"
    )
    assert max(len(s) for s in scans) <= config.scan_capacity, (
        f"[{label}] scan capacity overflow — preset undersized"
    )
    # ---- accuracy guard: a throughput number is only valid if the
    # frames actually TRACKED (GT is in hand: scans are rendered along it)
    est = odom.trajectory()
    g0 = np.linalg.inv(gt[0])
    errs = [
        np.linalg.norm(e[:3, 3] - (g0 @ g)[:3, 3])
        for e, g in zip(est, gt)
    ]
    ate = float(np.sqrt(np.mean(np.square(errs))))
    assert ate < 1.0, (
        f"[{label}] trajectory ATE {ate:.3f} m over {len(est)} frames — "
        "the run did not track; a throughput number for a lost run "
        f"is meaningless (max frame err {max(errs):.3f} m)"
    )
    overflow = int(aux.overflow_total())
    assert overflow == 0, (
        f"[{label}] silent-drop counters nonzero over all frames: "
        + " ".join(
            f"{k}={int(getattr(aux, k))}" for k in (
                "corr_dropped", "ds_truncated", "insert_unique_overflow",
                "insert_claim_failures", "insert_incoming_truncated",
                "dynfilter_overflow", "nonfinite_pose", "icp_rejected",
                "icp_forced",
            )
        )
    )
    n_map_voxels = int(np.asarray((odom.state.map.counts > 0).sum()))
    return scans_per_sec, n_map_voxels, ate, odom


def main():
    from sage_icp_tpu.utils.compile_cache import configure_compile_cache
    from sage_icp_tpu.utils.device import card_line, require_gpu

    device = require_gpu()
    print(f"device: {device['platform']} {device['kind']} "
          f"x{device['count']}")
    print(f"card: {card_line()}")
    configure_compile_cache()

    from sage_icp_tpu.models import pipeline as pl
    from sage_icp_tpu.utils import synthetic

    n_warmup = int(os.environ.get("BENCH_WARMUP", "10"))
    n_frames = int(os.environ.get("BENCH_FRAMES", "60"))
    n_points = int(os.environ.get("BENCH_POINTS", "120000"))
    chunk = int(os.environ.get("BENCH_CHUNK", "30"))

    # int16 scan upload (3.9 mm quantization, below LiDAR noise): halves
    # the host->device bytes; BENCH_QUPLOAD=0 reverts to f32
    qup = os.environ.get("BENCH_QUPLOAD", "1") == "1"

    # phase 1: fitted-capacity preset on the city world (headline)
    config = pl.PRESETS[os.environ.get("BENCH_PRESET", "city")]
    config = dataclasses.replace(config, quantized_scan_upload=qup)
    if "BENCH_DENSE_GRID" in os.environ:
        config = dataclasses.replace(
            config, dense_grid=os.environ["BENCH_DENSE_GRID"] == "1"
        )
    world = synthetic.build_city_world(
        seed=0, size=420.0,
        density=float(os.environ.get("BENCH_DENSITY", "0.7")),
    )
    sps, nvox, ate, _ = run_phase(
        config, world, n_warmup, n_frames, n_points, chunk, "city"
    )
    out = {
        "metric": "scans_per_sec",
        "value": sps,
        "unit": "scans/s",
        "map_voxels": nvox,
        "ate_m": ate,
    }

    # phase 2: PRODUCTION kitti preset at true KITTI map scale
    if os.environ.get("BENCH_KITTI", "1") == "1":
        kcfg = dataclasses.replace(
            pl.PRESETS["kitti"], quantized_scan_upload=qup
        )
        kworld = synthetic.build_city_world(
            seed=0, size=420.0,
            density=float(os.environ.get("BENCH_KITTI_DENSITY", "1.3")),
        )
        ksps, knvox, kate, _ = run_phase(
            kcfg, kworld, n_warmup,
            int(os.environ.get("BENCH_KITTI_FRAMES", str(n_frames))),
            n_points, chunk, "kitti-scale",
        )
        out["kitti_scale_scans_per_sec"] = ksps
        out["kitti_scale_map_voxels"] = knvox
        out["kitti_scale_ate_m"] = kate
    out["device"] = device
    print(json.dumps(out))


if __name__ == "__main__":
    main()
