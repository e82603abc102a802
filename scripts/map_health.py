"""Map-health diagnostics (consolidated from the round-2/3 map_health,
map_health2, map_health3 tools).

Modes (MH_MODE env):
  onset (default) — register frames 0..MH_FRAMES, and per frame measure
      (a) live voxel count + duplicate live keys (same voxel in two
      slots: claim bug), (b) the fraction of the NEXT scan's sources
      that the fast engine accepts at gate 0.6 FROM THE GROUND-TRUTH
      pose — isolates map quality from pose error.
  engine — after 3 frames, cross-check the fast engine's accepts
      against brute-force numpy NN for 800 sampled queries; classifies
      disagreements by range and label.
  roundtrip — component sanity at GT poses: fresh-map insert/pointcloud
      self-roundtrip, scan-to-scan overlap, live-voxel coverage of the
      source set (catches quantization/frame bugs in insert/pointcloud).

Env: MH_MODE, MH_WORLD (city|corridor, default city), MH_DENSITY (0.7),
MH_FRAMES (24), MH_PRESET (city).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import dataclasses

import jax
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

MODE = os.environ.get("MH_MODE", "onset")
N = int(os.environ.get("MH_FRAMES", "24"))
cfg = dataclasses.replace(
    pl.PRESETS[os.environ.get("MH_PRESET", "city")],
    quantized_scan_upload=True,
)
if os.environ.get("MH_WORLD", "city") == "city":
    world_pts, world_labs = synthetic.build_city_world(
        seed=0, size=420.0, density=float(os.environ.get("MH_DENSITY", "0.7"))
    )
else:
    world_pts, world_labs = synthetic.build_world(
        seed=0, length=260.0, density=float(os.environ.get("MH_DENSITY", "2"))
    )
gt = synthetic.make_trajectory(N + 1, step=1.0)
rng = np.random.default_rng(0)
scans = [synthetic.render_scan(world_pts, world_labs, gt[i], rng,
                               n_target=120000, max_range=100.0)
         for i in range(N + 1)]


def downsample(i, pose=None):
    """(source_w, sval, frame_ds_w, fval) for scan i at pose (default gt)."""
    pts = np.full((cfg.scan_capacity, 4), scan_ops.INVALID_COORD, np.float32)
    n = min(len(scans[i]), cfg.scan_capacity)
    pts[:n] = scans[i][:n, :4]
    pj = jnp.asarray(pts)
    valid = pj[:, 0] < 1e6
    cropped, cval = scan_ops.preprocess(
        pj, valid, cfg.max_range, cfg.min_range, cfg.label_max_range
    )
    (src, sval), (fds, fval) = pl.voxelize(cropped, cval, cfg)
    T = jnp.asarray(gt[i] if pose is None else pose, jnp.float32)
    return (
        np.asarray(geo.transform_points(T, src)), np.asarray(sval),
        np.asarray(geo.transform_points(T, fds)), np.asarray(fval),
    )


def engine_accepts(mapstate, src_w, sval, center):
    tables = cf.build_probe_tables(mapstate, center, cfg.probe_depth)
    tgt, acc = cf.get_correspondences_fast(
        mapstate, tables, jnp.asarray(src_w), jnp.asarray(sval),
        cfg.voxel_size_map, 0.6, cfg.sem_th, cfg.probe_depth,
        unique_voxel_rows=cfg.corr_unique_voxel_rows,
        queries_per_voxel=cfg.corr_queries_per_voxel,
        overflow_rows=cfg.corr_overflow_rows,
    )
    return np.asarray(acc)


def dup_keys(mapstate):
    live = np.asarray(mapstate.counts) > 0
    k = np.asarray(mapstate.keys)[live].astype(np.int64)
    if len(k) == 0:
        return 0, 0
    code = (k[:, 0] + 2**20) * (1 << 42) + (k[:, 1] + 2**20) * (1 << 21) + (
        k[:, 2] + 2**20
    )
    s = np.sort(code)
    return int(np.sum(s[1:] == s[:-1])), int(live.sum())


if MODE == "onset":
    odom = pl.SageICP(cfg)
    for i in range(N):
        odom.register_frame(scans[i])
        src_w, sval, _, _ = downsample(i + 1)
        center = scan_ops.trunc_div(
            jnp.asarray(gt[i + 1][:3, 3], jnp.float32), cfg.voxel_size_map)
        acc = engine_accepts(odom.state.map, src_w, sval, center)
        ndup, nlive = dup_keys(odom.state.map)
        tr = odom.trajectory()
        print(f"frame{i}: pose_t={np.round(tr[-1][:3, 3], 3)} "
              f"live={nlive} dup={ndup} "
              f"gt_match={int(acc[sval].sum())}/{int(sval.sum())}",
              flush=True)

elif MODE == "engine":
    odom = pl.SageICP(cfg)
    for i in range(3):
        odom.register_frame(scans[i])
    src_w, sval, _, _ = downsample(3)
    center = scan_ops.trunc_div(
        jnp.asarray(gt[3][:3, 3], jnp.float32), cfg.voxel_size_map)
    acc = engine_accepts(odom.state.map, src_w, sval, center)
    print(f"engine: {acc[sval].sum()}/{sval.sum()} accepted @0.6", flush=True)
    mp, mmask = hm.pointcloud(odom.state.map, cfg.voxel_size_map)
    mp = np.asarray(mp)[np.asarray(mmask)][:, :3]
    print(f"map points: {len(mp)}", flush=True)
    qidx = np.random.default_rng(1).choice(np.nonzero(sval)[0], 800)
    q = src_w[qidx, :3]
    d = np.sqrt(((q[:, None, :] - mp[None, :, :]) ** 2).sum(-1).min(1))
    close = d < 0.6
    eng = acc[qidx]
    print(f"brute force: {close.sum()}/800 have map NN within 0.6 "
          f"(median d={np.median(d):.3f})", flush=True)
    print(f"agreement: engine-acc&bf-close={np.sum(eng & close)}, "
          f"engine-rej&bf-close={np.sum(~eng & close)}, "
          f"engine-acc&bf-far={np.sum(eng & ~close)}", flush=True)
    bad = qidx[~eng & close]
    if len(bad):
        r = np.linalg.norm(src_w[bad, :3] - gt[3][:3, 3][None], axis=1)
        print(f"rejected-but-close range: median {np.median(r):.1f} m",
              flush=True)
        u, c = np.unique(src_w[bad, 3], return_counts=True)
        print("rejected-but-close labels:",
              dict(zip(u.tolist(), c.tolist())), flush=True)

elif MODE == "roundtrip":
    def nn_stats(q, ref, label, k=800):
        qs = q[np.random.default_rng(1).choice(
            len(q), min(k, len(q)), replace=False)]
        d = np.sqrt(((qs[:, None, :] - ref[None, :, :]) ** 2).sum(-1).min(1))
        print(f"{label}: median NN {np.median(d):.3f} m, "
              f"<0.3: {(d < 0.3).mean():.2%}, <0.6: {(d < 0.6).mean():.2%}",
              flush=True)

    src3, sval3, fds3, fval3 = downsample(3)
    src3 = src3[sval3][:, :3]
    fresh = hm.create(cfg.map_capacity, cfg.points_per_voxel, jnp.float32)
    fresh = hm.insert(
        fresh, jnp.asarray(fds3), jnp.asarray(fval3), cfg.voxel_size_map,
        cfg.basic_points_per_voxel, pl._basic_label_mask(cfg),
        max_incoming_per_voxel=cfg.max_incoming_per_voxel,
        probe_depth=cfg.probe_depth,
        unique_voxel_capacity=cfg.insert_unique_capacity,
        basic_labels=cfg.basic_parts_labels,
    )
    mp, mm = hm.pointcloud(fresh, cfg.voxel_size_map)
    mp = np.asarray(mp)[np.asarray(mm)][:, :3]
    print(f"fresh map: {len(mp)} points from {fval3.sum()} inserted",
          flush=True)
    nn_stats(fds3[fval3][:, :3], mp, "1. frame3 fds -> fresh map(frame3)")
    _, _, fds2, fval2 = downsample(2)
    nn_stats(src3, fds2[fval2][:, :3], "2. frame3 src -> frame2 fds")
    odom = pl.SageICP(cfg)
    for i in range(3):
        odom.register_frame(scans[i])
    mp3, mm3 = hm.pointcloud(odom.state.map, cfg.voxel_size_map)
    mp3 = np.asarray(mp3)[np.asarray(mm3)][:, :3]
    nn_stats(src3, mp3, "3a. frame3 src -> 3-frame map")
    vox = scan_ops.trunc_div(jnp.asarray(src3), cfg.voxel_size_map)
    slots = hm.lookup(odom.state.map, vox, cfg.probe_depth)
    print(f"3b. source voxels live in map: "
          f"{(np.asarray(slots) >= 0).mean():.2%}", flush=True)
    nn_stats(mp3, src3, "3c. map -> frame3 src (reverse)")
else:
    raise SystemExit(f"unknown MH_MODE={MODE}")
