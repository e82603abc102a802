"""Smoke test of the odometry system on NVIDIA GPUs.

    python chip_smoke.py               # one card: main path, kernels, CLI
    python chip_smoke.py --four-cards  # four cards: sharded step only

One card, in one process:
  1. device: JAX must see a GPU (anything else exits non-zero); prints
     the cards' name and power limit from nvidia-smi;
  2. main path: SageICP("kitti") — the production preset at full width
     (135,168-point scans, 262,144 map slots x 40 int16 points, 18,432
     correspondence rows x 1,080 candidate lanes, dynamic vehicle
     filter on) — on the KITTI-scale synthetic city world: warmup
     frames through register_frame, then chunks through register_chunk.
     Guards: ATE < 1 m against the rendered ground truth and every
     silent-drop counter zero, summed over all frames;
  3. kernels: each compiled Pallas kernel against the plain XLA
     formulation at kitti widths (parity, then both medians);
  4. CLI: sage_icp_tpu.runtime.cli.main in-process (a second JAX process
     would find the card's memory taken by this one).

Four cards: the sharded step (parallel.sharding.make_sharded_step, with
the row-sharded policy kernel under shard_map) on a 4-device mesh against
the unsharded step on one card, over a few kitti frames.

Any failed phase raises, so the script exits non-zero. The last line of
standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

KITTI_DENSITY = 1.3  # KITTI-scale point counts (bench.py)
N_POINTS = 120_000


def check_device(min_count: int = 1) -> dict:
    """The JAX device report, or SystemExit unless JAX runs on at least
    min_count GPUs. No CPU fallback."""
    from sage_icp_tpu.utils.device import require_gpu

    return require_gpu(min_count)


def _median_ms(fn, *args, reps: int = 15) -> float:
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def _scans(world, n, seed, n_points=N_POINTS):
    from sage_icp_tpu.utils import synthetic

    gt = synthetic.make_trajectory(n, step=1.0)
    rng = np.random.default_rng(seed)
    return gt, [
        synthetic.render_scan(world[0], world[1], gt[i], rng,
                              n_target=n_points, max_range=100.0)
        for i in range(n)
    ]


def main_path(card: str, preset: str = "kitti",
              density: float = KITTI_DENSITY, n_points: int = N_POINTS):
    """Phase 2; returns the SageICP instance (its map feeds phase 3) and
    the world."""
    import bench
    from sage_icp_tpu.models import pipeline as pl
    from sage_icp_tpu.utils import synthetic

    world = synthetic.build_city_world(seed=0, size=420.0, density=density)
    sps, nvox, ate, odom = bench.run_phase(
        pl.PRESETS[preset], world, n_warmup=5, n_frames=20,
        n_points=n_points, chunk=10, label=preset,
    )
    n = len(odom.trajectory())
    print(f"main path ({preset} preset, {n} frames, {card}): ATE {ate} m, "
          f"map voxels {nvox}, {sps} scans/s over 2 chunks of 10")
    return odom, world


def kernels(odom, world, card: str, n_points: int = N_POINTS):
    """Phase 3: every compiled kernel vs the plain XLA formulation."""
    import jax
    import jax.numpy as jnp

    from sage_icp_tpu.models import pipeline as pl
    from sage_icp_tpu.ops import correspondence_fast as cf
    from sage_icp_tpu.ops import geometry as geo
    from sage_icp_tpu.ops import hashmap as hm
    from sage_icp_tpu.ops import pallas_nn as pnn
    from sage_icp_tpu.ops import registration as reg
    from sage_icp_tpu.ops import routing

    cfg = odom.config
    state = odom.state
    _, (scan,) = _scans(world, 1, seed=1, n_points=n_points)
    buf = jnp.asarray(odom.pad_chunk([scan])[0])
    pts, valid, ts = pl._split_packed(buf)
    prep = jax.jit(pl.prepare_icp_inputs, static_argnames="config")(
        state, pts, valid, ts, config=cfg
    )
    guess = prep["initial_guess"]

    # --- GN iteration: fused kernel vs corr_apply + normal equations ----
    fast = dict(unique_voxel_rows=cfg.corr_unique_voxel_rows,
                queries_per_voxel=cfg.corr_queries_per_voxel,
                overflow_rows=cfg.corr_overflow_rows)
    setup = jax.jit(
        cf.corr_setup,
        static_argnames=("probe_depth", *fast),
    )(state.map, prep["tables"], geo.transform_points(guess, prep["source"]),
      prep["source_valid"], cfg.voxel_size_map, probe_depth=cfg.probe_depth,
      **fast)
    R, M = setup.cxp.shape
    K = cfg.points_per_voxel
    v = cfg.voxel_size_map
    offs = jnp.repeat(hm._NEIGHBOR_OFFSETS, K, axis=0).astype(jnp.float32) * v
    # a pose increment of a few cm / mrad: movers and real residuals
    T = geo.se3_exp(jnp.asarray([0.03, -0.02, 0.01, 0.002, -0.001, 0.003],
                                jnp.float32))
    max_corr, kth, sem_th = 3.0 * 0.5, 0.5 / 3.0, cfg.sem_th

    @jax.jit
    def gn_kernel(setup, T):
        return pnn.fused_gn_iteration(
            setup.cxp, setup.cyp, setup.czp, setup.clp,
            offs[:, 0], offs[:, 1], offs[:, 2], setup.q0.reshape(R, -1),
            setup.row_origin_abs, setup.row_rel + setup.center[None, :],
            setup.grid_used.astype(jnp.int32), T, sem_th, v / hm.QSCALE, v,
            max_corr, kth,
        )

    @jax.jit
    def gn_xla(setup, T):  # the CPU route's GN body, for timing
        src, tgt, acc = cf.corr_apply(setup, T, v, max_corr, sem_th)
        JTJ, JTr = reg.build_normal_equations(
            src.reshape(-1, 4), tgt.reshape(-1, 4), acc.reshape(-1), kth
        )
        return JTJ, JTr, jnp.sum(acc, dtype=jnp.int32)

    @jax.jit
    def gn_xla_sums(setup, T):
        """The kernel's first 17 sums from the XLA correspondences, and
        the same sums over |term| (the scale of their rounding error)."""
        src, tgt, acc = cf.corr_apply(setup, T, v, max_corr, sem_th)
        s = src[..., :3].reshape(-1, 3)
        r = s - tgt[..., :3].reshape(-1, 3)
        r2 = jnp.sum(r * r, axis=-1)
        w = jnp.where(acc.reshape(-1), kth * kth / jnp.square(kth + r2), 0)
        sx, sy, sz = s.T
        rx, ry, rz = r.T
        terms = jnp.stack([
            w, w * sx, w * sy, w * sz, w * sx * sx, w * sy * sy,
            w * sz * sz, w * sx * sy, w * sx * sz, w * sy * sz,
            w * rx, w * ry, w * rz, w * (sy * rz - sz * ry),
            w * (sz * rx - sx * rz), w * (sx * ry - sy * rx),
            acc.reshape(-1).astype(jnp.float32),
        ])
        return jnp.sum(terms, axis=1), jnp.sum(jnp.abs(terms), axis=1)

    ks = np.asarray(gn_kernel(setup, T))[:17]
    xs, xabs = (np.asarray(a) for a in gn_xla_sums(setup, T))
    # Tolerance from the summation order: each sum adds ~3.7e4 f32
    # terms, block-sequential then tree in the kernel, tree in XLA; both
    # errors are below (64 + log2 n) * 2^-24 ~ 5e-6 of the sum of
    # |terms|. 1e-4 of that sum also covers the few winners that may
    # flip on exact near-ties where the two compilers contract into FMAs
    # differently (the accepted count is held to 0.1%).
    err = np.abs(ks[:16] - xs[:16])
    tol = 1e-4 * xabs[:16]
    print(f"gn parity (R={R}, M={M}): ncorr kernel {int(ks[16])} xla "
          f"{int(xs[16])}, max |sum error| / sum|terms| "
          f"{float(np.max(err / np.maximum(xabs[:16], 1e-30)))} (tol 1e-4)")
    assert abs(ks[16] - xs[16]) <= max(2, xs[16] // 1000), (ks[16], xs[16])
    assert np.all(err <= tol), (err, tol)
    t_k = _median_ms(gn_kernel, setup, T)
    t_x = _median_ms(gn_xla, setup, T)
    print(f"gn iteration on {card}: kernel {t_k} ms, xla {t_x} ms "
          "(median of 15)")

    # --- retention policy: kernel vs XLA while_loop, on the real map ----
    world_frame = geo.transform_points(guess, prep["frame_ds"])

    def insert(mode):
        return jax.jit(lambda m, p, ok: hm.insert(
            m, p, ok, cfg.voxel_size_map, cfg.basic_points_per_voxel,
            pl._basic_label_mask(cfg),
            max_incoming_per_voxel=cfg.max_incoming_per_voxel,
            probe_depth=cfg.probe_depth,
            unique_voxel_capacity=min(cfg.insert_unique_capacity,
                                      cfg.frame_capacity),
            tables=prep["tables"], basic_labels=cfg.basic_parts_labels,
            with_stats=True, kernel_mode=mode,
        ))

    ins_k, ins_x = insert(routing.COMPILED), insert(routing.XLA)
    args = (state.map, world_frame, prep["frame_valid"])
    (mk, sk), (mx, sx) = ins_k(*args), ins_x(*args)
    for name in ("keys", "counts", "points", "first_pts"):
        a, b = np.asarray(getattr(mk, name)), np.asarray(getattr(mx, name))
        assert np.array_equal(a, b), f"policy kernel: {name} differ"
    assert all(int(a) == int(b) for a, b in zip(sk, sx))
    print(f"policy parity: bit-identical keys/counts/points/first_pts "
          f"over {int(np.asarray(mk.counts > 0).sum())} live voxels")
    t_k = _median_ms(ins_k, *args)
    t_x = _median_ms(ins_x, *args)
    print(f"map insert on {card}: kernel {t_k} ms, xla {t_x} ms "
          "(median of 15)")


def cli_drive():
    """Phase 4: the CLI in-process on the synthetic city world."""
    from sage_icp_tpu.runtime import cli

    with tempfile.TemporaryDirectory() as out:
        cli.main(["--synthetic", "--frames", "8", "--preset", "city",
                  "--out", out])
        with open(os.path.join(out, "metrics.json")) as f:
            ate = json.load(f)["synthetic"]["ate_trans_m"]
        assert os.path.exists(os.path.join(out, "synthetic", "path.txt"))
    # the CPU drive of the same command meets 12.81 mm; the card may
    # differ by summation order only
    assert ate < 0.0135, f"CLI drive ATE {ate} m"
    print(f"cli: 8 city frames, ATE {ate} m")


def four_cards(card: str, preset: str = "kitti",
               density: float = KITTI_DENSITY, n_points: int = N_POINTS):
    """The sharded step on 4 cards vs the unsharded step on one."""
    import jax

    from sage_icp_tpu.models import pipeline as pl
    from sage_icp_tpu.parallel import sharding
    from sage_icp_tpu.utils import synthetic

    mesh = sharding.make_mesh(jax.devices()[:4])
    sharded = sharding.ShardedSageICP(preset, mesh)
    single = pl.SageICP(sharded.config)  # same padded capacities
    world = synthetic.build_city_world(seed=0, size=420.0, density=density)
    _, scans = _scans(world, 6, seed=0, n_points=n_points)
    t0 = time.perf_counter()
    for s in scans:
        sharded.register_frame(s)
    t1 = time.perf_counter()
    for s in scans:
        single.register_frame(s)
    t2 = time.perf_counter()
    a, b = sharded.trajectory(), single.trajectory()
    for name, od in (("sharded", sharded), ("single", single)):
        assert int(od.aux_totals().overflow_total()) == 0, name
    diff = float(np.max(np.abs(a - b)))
    print(f"four cards ({card}): {len(scans)} {preset} frames, max |pose "
          f"difference| sharded vs one card {diff} (tol 1e-3); wall incl. "
          f"compile {t1 - t0} s sharded, {t2 - t1} s one card")
    # NCCL reductions add in another order than one card: the solves
    # agree to the 1e-4 GN stopping threshold per frame, not bitwise
    assert diff < 1e-3, diff


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded step on four cards")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    device = check_device(n_cards)

    from sage_icp_tpu.utils.compile_cache import configure_compile_cache
    from sage_icp_tpu.utils.device import card_line

    configure_compile_cache()
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    if args.four_cards:
        four_cards(card.splitlines()[0])
    else:
        odom, world = main_path(card)
        kernels(odom, world, card)
        del odom
        cli_drive()
    print(f"phases done in {time.perf_counter() - t0} s", file=sys.stderr)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
