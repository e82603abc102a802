"""End-to-end A/B of each hand-written kernel against its plain XLA
formulation, inside the jitted kitti-preset step on one GPU.

    python scripts/kernel_ab.py [--chunks 4] [--chunk 10]

Every variant compiles the chunked step anew with some kernel call sites
forced onto the XLA route (the module function the step calls is
wrapped with kernel_mode="xla" while that variant is traced), then
registers the same KITTI-scale synthetic frames: one warm chunk
(compile + map fill), then the timed chunks. The first variant is
repeated last to show the drift between runs. Prints, per variant,
scans/s over the timed chunks, the compile-chunk wall and the ATE.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# kernel -> the call site the step reaches it through: (module, function)
SITES = {
    "gn": ("registration", "register_frame"),
    "policy": ("hashmap", "insert"),
}


def xla_patches(*kernels):
    """(module, name, replacement) triples forcing kernels onto XLA."""
    out = []
    for k in kernels:
        mod = importlib.import_module(f"sage_icp_tpu.ops.{SITES[k][0]}")
        fn = getattr(mod, SITES[k][1])
        out.append((mod, SITES[k][1],
                    functools.partial(fn, kernel_mode="xla")))
    return out


VARIANTS = [
    ("kernels", ()),
    ("gn_xla", ("gn",)),
    ("policy_xla", ("policy",)),
    ("all_xla", ("gn", "policy")),
    ("kernels", ()),
]


def make_frames(chunks: int, chunk: int):
    """KITTI-scale synthetic frames, padded per chunk, and their GT."""
    from sage_icp_tpu.models import pipeline as pl
    from sage_icp_tpu.utils import synthetic

    world = synthetic.build_city_world(seed=0, size=420.0, density=1.3)
    n = (chunks + 1) * chunk
    gt = synthetic.make_trajectory(n, step=1.0)
    rng = np.random.default_rng(0)
    scans = [synthetic.render_scan(world[0], world[1], gt[i], rng,
                                   n_target=120_000, max_range=100.0)
             for i in range(n)]
    pad = pl.SageICP("kitti").pad_chunk
    return [pad(scans[i:i + chunk]) for i in range(0, n, chunk)], gt


def run_variant(padded, gt, patches):
    """scans/s over padded[1:], first-chunk wall (s), ATE (m), with each
    (module, name, replacement) patch applied while the step is traced
    and run."""
    import jax

    from sage_icp_tpu.models import pipeline as pl

    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        odom = pl.SageICP("kitti")
        t0 = time.perf_counter()
        odom.register_chunk(padded[0])  # compile + map fill
        odom.trajectory()
        t1 = time.perf_counter()
        for p in padded[1:]:
            odom.register_chunk(p)
        # sync on the device poses: trajectory()'s eager concatenate of a
        # new entry count would compile inside the timed window
        jax.block_until_ready(odom.poses)
        t2 = time.perf_counter()
        est = odom.trajectory()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    assert int(odom.aux_totals().overflow_total()) == 0, (
        "silent-drop counters nonzero"
    )
    g0 = np.linalg.inv(gt[0])
    errs = [np.linalg.norm(e[:3, 3] - (g0 @ g)[:3, 3])
            for e, g in zip(est, gt)]
    ate = float(np.sqrt(np.mean(np.square(errs))))
    assert ate < 1.0, f"ATE {ate} m: the run did not track"
    n_timed = sum(len(p) for p in padded[1:])
    return n_timed / (t2 - t1), t1 - t0, ate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", type=int, default=4, help="timed chunks")
    ap.add_argument("--chunk", type=int, default=10)
    args = ap.parse_args(argv)

    from sage_icp_tpu.utils.compile_cache import configure_compile_cache
    from sage_icp_tpu.utils.device import card_line, require_gpu

    dev = require_gpu()
    card = card_line()
    print(f"device: {dev}; card: {card}", flush=True)
    configure_compile_cache()
    padded, gt = make_frames(args.chunks, args.chunk)
    for name, kernels in VARIANTS:
        sps, first_s, ate = run_variant(padded, gt, xla_patches(*kernels))
        print(f"{name}: {sps} scans/s over {args.chunks} chunks of "
              f"{args.chunk} kitti frames, first-chunk wall {first_s} s, "
              f"ATE {ate} m ({card})", flush=True)


if __name__ == "__main__":
    main()
