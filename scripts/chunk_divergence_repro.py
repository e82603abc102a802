"""Bisect the chunked-step NaN: run frames 10..39 per-frame (known good),
then replay the same frames through chunked steps of width W for several W,
printing every per-frame pose so the first diverging frame is visible.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import dataclasses

import numpy as np

from sage_icp_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()
from sage_icp_tpu.models import pipeline as pl
from sage_icp_tpu.utils import synthetic

W = int(os.environ.get("REPRO_W", "2"))
n_pre, n_test = 10, 30
cfg = dataclasses.replace(pl.PRESETS["synthetic"], quantized_scan_upload=True)
world_pts, world_labs = synthetic.build_world(seed=0, length=260.0, density=2.0)
gt = synthetic.make_trajectory(n_pre + n_test, step=1.0)
rng = np.random.default_rng(0)
scans = [synthetic.render_scan(world_pts, world_labs, gt[i], rng,
                               n_target=120000, max_range=100.0)
         for i in range(n_pre + n_test)]


def prefill(odom):
    for i in range(n_pre):
        odom.register_frame(scans[i])


print("=== per-frame reference ===", flush=True)
odom = pl.SageICP(cfg)
prefill(odom)
for i in range(n_pre, n_pre + n_test):
    odom.register_frame(scans[i])
tr = odom.trajectory()
it = odom.iteration_counts()
for i in range(n_pre, n_pre + n_test):
    print(f"frame{i}: t={np.round(tr[i][:3, 3], 3)} iters={it[i]}", flush=True)

print(f"=== chunked W={W} ===", flush=True)
odom = pl.SageICP(cfg)
prefill(odom)
for s in range(n_pre, n_pre + n_test, W):
    odom.register_chunk(odom.pad_chunk(scans[s:s + W]))
tr = odom.trajectory()
it = odom.iteration_counts()
for i in range(n_pre, n_pre + n_test):
    print(f"frame{i}: t={np.round(tr[i][:3, 3], 3)} iters={it[i]}", flush=True)
