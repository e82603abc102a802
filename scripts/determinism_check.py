"""Is the odometry step deterministic? Two SageICP instances in one
process get the exact same 21 scans; their per-frame sigma / iters /
ncorr / pose traces must match bit-for-bit. A mismatch means the step
reads state it should not (donated/uninitialized buffers, stale cache).
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

N = int(os.environ.get("DET_FRAMES", "21"))
if os.environ.get("DET_PRESET", "kitti") == "small":
    cfg = pl.SageConfig(
        scan_capacity=16384, frame_capacity=16384, source_capacity=4096,
        map_capacity=32768, max_icp_iterations=100,
        dynamic_vehicle_filter=False, min_range=1.0,
        corr_unique_voxel_rows=4096, corr_overflow_rows=512,
        insert_unique_capacity=4096,
    )
    n_target = 9000
else:
    cfg = pl.PRESETS["kitti"]
    n_target = 120000
cfg = dataclasses.replace(
    cfg,
    quantized_scan_upload=os.environ.get("DET_QUPLOAD", "1") == "1",
)
if "DET_FILTER" in os.environ:
    cfg = dataclasses.replace(
        cfg, dynamic_vehicle_filter=os.environ["DET_FILTER"] == "1"
    )
world_pts, world_labs = synthetic.build_city_world(seed=0, size=420.0,
                                                   density=2.0)
gt = synthetic.make_trajectory(N, step=1.0)
rng = np.random.default_rng(0)
scans = [synthetic.render_scan(world_pts, world_labs, gt[i], rng,
                               n_target=n_target, max_range=100.0)
         for i in range(N)]


def run(tag):
    odom = pl.SageICP(cfg)
    out = []
    for i in range(N):
        odom.register_frame(scans[i])
        a = odom.last_aux
        st = odom.state
        first = np.asarray(st.first_pose)
        last = np.asarray(st.last_pose)
        motion = np.linalg.norm(
            (np.linalg.inv(first) @ last)[:3, 3]
        )
        out.append((float(a.sigma), int(a.icp_iterations),
                    int(a.num_correspondences), int(a.nonfinite_pose),
                    float(st.threshold.sse), int(st.threshold.num_samples),
                    float(np.linalg.norm(
                        np.asarray(st.threshold.model_deviation)[:3, 3])),
                    motion, int(st.num_poses), first[:3, 3].round(3)))
    tr = np.asarray(odom.trajectory())
    for i in range(N):
        o = out[i]
        print(f"[{tag}] f{i}: sigma={o[0]:.6f} iters={o[1]} "
              f"ncorr={o[2]} nonfin={o[3]} sse={o[4]:.5f} n={o[5]} "
              f"dev_t={o[6]:.4f} motion={o[7]:.3f} np={o[8]} "
              f"first={o[9]} t={tr[i][:3, 3].round(5)}", flush=True)
    return out, tr


o1, t1 = run("A")
o2, t2 = run("B")
same = all(a == b for a, b in zip(o1, o2)) and np.array_equal(t1, t2)
print("DETERMINISTIC" if same else "NONDETERMINISTIC", flush=True)
if not same:
    for i, (a, b) in enumerate(zip(o1, o2)):
        if a != b or not np.array_equal(t1[i], t2[i]):
            print(f"first divergence at frame {i}: {a} vs {b}", flush=True)
            break
