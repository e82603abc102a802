"""Worker process for the 2-process jax.distributed test
(tests/test_parallel.py::test_multihost_two_process_agreement).

Each process owns 2 virtual CPU devices; the 4-device mesh spans both
processes, so the sharded step's collectives (the downsample sort
exchanges, the 6x6 normal-equation psum, the insert-policy all-gather)
cross the process boundary — the CPU stand-in for the network between hosts
(SURVEY.md section 2.4: this replaces the reference's ROS2/DDS IPC with a
true SPMD data plane).

Usage: python scripts/multihost_worker.py <process_id> <num_processes> \
           <coordinator> <out_dir>
Writes poses_<pid>.npy (every process computes identical replicated
poses; both are written so the test can check cross-process agreement).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
coord = sys.argv[3]
out_dir = sys.argv[4]

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=2"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

# distributed init FIRST: importing the main package initializes the XLA
# backend (module-level jnp constants), after which initialize() refuses
from sage_icp_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()
from sage_icp_tpu.parallel.distributed import init_distributed

mesh = init_distributed(
    coordinator_address=coord, num_processes=nproc, process_id=pid
)

from sage_icp_tpu.parallel import sharding as sh  # noqa: E402

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from sage_icp_tpu.models import pipeline as pl
from sage_icp_tpu.utils import synthetic

assert jax.device_count() == 2 * nproc, jax.devices()

cfg = pl.SageConfig(
    scan_capacity=4096, frame_capacity=4096, source_capacity=1024,
    map_capacity=8192, max_icp_iterations=30,
    dynamic_vehicle_filter=False, min_range=1.0,
    corr_unique_voxel_rows=512, corr_overflow_rows=128,
    insert_unique_capacity=2048, max_incoming_per_voxel=16, probe_depth=8,
)
cfg = sh.pad_config_for_mesh(cfg, mesh)
step = sh.make_sharded_step(cfg, mesh, donate=False)

repl = NamedSharding(mesh, P())


def to_global(np_tree, shardings):
    """Identical host values on every process -> global arrays."""
    def one(x, s):
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, s, lambda idx: x[idx])

    return jax.tree.map(one, np_tree, shardings)


state = pl.init_state(cfg)
state = to_global(
    jax.tree.map(np.asarray, state), jax.tree.map(lambda _: repl, state)
)

pts_sh = NamedSharding(mesh, P(sh.POINTS_AXIS, None))
v_sh = NamedSharding(mesh, P(sh.POINTS_AXIS))

world = synthetic.build_world(seed=1, length=60.0)
gt = synthetic.make_trajectory(3, step=0.5)
rng = np.random.default_rng(0)
poses = []
for i in range(3):
    scan = synthetic.render_scan(*world, gt[i], rng, n_target=3000)
    cap = cfg.scan_capacity
    buf = np.full((cap, 4), 1.0e7, dtype=np.float32)
    buf[: len(scan)] = scan
    val = np.zeros((cap,), bool)
    val[: len(scan)] = True
    ts = np.zeros((cap,), np.float32)
    args = to_global(
        (buf, val, ts), (pts_sh, v_sh, v_sh)
    )
    state, pose, aux = step(state, *args)
    poses.append(np.asarray(pose))

np.save(os.path.join(out_dir, f"poses_{pid}.npy"), np.stack(poses))
print(f"worker {pid}: ok, final pose t={poses[-1][:3, 3].round(3)}")
