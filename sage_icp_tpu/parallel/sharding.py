"""Multi-device execution: shard the per-point work across a device mesh.

The reference parallelizes with TBB inside one CPU process
(tbb::parallel_reduce over points, SURVEY.md section 2.4); the
accelerator equivalent is SPMD over a jax.sharding.Mesh:

  * the scan's point axis is sharded across the "points" mesh axis —
    preprocess, deskew, correspondence search, and Jacobian accumulation
    are all per-point and partition cleanly;
  * the local map is replicated; the 6x6 J^T W J / J^T W r contraction is
    a row-sharded matmul, so GSPMD inserts the cross-device psum
    automatically (the moral equivalent of the reference's parallel_reduce
    join at cpp/sage_icp/core/Registration.cpp:72-90);
  * the pose solve (6x6) is tiny and runs replicated on every device.

The mesh is 1-D: the cards of one host are joined all to all, so the
mesh follows the algorithm alone. Multi-host: initialize jax.distributed
outside, build the mesh over all devices; the same step function works
unchanged.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sage_icp_tpu.models import pipeline as pl
from sage_icp_tpu.ops.pallas_insert import ROWS_PER_BLOCK

POINTS_AXIS = "points"


def make_mesh(devices=None, n_devices: int | None = None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (POINTS_AXIS,))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_config_for_mesh(config: pl.SageConfig, mesh: Mesh) -> pl.SageConfig:
    """Capacities must divide evenly across the points axis. The insert's
    compact row axis is split across devices by the row-sharded policy
    phase (ops/hashmap.insert) and should fill whole kernel blocks on
    each (pallas_insert.ROWS_PER_BLOCK rows); the pipeline clips it to
    frame_capacity — so both round up to ROWS_PER_BLOCK * n."""
    n = mesh.shape[POINTS_AXIS]
    rows = ROWS_PER_BLOCK * n
    return pl.SageConfig(
        **{
            **{f.name: getattr(config, f.name) for f in
               __import__("dataclasses").fields(config)},
            "scan_capacity": _round_up(config.scan_capacity, n),
            "frame_capacity": _round_up(config.frame_capacity, rows),
            "source_capacity": _round_up(config.source_capacity, n),
            "insert_unique_capacity": _round_up(
                config.insert_unique_capacity, rows
            ),
        }
    )


def make_sharded_step(config: pl.SageConfig, mesh: Mesh, donate: bool = True,
                      shard_insert: bool = True):
    """Compiled SPMD step: scan arrays sharded over the points axis, map
    state replicated; GSPMD partitions the pipeline (psum for the 6x6
    normal equations, all-gathers around the global downsample sort).

    shard_insert=True (default) additionally row-shards the insert-policy
    phase — the block/incoming gathers and the Pallas retention kernel
    run on U/n rows per device instead of replicated (ops/hashmap.insert
    multi-device note). False keeps the whole map update replicated."""
    repl = NamedSharding(mesh, P())
    shard_pts = NamedSharding(mesh, P(POINTS_AXIS))

    state_sharding = jax.tree.map(lambda _: repl, pl.init_state(config))
    fn = partial(pl.odometry_step, config=config,
                 mesh=mesh if shard_insert else None)
    return jax.jit(
        fn,
        in_shardings=(
            state_sharding,
            NamedSharding(mesh, P(POINTS_AXIS, None)),  # points
            shard_pts,  # valid
            shard_pts,  # timestamps
        ),
        out_shardings=(state_sharding, repl, jax.tree.map(lambda _: repl,
                       pl.StepAux(*([None] * len(pl.StepAux._fields))))),
        donate_argnums=(0,) if donate else (),
    )


# Multi-host entry point lives in parallel/distributed.py (import-light:
# jax.distributed.initialize must run before anything initializes the
# XLA backend, and importing THIS module does — see that docstring).
# Re-exported here for single-process callers.
from sage_icp_tpu.parallel.distributed import init_distributed  # noqa: E402,F401


class ShardedSageICP(pl.SageICP):
    """SageICP wrapper whose step runs SPMD over a mesh."""

    def __init__(self, config: pl.SageConfig | str = "kitti", mesh: Mesh | None = None):
        if isinstance(config, str):
            config = pl.PRESETS[config]
        if mesh is None:
            mesh = make_mesh()
        config = pad_config_for_mesh(config, mesh)
        self.mesh = mesh
        super().__init__(config)
        # the sharded step takes the full (state, points, valid, ts)
        # signature; disable the single-upload packed fast path
        self._packed = False
        self._step = make_sharded_step(config, mesh)
