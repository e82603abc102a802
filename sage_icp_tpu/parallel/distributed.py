"""Multi-host initialization, import-light on purpose.

`jax.distributed.initialize` must run BEFORE anything initializes the
XLA backend — and importing the main package does (module-level
`jnp.array` constants, e.g. the 27-neighborhood offsets). This module
imports only `jax`, so a worker process can

    from sage_icp_tpu.parallel.distributed import init_distributed
    mesh = init_distributed(...)          # BEFORE heavy imports
    from sage_icp_tpu.parallel import sharding as sh   # now safe

`parallel.sharding` re-exports it for single-process callers (where the
ordering doesn't matter).
"""

from __future__ import annotations


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
):
    """Multi-host entry point: initialize jax.distributed (DCN
    rendezvous) and return a mesh over ALL devices in the job — the
    sharded step then runs unchanged, with point-axis collectives inside
    a host over its device links and across hosts over the network.
    Pass coordinator_address ("host:port"), num_processes and process_id
    explicitly unless the cluster environment provides them. On CPU test
    rigs the gloo collectives backend is selected automatically.

    This replaces the reference's only 'distributed' mechanism —
    ROS2/DDS pub-sub between single-host processes (SURVEY.md section
    2.4) — with a true SPMD data plane."""
    import jax

    # select cross-process collectives for a CPU backend (gloo); the
    # option is inert on GPUs — and NOTHING here may query devices, which
    # would initialize the backend prematurely
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass  # older jax: collectives come built in
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)

    import numpy as np
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), ("points",))
