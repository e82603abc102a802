"""Test configuration: the suite runs on the CPU backend with 8 virtual
devices, so sharding tests run on a virtual mesh and Pallas kernels run
in the interpreter. Tests marked `gpu` need a card: they skip here (the
`kernel_mode` fixture decides) and run with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`; the card-level
checks at production widths are the phases of chip_smoke.py.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from sage_icp_tpu.ops import routing  # noqa: E402
from sage_icp_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache(min_compile_secs=0.1)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def kernel_mode(request):
    """A routing mode for kernel-vs-XLA tests (parametrize indirectly):
    INTERPRET runs the Pallas kernel in the interpreter on any backend;
    COMPILED needs a GPU and skips elsewhere."""
    mode = request.param
    if mode == routing.COMPILED and jax.default_backend() != "gpu":
        pytest.skip("compiled Pallas kernels need a GPU; this backend runs "
                    "them in the interpreter (chip_smoke.py checks them "
                    "on the card)")
    return mode


# parametrize list for the kernel_mode fixture
KERNEL_MODES = [
    routing.INTERPRET,
    pytest.param(routing.COMPILED, marks=pytest.mark.gpu),
]
