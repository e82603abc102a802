"""Kernel routing: the one place that decides which implementation of a
hot operation runs.

The rule, for every operation that has a hand-written kernel:

  * on a GPU backend: the compiled Pallas kernel (Triton route);
  * on the CPU backend: the plain XLA formulation;
  * on any other backend: an error — there is no kernel for it and the
    program must not quietly fall into the Pallas interpreter.

Call sites accept an explicit mode so tests can run a kernel in the
Pallas interpreter on the CPU (``INTERPRET``); production code always
passes ``None`` and lets :func:`kernel_mode` decide.
"""

from __future__ import annotations

import jax

XLA = "xla"  # plain jax.numpy / lax formulation
COMPILED = "compiled"  # Pallas kernel compiled for the GPU
INTERPRET = "interpret"  # Pallas kernel in the interpreter (tests only)
MODES = (XLA, COMPILED, INTERPRET)


def kernel_mode() -> str:
    """Route for the current default backend: COMPILED on 'gpu', XLA on
    'cpu'; anything else raises."""
    backend = jax.default_backend()
    if backend == "gpu":
        return COMPILED
    if backend == "cpu":
        return XLA
    raise RuntimeError(
        f"no kernel route for JAX backend {backend!r}: this program runs "
        "its kernels on 'gpu' and its plain XLA path on 'cpu'"
    )


def resolve(mode: str | None) -> str:
    """An explicit mode, or the backend's route when None."""
    if mode is None:
        return kernel_mode()
    if mode not in MODES:
        raise ValueError(f"unknown kernel mode {mode!r}; expected {MODES}")
    return mode
