"""Which device a measurement ran on.

Every speed number this repository prints names its device, and a
measurement path that finds no GPU fails instead of falling back to the
CPU (a CPU time says nothing about the card).
"""

from __future__ import annotations

import subprocess

import jax


def device_report() -> dict:
    """Platform, kind and count of the devices JAX uses, as JAX reports
    them."""
    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def require_gpu(min_count: int = 1) -> dict:
    """device_report(), or SystemExit (non-zero) unless JAX sees at least
    min_count GPUs."""
    rep = device_report()
    if rep["platform"] != "gpu" or rep["count"] < min_count:
        raise SystemExit(
            f"need {min_count} GPU device(s); JAX found {rep['count']} "
            f"{rep['platform']!r} device(s) ({rep['kind']})"
        )
    return rep


def card_line() -> str:
    """The cards' name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
