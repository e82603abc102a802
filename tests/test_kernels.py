"""Kernel routing, the plain XLA formulations that replace kernels on the
CPU, the per-block GN partials, and the helpers every entry point shares
(compile cache, device check)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import KERNEL_MODES
from sage_icp_tpu.ops import correspondence_fast as cf
from sage_icp_tpu.ops import dynamic_filter as dyn
from sage_icp_tpu.ops import geometry as geo
from sage_icp_tpu.ops import hashmap as hm
from sage_icp_tpu.ops import pallas_nn as pnn
from sage_icp_tpu.ops import registration as reg
from sage_icp_tpu.ops import routing
from sage_icp_tpu.utils import compile_cache


# ---------------------------------------------------------------- routing


@pytest.mark.parametrize(
    "backend,expected",
    [("cpu", routing.XLA), ("gpu", routing.COMPILED), ("neuron", None),
     ("METAL", None)],
)
def test_routing_rule(monkeypatch, backend, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if expected is None:
        with pytest.raises(RuntimeError, match="no kernel route"):
            routing.kernel_mode()
        with pytest.raises(RuntimeError):
            routing.resolve(None)
    else:
        assert routing.kernel_mode() == expected
        assert routing.resolve(None) == expected
    # an explicit mode never consults the backend
    assert routing.resolve(routing.INTERPRET) == routing.INTERPRET


def test_routing_rejects_unknown_mode():
    with pytest.raises(ValueError):
        routing.resolve("off")


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_insert_traces_the_routed_policy(monkeypatch, backend):
    """On 'gpu' the map insert traces the compiled (non-interpreted)
    policy kernel; on 'cpu' it traces no kernel at all."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    pts = jnp.zeros((64, 4), jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda p: hm.insert(hm.create(256, 8), p, jnp.ones(64, bool), 1.0,
                            4, jnp.zeros(260, bool),
                            unique_voxel_capacity=64)
    )(pts)
    text = str(jaxpr)
    if backend == "gpu":
        assert "pallas_call" in text
        assert "interpret=False" in text
    else:
        assert "pallas_call" not in text


# ----------------------------------------------------------- radius count


def _brute_force_counts(c, q, used, r2):
    R, M = c.shape[1:]
    qq = q.reshape(R, -1, 3).astype(np.float64)
    cc = c.transpose(1, 2, 0).astype(np.float64)  # (R, M, 3)
    d2 = ((cc[:, None, :, :] - qq[:, :, None, :]) ** 2).sum(-1)
    return ((d2 <= r2).sum(-1) * used).astype(np.float32)


def _radius_inputs(rng, R, P, M, p_used, p_invalid):
    # 1/64 m grid: every squared distance is exact in f32
    grid = lambda a: (np.round(a * 64.0) / 64.0).astype(np.float32)
    c = grid(rng.uniform(-0.75, 0.75, (3, R, M)))
    c[:, rng.random((R, M)) < p_invalid] = 1.0e9  # invalid lanes
    q = grid(rng.uniform(-0.25, 0.25, (R, 3 * P)))
    used = (rng.random((R, P)) < p_used).astype(np.int32)
    return c, q, used


@pytest.mark.parametrize(
    "p_used,p_invalid",
    [(0.5, 0.0), (1.0, 0.6), (0.0, 0.3), (0.7, 0.4)],
    ids=["unused_slots", "invalid_lanes", "all_unused", "filter_width"],
)
def test_radius_count_matches_brute_force(rng, p_used, p_invalid):
    """The dynamic filter's radius count (plain XLA on every backend)
    against a float64 brute force, at the filter's query width P = 48."""
    R, P, M = 24, 48, 27 * 4
    c, q, used = _radius_inputs(rng, R, P, M, p_used, p_invalid)
    r2 = dyn.SEARCH_RADIUS ** 2
    got = np.asarray(dyn.radius_count(*map(jnp.asarray, c), jnp.asarray(q),
                                      jnp.asarray(used), r2))
    np.testing.assert_array_equal(got, _brute_force_counts(c, q, used, r2))


# ------------------------------------------------------------ GN partials


def _gn_fixture(rng, unique_rows, overflow_rows):
    """A filled map, a displaced copy of its points as ICP source, and
    the frozen correspondence structure for it."""
    world = rng.uniform(-6.0, 6.0, (700, 3)).astype(np.float32)
    labels = rng.choice([0, 40, 50, 70], size=(700, 1)).astype(np.float32)
    world = np.concatenate([world, labels], axis=1)
    state = hm.insert(hm.create(4096, 8), jnp.asarray(world),
                      jnp.ones(len(world), bool), 1.0, 8,
                      jnp.zeros(260, bool))
    src = world[::3].copy()
    src[:, :3] += 0.05
    center = jnp.zeros(3, jnp.int32)
    tables = cf.build_probe_tables(state, center, 16)
    setup = cf.corr_setup(
        state, tables, jnp.asarray(src), jnp.ones(len(src), bool), 1.0, 16,
        unique_voxel_rows=unique_rows, queries_per_voxel=2,
        overflow_rows=overflow_rows,
    )
    return setup


def test_gn_partials_match_xla_normal_equations(rng):
    """Per-block partials of the GN kernel (interpreter) sum to the XLA
    normal equations, and the trailing dead blocks of an oversized grid
    write zero rows."""
    setup = _gn_fixture(rng, unique_rows=448, overflow_rows=64)
    R, M = setup.cxp.shape
    K = M // 27
    T = geo.se3_exp(jnp.asarray([0.02, -0.01, 0.01, 0.004, -0.002, 0.003],
                                jnp.float32))
    offs = jnp.repeat(hm._NEIGHBOR_OFFSETS, K, axis=0).astype(jnp.float32)
    max_corr, kth, sem_th = 0.9, 0.3, 0.5
    parts = np.asarray(pnn.gn_partials(
        setup.cxp, setup.cyp, setup.czp, setup.clp,
        offs[:, 0], offs[:, 1], offs[:, 2], setup.q0.reshape(R, -1),
        setup.row_origin_abs, setup.row_rel + setup.center[None, :],
        setup.grid_used.astype(jnp.int32), T, sem_th, 1.0 / hm.QSCALE, 1.0,
        max_corr, kth, interpret=True,
    ))
    n_blocks = R // pnn.ROWS_PER_BLOCK
    assert parts.shape == (n_blocks, pnn.SUMS_WIDTH)
    live = np.asarray(setup.grid_used).reshape(n_blocks, -1).any(axis=1)
    assert not live[-1], "fixture must leave trailing dead blocks"
    assert (parts[~live] == 0).all()
    assert (parts[:, pnn.N_SUMS:] == 0).all()

    JTJ, JTr, ncorr, _ = pnn.assemble_normal_equations(
        jnp.asarray(parts[:, :pnn.N_SUMS].sum(axis=0))
    )
    src, tgt, acc = cf.corr_apply(setup, T, 1.0, max_corr, sem_th)
    xJ, xr = reg.build_normal_equations(
        src.reshape(-1, 4), tgt.reshape(-1, 4), acc.reshape(-1), kth
    )
    assert int(ncorr) == int(np.asarray(acc).sum()) > 100
    np.testing.assert_allclose(np.asarray(JTJ), np.asarray(xJ),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(JTr), np.asarray(xr),
                               rtol=1e-4, atol=1e-3)


# ------------------------------------------------- shared entry helpers


def test_compile_cache_uses_env_dir_and_sets_nothing(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_defaults_to_fixed_checkout_dir(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.configure_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in calls
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_chip_smoke_refuses_cpu():
    import chip_smoke

    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as exc:
        chip_smoke.check_device()
    assert exc.value.code not in (0, None)
