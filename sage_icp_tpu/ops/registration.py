"""Point-to-point ICP with Gauss-Newton steps and a Geman-McClure-style
robust kernel — an accelerator re-design of the reference's registration
core (cpp/sage_icp/core/Registration.cpp).

Reference semantics reproduced:
  * residual r = s - t, Jacobian J = [I | -hat(s)]  (Registration.cpp:62-70)
  * robust weight w = kernel^2 / (kernel + ||r||^2)^2  (Registration.cpp:79)
  * solve (J^T W J) x = -(J^T W r), pose increment = SE3::exp(x)
    (Registration.cpp:92-93)
  * loop <= 500 iterations, stop when ||log(exp(x))|| = ||x|| < 1e-4
    (Registration.cpp:96-97,137)
  * empty map => return the initial guess unchanged (Registration.cpp:119)

Device mapping: per-point 3x6 Jacobians are assembled as one (N*3, 6)
matrix so J^T W J / J^T W r reduce to two f32 matmuls; under a device
mesh the points axis is sharded and the 6x6/6 results are psum-ed.
The correspondence search + GN step live inside one lax.while_loop, so the
whole ICP solve is a single XLA computation with a data-dependent trip
count — no host round trips per iteration.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sage_icp_tpu.ops import geometry as geo
from sage_icp_tpu.ops import hashmap as hm
from sage_icp_tpu.ops import routing

MAX_ITERATIONS = 500  # reference Registration.cpp:96
ESTIMATION_THRESHOLD = 1e-4  # reference Registration.cpp:97


def build_normal_equations(
    src: jax.Array, tgt: jax.Array, weight_mask: jax.Array, kernel
) -> tuple[jax.Array, jax.Array]:
    """Assemble J^T W J (6x6) and J^T W r (6) over masked correspondences.

    src/tgt: (N, 4) (label lane ignored); weight_mask: (N,) bool.
    The robust weight w = kernel^2/(kernel + ||r||^2)^2 matches
    Registration.cpp:79; masked rows contribute zero.
    """
    s = src[:, :3]
    r = s - tgt[:, :3]  # residual (N, 3)
    r2 = jnp.sum(r * r, axis=-1)
    w = (kernel * kernel) / jnp.square(kernel + r2)
    w = jnp.where(weight_mask, w, 0.0)

    # J_i = [I | -hat(s_i)] : (3, 6). Rows of the stacked (N*3, 6) matrix:
    #   row (i,0) = [1, 0, 0,    0,  s_z, -s_y]
    #   row (i,1) = [0, 1, 0, -s_z,    0,  s_x]
    #   row (i,2) = [0, 0, 1,  s_y, -s_x,   0]
    n = s.shape[0]
    zeros = jnp.zeros((n,), dtype=s.dtype)
    ones = jnp.ones((n,), dtype=s.dtype)
    sx, sy, sz = s[:, 0], s[:, 1], s[:, 2]
    J = jnp.stack(
        [
            jnp.stack([ones, zeros, zeros, zeros, sz, -sy], axis=-1),
            jnp.stack([zeros, ones, zeros, -sz, zeros, sx], axis=-1),
            jnp.stack([zeros, zeros, ones, sy, -sx, zeros], axis=-1),
        ],
        axis=1,
    )  # (N, 3, 6)
    Jw = J * w[:, None, None]
    Jf = J.reshape(n * 3, 6)
    Jwf = Jw.reshape(n * 3, 6)
    rf = r.reshape(n * 3)
    # two f32 matmuls (precision pinned: no TF32 on GPUs)
    JTJ = jnp.matmul(Jwf.T, Jf, precision="highest")  # (6, 6)
    JTr = jnp.matmul(Jwf.T, rf[:, None], precision="highest")[:, 0]  # (6,)
    return JTJ, JTr


def solve_increment(JTJ: jax.Array, JTr: jax.Array) -> jax.Array:
    """Solve JTJ x = -JTr. A tiny Tikhonov term keeps the solve finite when
    there are no correspondences (JTJ = 0 -> x = 0 -> loop terminates,
    reproducing the reference's empty-map early return).

    The 6x6 SPD solve is a STATICALLY UNROLLED Cholesky: scalar ops that
    XLA fuses into one kernel. jax.scipy.linalg.solve lowers to a generic
    batched Cholesky + two triangular-solve kernels, three serial launches
    per ICP iteration for a 6x6 system."""
    A = JTJ + 1e-8 * jnp.eye(6, dtype=JTJ.dtype)
    b = -JTr
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = A[i, j] - sum((L[i][k] * L[j][k] for k in range(j)),
                              jnp.asarray(0.0, A.dtype))
            if i == j:
                L[i][i] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    y = []
    for i in range(6):
        y.append(
            (b[i] - sum((L[i][k] * y[k] for k in range(i)),
                        jnp.asarray(0.0, A.dtype))) / L[i][i]
        )
    x = [None] * 6
    for i in reversed(range(6)):
        x[i] = (
            y[i] - sum((L[k][i] * x[k] for k in range(i + 1, 6)),
                       jnp.asarray(0.0, A.dtype))
        ) / L[i][i]
    x = jnp.stack(x)
    # guard NaN/inf (singular geometry): a zero step terminates the loop
    x = jnp.where(jnp.all(jnp.isfinite(x)), x, jnp.zeros_like(x))
    # Increment-norm clamp (f32 constraint, docs/ARCHITECTURE.md): a
    # near-singular normal matrix with garbage correspondences can yield
    # |x| ~ 1e6+, and f32 se3_exp of such a twist is numerically NON-
    # orthonormal (trig argument reduction breaks down), after which the
    # composed pose is no longer a rigid transform and every downstream
    # guard reasons about garbage. 10 m / 10 rad is far beyond any
    # legitimate GN step (legitimate first steps are bounded by the
    # initial-guess error, ~1 m), so reference behavior is unchanged in
    # the entire sane regime; the reference's unclamped f64 LDLT
    # (Registration.cpp:92) tolerates this only because f64 trig holds
    # to ~1e15.
    n = jnp.linalg.norm(x)
    return jnp.where(n > 10.0, x * (10.0 / jnp.maximum(n, 1e-30)), x)


class IcpResult(NamedTuple):
    pose: jax.Array  # (4, 4) final estimate (world <- scan)
    iterations: jax.Array  # int32
    num_correspondences: jax.Array  # int32 at the last iteration
    dropped_queries: jax.Array  # int32 valid sources with no grid seat
    #   (fast engine row/overflow capacity; 0 on the reference-shaped path)


def register_frame(
    map_state: hm.MapState,
    frame: jax.Array,
    valid: jax.Array,
    initial_guess: jax.Array,
    voxel_size,
    max_correspondence_distance,
    kernel,
    sem_th,
    max_iterations: int = MAX_ITERATIONS,
    probe_depth: int = hm.DEFAULT_PROBE_DEPTH,
    fast_params: dict | None = None,
    tables=None,
    kernel_mode: str | None = None,
) -> IcpResult:
    """Frame-to-map ICP (reference Registration.cpp:113-141).

    frame: (N, 4) in the sensor frame; valid: (N,). Returns the new pose.
    When fast_params is given (dict with unique_voxel_rows /
    queries_per_voxel / overflow_rows), the voxel-grouped correspondence
    engine is used: probe tables are built once per solve (loop-invariant)
    from the map and the initial guess position — or reused from the
    caller when passed in (the pipeline shares one build per step between
    the ICP solve and the map insert).

    kernel_mode: ops/routing mode for the GN iteration (None = the
    backend's route: the fused kernel on a GPU, XLA on the CPU).
    """
    eye = jnp.eye(4, dtype=frame.dtype)

    if fast_params is not None:
        # --- anchored frozen-rows GN: the sort/probe/gather/relayout
        # structure is built from the CURRENT pose (the "anchor") and
        # rides the loop carry; each iteration runs the fused GN step
        # against those frozen rows. When the accumulated increment
        # drifts beyond a fraction of a voxel from the anchor — where the
        # +-1-voxel mover shell starts losing correspondences — the body
        # re-anchors under lax.cond: rebuilds the correspondence
        # structure at the new pose and continues. The
        # reference re-searches every iteration (Registration.cpp:127-138);
        # this is the same semantics amortized: one setup per anchor, with
        # the common case (guess within a few cm, increments millimetric
        # after iteration 1) paying for exactly one setup, and hard cases
        # (sharp turns, deskew-scale corrections of a meter-plus) paying
        # one setup per ~voxel of correction instead of diverging. Round-3
        # lesson: without re-anchoring, any correction larger than the
        # mover shell silently truncated the constraint set and sharp
        # maneuvers diverged (tests/test_robustness.py maneuver suite).
        from sage_icp_tpu.ops import correspondence_fast as cf
        from sage_icp_tpu.ops.scan import trunc_div

        if tables is None:
            center = trunc_div(initial_guess[:3, 3], voxel_size)
            tables = cf.build_probe_tables(map_state, center, probe_depth)
        mode = routing.resolve(kernel_mode)
        R = fast_params["unique_voxel_rows"] + fast_params["overflow_rows"]
        fused = mode != routing.XLA
        # drift at which the inner loop yields back to the outer loop:
        # conservative half of the 1-voxel mover shell, measured as the
        # displacement of the anchor position plus the small-angle arc of
        # the scan radius under the accumulated rotation
        drift_lim = jnp.asarray(0.45 * voxel_size, frame.dtype)
        r2 = jnp.sum(frame[:, :3] * frame[:, :3], axis=-1)
        r_scan = jnp.sqrt(jnp.max(jnp.where(valid, r2, 0.0)))

        if fused:
            from sage_icp_tpu.ops import hashmap as hm_
            from sage_icp_tpu.ops import pallas_nn as pnn

            K = map_state.points_per_voxel
            offs = (
                jnp.repeat(hm_._NEIGHBOR_OFFSETS, K, axis=0).astype(
                    frame.dtype
                )
                * voxel_size
            )
            scale = voxel_size / hm_.QSCALE

        def anchor_drift(T_icp, anchor_pos):
            # displacement of the vehicle position + rotation arc at the
            # scan radius (T_icp acts in world frame, rotation about the
            # world origin — measure its effect at the anchor, not at 0)
            moved = (
                jnp.matmul(T_icp[:3, :3], anchor_pos, precision="highest")
                + T_icp[:3, 3] - anchor_pos
            )
            cos_t = jnp.clip((jnp.trace(T_icp[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
            theta = jnp.arccos(cos_t)
            return jnp.linalg.norm(moved) + theta * r_scan

        def do_setup(pose):
            src_anchor = geo.transform_points(pose, frame)
            return cf.corr_setup(
                map_state, tables, src_anchor, valid, voxel_size,
                probe_depth, **fast_params,
            )

        # ONE flat while_loop over GN iterations; the frozen correspondence
        # structure rides the carry and is rebuilt under lax.cond whenever
        # the accumulated increment has drifted past the mover shell
        def cond_f(carry):
            _, _, _, it, last_norm, _, _ = carry
            return (it < max_iterations) & (last_norm >= ESTIMATION_THRESHOLD)

        def body_f(carry):
            anchor, T_icp, setup, it, last_norm, _, drift = carry
            def reanchor(a, T, s):
                na = jnp.matmul(T, a, precision="highest")
                return na, eye, do_setup(na)

            anchor, T_icp, setup = jax.lax.cond(
                drift >= drift_lim,
                reanchor,
                lambda a, T, s: (a, T, s),
                anchor, T_icp, setup,
            )
            if fused:
                sums = pnn.fused_gn_iteration(
                    setup.cxp, setup.cyp, setup.czp, setup.clp,
                    offs[:, 0], offs[:, 1], offs[:, 2],
                    setup.q0.reshape(R, -1), setup.row_origin_abs,
                    setup.row_rel + setup.center[None, :],
                    setup.grid_used.astype(jnp.int32), T_icp,
                    sem_th, scale, voxel_size,
                    max_correspondence_distance, kernel,
                    interpret=(mode == routing.INTERPRET),
                )
                JTJ, JTr, ncorr, _ = pnn.assemble_normal_equations(sums)
            else:
                src_g, tgt_g, acc_g = cf.corr_apply(
                    setup, T_icp, voxel_size,
                    max_correspondence_distance, sem_th,
                )
                JTJ, JTr = build_normal_equations(
                    src_g.reshape(-1, 4), tgt_g.reshape(-1, 4),
                    acc_g.reshape(-1), kernel,
                )
                # dtype pinned: under jax_enable_x64 a bare sum promotes
                # to int64 and breaks the while_loop carry
                ncorr = jnp.sum(acc_g, dtype=jnp.int32)
            x = solve_increment(JTJ, JTr)
            estimation = geo.se3_exp(x)
            T_icp = jnp.matmul(estimation, T_icp, precision="highest")
            return (
                anchor, T_icp, setup, it + 1, jnp.linalg.norm(x), ncorr,
                anchor_drift(T_icp, anchor[:3, 3]),
            )

        init = (
            initial_guess,
            eye,
            do_setup(initial_guess),
            jnp.asarray(0, jnp.int32),
            jnp.asarray(jnp.inf, frame.dtype),
            jnp.asarray(0, jnp.int32),
            jnp.asarray(0.0, frame.dtype),
        )
        anchor, T_icp, setup, iters, _, ncorr, _ = jax.lax.while_loop(
            cond_f, body_f, init
        )
        pose = jnp.matmul(T_icp, anchor, precision="highest")
        return IcpResult(
            pose=pose, iterations=iters, num_correspondences=ncorr,
            dropped_queries=setup.n_dropped,
        )

    source0 = geo.transform_points(initial_guess, frame)

    def cond(carry):
        _, _, it, last_norm, _ = carry
        return (it < max_iterations) & (last_norm >= ESTIMATION_THRESHOLD)

    def body(carry):
        source, T_icp, it, _, _ = carry
        tgt, accept = hm.get_correspondences(
            map_state,
            source,
            valid,
            voxel_size,
            max_correspondence_distance,
            sem_th,
            probe_depth,
        )
        JTJ, JTr = build_normal_equations(source, tgt, accept, kernel)
        # under a sharded points axis these psum over the mesh (see
        # sage_icp_tpu.parallel); single-device this is a no-op
        x = solve_increment(JTJ, JTr)
        estimation = geo.se3_exp(x)
        source = geo.transform_points(estimation, source)
        T_icp = jnp.matmul(estimation, T_icp, precision="highest")
        ncorr = jnp.sum(accept, dtype=jnp.int32)
        return source, T_icp, it + 1, jnp.linalg.norm(x), ncorr

    init = (
        source0,
        eye,
        jnp.asarray(0, jnp.int32),
        jnp.asarray(jnp.inf, frame.dtype),
        jnp.asarray(0, jnp.int32),
    )
    _, T_icp, iters, _, ncorr = jax.lax.while_loop(cond, body, init)
    # empty map: zero correspondences every iteration -> x = 0 after iter 1
    # -> T_icp = I -> returns initial_guess (reference Registration.cpp:119)
    pose = jnp.matmul(T_icp, initial_guess, precision="highest")
    return IcpResult(
        pose=pose, iterations=iters, num_correspondences=ncorr,
        dropped_queries=jnp.asarray(0, jnp.int32),
    )
