"""Pallas (Triton route) kernel: one fully fused Gauss-Newton iteration.

The frozen-rows ICP solve (ops/registration.py) groups the ICP queries
by voxel into R rows, each with P query slots and M = 27*K gathered
candidate points stored as int16 planes (ops/correspondence_fast.py).
One GN iteration is

    transform -> movers -> d2[r,p,m] -> semantic weighting -> argmin
    -> winner -> robust weight -> 18 weighted normal-equation sums

The plain XLA formulation (correspondence_fast.corr_apply +
registration.build_normal_equations) writes the (R, P, M) distance /
weight / argmin intermediates to device memory. This kernel keeps them
in registers: each block streams its (TR, M) int16 candidate tile once,
in lane chunks, and writes only its 18 partial sums.

Semantics are identical to the reference nearest-neighbor rule
(cpp/sage_icp/core/VoxelHashMap.cpp:88,111): argmin on the sem_th-scaled
squared distance where labels match or either is 0, first minimum on
ties, and the UNWEIGHTED distance for the acceptance gate. Invalid lanes
carry label -1 and lose every argmin; a winner that is invalid (an
all-invalid row) is rejected.

Coordinates are ROW-LOCAL (relative to each row's voxel origin), where
values span ~2-3 voxel sizes and f32 is exact.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# JTJ/JTr for J = [I | -hat(s)] decompose into 17 weighted sums
# (reference cpp/sage_icp/core/Registration.cpp:62-90):
#   JTJ upper-left  = (sum w) I
#   JTJ upper-right = -hat(sum w s)
#   JTJ lower-right = delta_ij (Sxx+Syy+Szz) - S_ij,  S_ij = sum w s_i s_j
#   JTr             = [sum w r ; sum w (s x r)]
# plus the accepted-correspondence and used-query counts.
N_SUMS = 18  # w, w*s(3), w*s_i*s_j(6), w*r(3), w*(s x r)(3), ncorr, used
SUMS_WIDTH = 32  # per-block output row (power of two for the Triton store)
# block shape from a sweep of 13 shapes at kitti widths on an H100
# (PERF.md): 16 rows (R / 16 = 1,152 blocks for 132 SMs) x 32-lane
# chunks of the in-block loop, 2 warps
ROWS_PER_BLOCK = 16
LANES = 32
NUM_WARPS = 2
NUM_STAGES = 2
_FMAX = float(jnp.finfo(jnp.float32).max)


def _gn_kernel(par_ref, T_ref, cx_ref, cy_ref, cz_ref, cl_ref, ox_ref,
               oy_ref, oz_ref, q0_ref, org_ref, rabs_ref, used_ref, out_ref,
               *, n_queries: int, m_valid: int, lanes: int):
    sem_th = par_ref[0]
    scale = par_ref[1]
    vox = par_ref[2]
    max_corr2 = par_ref[3] * par_ref[3]
    kth = par_ref[4]
    tr = cx_ref.shape[0]
    used_blk = used_ref[...]  # (TR, P) int32
    live = jnp.max(used_blk) != 0

    def compute():
        T = [T_ref[k] for k in range(12)]
        org = [org_ref[:, a] for a in range(3)]  # (TR,) row origin, world
        rabs = [rabs_ref[:, a] for a in range(3)]  # (TR,) row voxel
        qs = []
        for p in range(n_queries):
            x0, y0, z0 = (q0_ref[:, 4 * p + a] for a in range(3))
            ql = q0_ref[:, 4 * p + 3]
            # s = T . q0 (world frame)
            sx = T[0] * x0 + T[1] * y0 + T[2] * z0 + T[3]
            sy = T[4] * x0 + T[5] * y0 + T[6] * z0 + T[7]
            sz = T[8] * x0 + T[9] * y0 + T[10] * z0 + T[11]
            # movers: a query may drift ONE voxel from its setup row (its
            # NN stays inside the row's 27-neighborhood, see
            # correspondence_fast.corr_apply); farther moves drop. The
            # int cast truncates toward zero, like scan.trunc_div.
            near = used_ref[:, p] != 0
            for s_, ra in zip((sx, sy, sz), rabs):
                near &= jnp.abs((s_ / vox).astype(jnp.int32) - ra) <= 1
            qs.append((sx, sy, sz, ql, near,
                       sx - org[0], sy - org[1], sz - org[2]))

        n_chunks = pl.cdiv(m_valid, lanes)

        def chunk(c, carry):
            lane = c * lanes + jnp.arange(lanes, dtype=jnp.int32)
            lmask = lane < m_valid
            mask2 = jnp.broadcast_to(lmask[None, :], (tr, lanes))
            sl = pl.ds(c * lanes, lanes)
            ox = plgpu.load(ox_ref.at[sl], mask=lmask, other=0.0)
            oy = plgpu.load(oy_ref.at[sl], mask=lmask, other=0.0)
            oz = plgpu.load(oz_ref.at[sl], mask=lmask, other=0.0)
            cx = plgpu.load(cx_ref.at[:, sl], mask=mask2, other=0)
            cy = plgpu.load(cy_ref.at[:, sl], mask=mask2, other=0)
            cz = plgpu.load(cz_ref.at[:, sl], mask=mask2, other=0)
            cl = plgpu.load(cl_ref.at[:, sl], mask=mask2, other=-1)
            cx = cx.astype(jnp.float32) * scale + ox[None, :]
            cy = cy.astype(jnp.float32) * scale + oy[None, :]
            cz = cz.astype(jnp.float32) * scale + oz[None, :]
            clf = cl.astype(jnp.float32)
            invalid = clf < 0.0
            out = []
            for p in range(n_queries):
                best, bidx = carry[2 * p: 2 * p + 2]
                _, _, _, ql, _, qx, qy, qz = qs[p]
                dx = cx - qx[:, None]
                dy = cy - qy[:, None]
                dz = cz - qz[:, None]
                d2 = dx * dx + dy * dy + dz * dz
                sem = (clf == ql[:, None]) | ((clf * ql[:, None]) == 0.0)
                d2w = jnp.where(sem, d2 * sem_th, d2)
                d2w = jnp.where(invalid, _FMAX, d2w)
                # first minimum within the chunk (the reference's
                # tie-break); across chunks, a later chunk wins only on
                # a STRICTLY smaller value
                cmin = jnp.min(d2w, axis=1)
                cidx = jnp.argmin(d2w, axis=1).astype(jnp.int32)
                take = cmin < best
                out += [jnp.where(take, cmin, best),
                        jnp.where(take, c * lanes + cidx, bidx)]
            return tuple(out)

        init = (jnp.full((tr,), jnp.inf, jnp.float32),
                jnp.zeros((tr,), jnp.int32))
        res = jax.lax.fori_loop(0, n_chunks, chunk, init * n_queries)

        rows = jnp.arange(tr, dtype=jnp.int32)
        acc = [jnp.zeros((tr,), jnp.float32) for _ in range(N_SUMS)]
        for p in range(n_queries):
            # the winner's lanes, gathered once per query slot
            w = res[2 * p + 1]  # (TR,) winning lane per row
            tx, ty, tz = (
                plgpu.load(c_ref.at[rows, w]).astype(jnp.float32) * scale
                + plgpu.load(o_ref.at[w])
                for c_ref, o_ref in ((cx_ref, ox_ref), (cy_ref, oy_ref),
                                     (cz_ref, oz_ref))
            )
            tinv = plgpu.load(cl_ref.at[rows, w]) < 0
            sx, sy, sz, _, near, qx, qy, qz = qs[p]
            rx = qx - tx  # residual r = s - t (translation-invariant)
            ry = qy - ty
            rz = qz - tz
            r2 = rx * rx + ry * ry + rz * rz
            accept = near & ~tinv & (r2 < max_corr2)
            w = jnp.where(accept, (kth * kth) / ((kth + r2) * (kth + r2)),
                          0.0)
            terms = (
                w, w * sx, w * sy, w * sz,
                w * sx * sx, w * sy * sy, w * sz * sz,
                w * sx * sy, w * sx * sz, w * sy * sz,
                w * rx, w * ry, w * rz,
                w * (sy * rz - sz * ry),
                w * (sz * rx - sx * rz),
                w * (sx * ry - sy * rx),
                accept.astype(jnp.float32),
                near.astype(jnp.float32),
            )
            acc = [a + t for a, t in zip(acc, terms)]
        col = jnp.arange(SUMS_WIDTH, dtype=jnp.int32)
        row = jnp.zeros((SUMS_WIDTH,), jnp.float32)
        for j in range(N_SUMS):
            row = jnp.where(col == j, jnp.sum(acc[j]), row)
        return row

    # a dead block (no used query slot: the grid is sized for worst-case
    # demand, and live rows are u_rank-order prefixes) skips its stream
    out_ref[...] = jax.lax.cond(
        live, compute, lambda: jnp.zeros((SUMS_WIDTH,), jnp.float32)
    )


@functools.partial(jax.jit, static_argnames=("interpret",))
def gn_partials(
    cx: jax.Array,  # (R, M) int16 candidate planes, own-voxel-local
    cy: jax.Array,
    cz: jax.Array,
    cl: jax.Array,  # (R, M) int16 candidate labels; -1 = invalid lane
    offx: jax.Array,  # (M,) f32 per-lane neighbor offsets, meters
    offy: jax.Array,
    offz: jax.Array,
    q0: jax.Array,  # (R, 4*P) f32 packed [x y z label], WORLD at setup
    origin: jax.Array,  # (R, 3) f32 row voxel origin, world
    row_abs: jax.Array,  # (R, 3) int32 absolute row voxel coords
    used: jax.Array,  # (R, P) int32 grid_used
    T: jax.Array,  # (4, 4) f32 pose increment since setup
    sem_th,
    scale,  # voxel_size / QSCALE dequantization factor
    voxel_size,
    max_corr,
    kernel_th,
    interpret: bool = False,
):
    """One fused GN iteration over the frozen rows, per block.

    Returns (R // TR, SUMS_WIDTH) f32: row b holds block b's weighted
    normal-equation partials in the order documented at N_SUMS (columns
    N_SUMS.. are zero; a dead block's row is all zero). Each block writes
    its own row: deterministic, no atomics."""
    R, M = cx.shape
    P = q0.shape[1] // 4
    # rows per block: the largest power of two <= ROWS_PER_BLOCK that
    # divides R (every block full; no row masks)
    TR = math.gcd(R, ROWS_PER_BLOCK)
    par = jnp.stack([
        jnp.asarray(v, jnp.float32)
        for v in (sem_th, scale, voxel_size, max_corr, kernel_th, 0, 0, 0)
    ])
    Tf = T.astype(jnp.float32).reshape(16)
    rows = lambda w: pl.BlockSpec((TR, w), lambda i: (i, 0))
    whole = lambda n: pl.BlockSpec((n,), lambda i: (0,))
    return pl.pallas_call(
        functools.partial(_gn_kernel, n_queries=P, m_valid=M, lanes=LANES),
        grid=(R // TR,),
        in_specs=[
            whole(8), whole(16),
            rows(M), rows(M), rows(M), rows(M),
            whole(M), whole(M), whole(M),
            rows(4 * P), rows(3), rows(3), rows(P),
        ],
        out_specs=pl.BlockSpec((None, SUMS_WIDTH), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((R // TR, SUMS_WIDTH), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="sage_fused_gn_iteration",
    )(par, Tf, cx, cy, cz, cl, offx, offy, offz, q0, origin, row_abs, used)


def fused_gn_iteration(*args, **kwargs) -> jax.Array:
    """gn_partials summed over blocks: (N_SUMS,) f32, for
    assemble_normal_equations."""
    return jnp.sum(gn_partials(*args, **kwargs)[:, :N_SUMS], axis=0)


def assemble_normal_equations(sums: jax.Array):
    """(18,) partials -> (JTJ (6,6), JTr (6,), ncorr, nused)."""
    w = sums[0]
    wsx, wsy, wsz = sums[1], sums[2], sums[3]
    sxx, syy, szz = sums[4], sums[5], sums[6]
    sxy, sxz, syz = sums[7], sums[8], sums[9]
    wr = sums[10:13]
    wsr = sums[13:16]
    z = jnp.zeros(())
    # upper-right block -hat(sum w s)
    ur = jnp.array([[z, wsz, -wsy], [-wsz, z, wsx], [wsy, -wsx, z]])
    tr = sxx + syy + szz
    lr = jnp.array([
        [tr - sxx, -sxy, -sxz],
        [-sxy, tr - syy, -syz],
        [-sxz, -syz, tr - szz],
    ])
    ul = w * jnp.eye(3)
    JTJ = jnp.block([[ul, ur], [ur.T, lr]])
    JTr = jnp.concatenate([wr, wsr])
    return JTJ, JTr, sums[16].astype(jnp.int32), sums[17].astype(jnp.int32)
