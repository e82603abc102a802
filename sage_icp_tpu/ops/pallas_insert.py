"""Pallas (Triton route) kernel: fused voxel-block retention policy.

The semantic map insert (ops/hashmap.py) applies the reference's
VoxelBlock::AddPoint policy (cpp/sage_icp/core/VoxelHashMap.hpp:45-70)
to every voxel touched by a frame: incoming points are processed IN SCAN
ORDER per voxel, mutating the block's count and contents (append / drop /
overwrite-first-label-0). The XLA formulation runs one lax.while_loop
round per incoming point rank; each round is a handful of kernel launches
plus a loop-predicate read-back.

This kernel runs ALL rounds for a block of rows in one launch: the block
planes load once into registers, every round is elementwise work on them,
and the final planes/counts store once. A block's round loop is bounded
by its OWN maximum segment length (unique voxels arrive in cell-code
order, so the dense road voxels sit in a few blocks while most blocks
stop after 2-8 rounds). Round r reads column r of the incoming planes
directly.

Input layout (prepared by hashmap.insert):
  * block planes bx/by/bz/bl: (U, K) int16 quantized voxel-local
  * counts, seglen: (U, 1) int32 — seglen pre-clipped to R_max and zeroed
    for rows without a slot
  * incoming planes ix/iy/iz/ie: (U, R_max) int16 — rank r of each row's
    voxel segment (a contiguous window of the voxel-sorted scan);
    ie packs the class code into the label: enc = label | cls << 12,
    cls in {0: label-0, 1: basic, 2: critical}
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

CLS_SHIFT = 12
LABEL_MASK = (1 << CLS_SHIFT) - 1
# block shape: a sweep of 9 shapes (8-128 rows, 1-8 warps) at kitti widths
# on an H100 stayed within 6% (PERF.md)
ROWS_PER_BLOCK = 32
NUM_WARPS = 4


def _kernel(bx_ref, by_ref, bz_ref, bl_ref, cnt_ref, seg_ref, rmax_ref,
            ix_ref, iy_ref, iz_ref, ie_ref,
            ox_ref, oy_ref, oz_ref, ol_ref, ocnt_ref, *,
            basic: int, kmax: int, kpad: int):
    tu = cnt_ref.shape[0]
    kiota = jnp.broadcast_to(
        jnp.arange(kpad, dtype=jnp.int32)[None, :], (tu, kpad)
    )
    kmask = kiota < kmax  # K is not a power of two: mask a kpad-wide tile
    sl = pl.ds(0, kpad)
    planes = [
        plgpu.load(r.at[:, sl], mask=kmask, other=0).astype(jnp.int32)
        for r in (bx_ref, by_ref, bz_ref, bl_ref)
    ]
    cnt = cnt_ref[...]  # (TU,)
    seg = jnp.minimum(seg_ref[...], rmax_ref[0])  # (TU,)
    zl = (planes[3] == 0) & (kiota < cnt[:, None]) & kmask

    def _round(r, carry):
        bx, by, bz, bl, cnt, zl = carry
        act = r < seg
        ix = ix_ref[:, r].astype(jnp.int32)  # (TU,) rank r of each row
        iy = iy_ref[:, r].astype(jnp.int32)
        iz = iz_ref[:, r].astype(jnp.int32)
        enc = ie_ref[:, r].astype(jnp.int32)
        cls = enc >> CLS_SHIFT  # 0 = label-0, 1 = basic, 2 = critical
        lab = enc & LABEL_MASK
        zidx = jnp.min(jnp.where(zl, kiota, 2**30), axis=1)
        has_zero = zidx < 2**30
        first_zero = jnp.where(has_zero, zidx, 0)

        append_basic = cnt < basic
        overwrite_b = ~append_basic & (cls == 1)
        append_crit = ~append_basic & (cls == 2) & (cnt < kmax)
        overwrite_c = ~append_basic & (cls == 2) & (cnt >= kmax)

        do_append = act & (append_basic | append_crit)
        do_over = act & (overwrite_b | overwrite_c) & has_zero
        target = jnp.where(do_append, cnt, first_zero)
        sel = (do_append | do_over)[:, None] & (kiota == target[:, None])
        return (
            jnp.where(sel, ix[:, None], bx),
            jnp.where(sel, iy[:, None], by),
            jnp.where(sel, iz[:, None], bz),
            jnp.where(sel, lab[:, None], bl),
            cnt + do_append.astype(jnp.int32),
            # a written slot is zero-live iff the appended label is 0
            jnp.where(sel, (lab == 0)[:, None], zl),
        )

    *planes, cnt, _ = jax.lax.fori_loop(
        0, jnp.max(seg), _round, (*planes, cnt, zl)
    )
    for o, v in zip((ox_ref, oy_ref, oz_ref, ol_ref), planes):
        plgpu.store(o.at[:, sl], v.astype(jnp.int16), mask=kmask)
    ocnt_ref[...] = cnt


@functools.partial(
    jax.jit,
    static_argnames=("n_rounds", "basic", "interpret"),
)
def apply_policy(
    bx: jax.Array,  # (U, K) int16 block x plane, quantized voxel-local
    by: jax.Array,
    bz: jax.Array,
    bl: jax.Array,  # (U, K) int16 block labels
    counts: jax.Array,  # (U, 1) int32
    seglen: jax.Array,  # (U, 1) int32, clipped to n_rounds, 0 = inactive
    ix: jax.Array,  # (U, n_rounds) int16 incoming x plane (rank-major)
    iy: jax.Array,
    iz: jax.Array,
    ie: jax.Array,  # (U, n_rounds) int16 encoded label|cls<<12
    max_rounds: jax.Array,  # int32 scalar: frame's actual max rank
    n_rounds: int,
    basic: int,
    interpret: bool = False,
):
    """Returns (bx', by', bz', bl', counts') after applying the retention
    policy for every row's incoming segment, in order."""
    U, K = bx.shape
    TU = math.gcd(U, ROWS_PER_BLOCK)  # power of two dividing U
    kpad = pl.next_power_of_2(K)
    plane = pl.BlockSpec((TU, K), lambda i: (i, 0))
    col = pl.BlockSpec((TU,), lambda i: (i,))
    inc = pl.BlockSpec((TU, n_rounds), lambda i: (i, 0))
    out = pl.pallas_call(
        functools.partial(_kernel, basic=basic, kmax=K, kpad=kpad),
        grid=(U // TU,),
        in_specs=[
            plane, plane, plane, plane, col, col,
            pl.BlockSpec((1,), lambda i: (0,)),
            inc, inc, inc, inc,
        ],
        out_specs=[plane, plane, plane, plane, col],
        out_shape=[
            *[jax.ShapeDtypeStruct((U, K), jnp.int16)] * 4,
            jax.ShapeDtypeStruct((U,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="sage_retention_policy",
    )(
        bx, by, bz, bl, counts[:, 0], seglen[:, 0],
        jnp.asarray(max_rounds, jnp.int32).reshape(1),
        ix, iy, iz, ie,
    )
    return (*out[:4], out[4][:, None])
