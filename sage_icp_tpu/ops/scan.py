"""Scan-level kernels: range crop, label-range masking, deskew, and
class-adaptive voxel downsampling — fixed-shape, masked, jit-safe.

Reference behaviors reproduced (see /root/reference):
  * Preprocess: keep points with min_range < ||p|| < max_range; zero the
    label beyond label_max_range (cpp/sage_icp/core/Preprocessing.cpp:86-189).
    The reference *compacts* inliers; we keep fixed shape and carry a
    validity mask instead (masked-out points get pushed far away so that
    downstream voxel ops never select them).
  * VoxelDownsample: one grid per semantic class group, per-group voxel
    size * vox_scale, keep the FIRST point (scan order) per voxel; points
    whose label belongs to no group are dropped
    (cpp/sage_icp/core/Preprocessing.cpp:44-84).
  * DeSkewScan: constant-velocity motion compensation,
    exp((t_i - 0.5) * log(start^-1 finish)) per point
    (cpp/sage_icp/core/Deskew.cpp:36-50).

Voxel coordinates use C-style truncation toward zero (`static_cast<int>` in
the reference), NOT floor — this matters for points with negative coords.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sage_icp_tpu.ops import geometry as geo

# Sentinel coordinate for invalid/masked points: far outside any plausible
# map so they can never alias a live voxel.
INVALID_COORD = 1.0e7


def trunc_div(x: jax.Array, s) -> jax.Array:
    """C-style int cast of x / s (truncation toward zero)."""
    return jnp.trunc(x / s).astype(jnp.int32)


def preprocess(
    points: jax.Array,
    valid: jax.Array,
    max_range: float,
    min_range: float,
    label_max_range: float,
) -> tuple[jax.Array, jax.Array]:
    """Range crop + label-range masking.

    points: (N, 4) xyz+label, valid: (N,) bool. Returns (points', valid').
    Points outside [min_range, max_range] become invalid; labels beyond
    label_max_range are zeroed (reference Preprocessing.cpp:102-103,177-178).
    """
    norm = jnp.linalg.norm(points[:, :3], axis=-1)
    keep = valid & (norm < max_range) & (norm > min_range)
    label = jnp.where(norm > label_max_range, 0.0, points[:, 3])
    pts = jnp.concatenate([points[:, :3], label[:, None]], axis=-1)
    # Push invalid points to the sentinel so voxel keys can't collide.
    pts = jnp.where(keep[:, None], pts, jnp.full_like(pts, INVALID_COORD))
    return pts, keep


def deskew(
    points: jax.Array,
    timestamps: jax.Array,
    start_pose: jax.Array,
    finish_pose: jax.Array,
) -> jax.Array:
    """Constant-velocity motion compensation (reference Deskew.cpp:36-50).

    points: (N, 4), timestamps: (N,) normalized to [0, 1].
    Applies exp((t_i - 0.5) * log(start^-1 finish)) to xyz.
    """
    delta = geo.se3_log(jnp.matmul(
        geo.se3_inverse(start_pose), finish_pose, precision="highest"
    ))  # (6,)
    scaled = (timestamps - 0.5)[:, None] * delta[None, :]  # (N, 6)
    T = geo.se3_exp(scaled)  # (N, 4, 4)
    xyz = jnp.einsum(
        "nij,nj->ni", T[:, :3, :3], points[:, :3], precision="highest"
    ) + T[:, :3, 3]
    return jnp.concatenate([xyz, points[:, 3:]], axis=-1)


def make_label_group_lut(voxel_labels: list[list[int]], num_labels: int = 260) -> jax.Array:
    """label -> class-group id LUT; -1 = label in no group (point is dropped
    by the downsampler, reference Preprocessing.cpp:69)."""
    lut = -jnp.ones((num_labels,), dtype=jnp.int32)
    for g, labels in enumerate(voxel_labels):
        for lab in labels:
            lut = lut.at[lab].set(g)
    return lut


# Up to this many table entries, a per-point label lookup is a chain of
# vectorized equality-compares (fused by XLA) instead of an element
# gather from a LUT (gather avoidance; not measured on the H100).
_COMPARE_CHAIN_MAX = 48


def label_groups(
    labels_i32: jax.Array, voxel_labels: tuple | None, group_lut: jax.Array
) -> jax.Array:
    """Per-point class-group id (-1 = none). When the static label sets are
    given and small, lower as a compare chain instead of a LUT gather."""
    if voxel_labels is not None and (
        sum(len(g) for g in voxel_labels) <= _COMPARE_CHAIN_MAX
    ):
        group = jnp.full(labels_i32.shape, -1, dtype=jnp.int32)
        for g, labs in enumerate(voxel_labels):
            hit = jnp.zeros(labels_i32.shape, dtype=bool)
            for lab in labs:
                hit = hit | (labels_i32 == lab)
            group = jnp.where(hit, g, group)
        return group
    return group_lut[jnp.clip(labels_i32, 0, group_lut.shape[0] - 1)]


def label_in_set(labels_i32: jax.Array, wanted: tuple) -> jax.Array:
    """Vectorized membership test via compare chain (no gather)."""
    hit = jnp.zeros(labels_i32.shape, dtype=bool)
    for lab in wanted:
        hit = hit | (labels_i32 == lab)
    return hit


def voxel_downsample(
    points: jax.Array,
    valid: jax.Array,
    group_lut: jax.Array,
    voxel_sizes: jax.Array,
    vox_scale: float,
    out_capacity: int,
    voxel_labels: tuple | None = None,
    with_stats: bool = False,  # also return truncated-point count (i32)
) -> tuple[jax.Array, jax.Array]:
    """Class-adaptive voxel downsample, keeping the first point in scan
    order per (group, voxel) cell (reference Preprocessing.cpp:44-84).

    points: (N, 4); valid: (N,); group_lut: (L,) label->group;
    voxel_sizes: (G,) per-group base size (scaled by vox_scale);
    voxel_labels: optional static label sets (enables the compare-chain
    group mapping — see label_groups).
    Returns (out_points (out_capacity, 4), out_valid (out_capacity,)).

    Implementation: per point compute (group, voxel key); sort by a packed
    64-bit-ish composite key with original index as tiebreak; keep segment
    heads. All fixed shape — dropped/overflowed points become invalid.
    """
    n = points.shape[0]
    label = points[:, 3].astype(jnp.int32)
    group = jnp.where(valid, label_groups(label, voxel_labels, group_lut), -1)
    in_group = group >= 0
    g_safe = jnp.maximum(group, 0)
    sizes = voxel_sizes[g_safe] * vox_scale
    v = trunc_div(points[:, :3], sizes[:, None])  # (N, 3) int32

    # Pack (group, voxel) into a comparable key. Voxel coords from a LiDAR
    # scan are bounded by max_range / min(voxel) — use 11 bits per axis
    # (+-1023) which covers 100 m at >= 0.1 m voxels; clamp defensively.
    vc = jnp.clip(v, -1023, 1023) + 1024  # [1, 2047] -> 11 bits
    # Two-level key: high = group|x, low = y|z (lexicographic pair).
    key_hi = g_safe.astype(jnp.uint32) * jnp.uint32(2**11) + vc[:, 0].astype(jnp.uint32)
    key_lo = vc[:, 1].astype(jnp.uint32) * jnp.uint32(2**11) + vc[:, 2].astype(jnp.uint32)
    # Invalid points sort to the end.
    big = jnp.uint32(0xFFFFFFFF)
    key_hi = jnp.where(in_group, key_hi, big)
    key_lo = jnp.where(in_group, key_lo, big)

    # ONE stable lexicographic sort by (key_hi, key_lo), carrying the
    # point planes as payload operands instead of a 16-byte-row
    # points[order] gather afterwards. Stability preserves scan order
    # within a voxel ("keep the first point").
    kh, kl, sx, sy, sz, sl = jax.lax.sort(
        (key_hi, key_lo, points[:, 0], points[:, 1], points[:, 2],
         points[:, 3]),
        num_keys=2,
        is_stable=True,
    )
    ig = kh != big  # in-group iff the key is not the invalid sentinel
    # Segment head: first occurrence of each (hi, lo).
    head = jnp.concatenate(
        [
            jnp.array([True]),
            (kh[1:] != kh[:-1]) | (kl[1:] != kl[:-1]),
        ]
    )
    keep = head & ig

    # Compact the kept points to the front with ONE more stable payload
    # sort on the keep bit instead of a scatter + narrow-row gather
    # (scatter avoidance; not measured on the H100). Stability preserves
    # the voxel-sorted order, as before.
    _, ox, oy, oz, ol = jax.lax.sort(
        ((~keep).astype(jnp.uint32), sx, sy, sz, sl),
        num_keys=1,
        is_stable=True,
    )
    n_keep = jnp.sum(keep.astype(jnp.int32))
    take = min(out_capacity, n)
    inval = jnp.asarray(INVALID_COORD, points.dtype)
    cols = [ox[:take], oy[:take], oz[:take], ol[:take]]
    if take < out_capacity:
        pad = jnp.full((out_capacity - take,), inval, points.dtype)
        cols = [jnp.concatenate([c, pad]) for c in cols]
    out_val = jnp.arange(out_capacity, dtype=jnp.int32) < n_keep
    out_pts = jnp.where(
        out_val[:, None], jnp.stack(cols, axis=-1), inval
    )
    if with_stats:
        truncated = jnp.maximum(n_keep - out_capacity, 0).astype(jnp.int32)
        return out_pts, out_val, truncated
    return out_pts, out_val
