"""SO(3)/SE(3) Lie-group ops in pure JAX.

Array-program replacement for the reference's Sophus usage
(reference: cpp/sage_icp/core/Registration.cpp:92-93 SE3::exp,
cpp/sage_icp/pipeline/sageICP.cpp:110-115 pose compose/inverse,
cpp/sage_icp/core/Threshold.cpp:29-34 angle extraction).

Conventions match Sophus: a pose is a 4x4 homogeneous matrix; twists are
6-vectors [rho(3), phi(3)] with translation part first — identical to
Sophus::SE3d::log/exp ordering used throughout the reference. All functions
are batched-friendly (vmap/jit safe), f32 by default with f64 fallback on
CPU for oracle tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(v: jax.Array) -> jax.Array:
    """so(3) hat operator: 3-vector -> 3x3 skew matrix."""
    z = jnp.zeros_like(v[..., 0])
    return jnp.stack(
        [
            jnp.stack([z, -v[..., 2], v[..., 1]], axis=-1),
            jnp.stack([v[..., 2], z, -v[..., 0]], axis=-1),
            jnp.stack([-v[..., 1], v[..., 0], z], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(phi: jax.Array) -> jax.Array:
    """Rodrigues formula, Taylor-safe near zero. phi: (...,3) -> (...,3,3)."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    # sin(t)/t and (1-cos(t))/t^2 with series fallback for small t
    small = theta < 1e-4
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    K = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    KK = jnp.matmul(K, K, precision='highest')
    return eye + a[..., None, None] * K + b[..., None, None] * KK


def so3_log(R: jax.Array) -> jax.Array:
    """Inverse of so3_exp. R: (...,3,3) -> (...,3).

    Uses the quaternion route for numerical stability near pi (the direct
    acos formula loses the axis there).
    """
    q = rotmat_to_quat(R)  # (w, x, y, z), w >= 0
    w = q[..., 0]
    xyz = q[..., 1:]
    n = jnp.linalg.norm(xyz, axis=-1)
    # angle = 2*atan2(n, w); axis = xyz/n
    angle = 2.0 * jnp.arctan2(n, w)
    scale = jnp.where(n < 1e-7, 2.0 / jnp.maximum(w, _EPS), angle / jnp.maximum(n, _EPS))
    return xyz * scale[..., None]


def rotmat_to_quat(R: jax.Array) -> jax.Array:
    """Rotation matrix -> unit quaternion (w,x,y,z), w >= 0. Shepperd's method,
    branch-free via selecting the max-denominator candidate."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # candidate 0: trace
    s0 = jnp.sqrt(jnp.maximum(tr + 1.0, 0.0) + _EPS) * 2.0
    q0 = jnp.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], axis=-1)
    # candidate 1: m00 largest
    s1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 0.0) + _EPS) * 2.0
    q1 = jnp.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], axis=-1)
    # candidate 2: m11 largest
    s2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, 0.0) + _EPS) * 2.0
    q2 = jnp.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], axis=-1)
    # candidate 3: m22 largest
    s3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, 0.0) + _EPS) * 2.0
    q3 = jnp.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], axis=-1)

    cond0 = tr > 0.0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = jnp.where(
        cond0[..., None],
        q0,
        jnp.where(cond1[..., None], q1, jnp.where(cond2[..., None], q2, q3)),
    )
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q * jnp.where(q[..., :1] < 0.0, -1.0, 1.0)


def se3_exp(xi: jax.Array) -> jax.Array:
    """se(3) exp. xi = [rho, phi] (Sophus ordering) -> 4x4 matrix."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta < 1e-4
    R = so3_exp(phi)
    K = hat(phi)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    c = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta)
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), K.shape)
    KK = jnp.matmul(K, K, precision='highest')
    V = eye + b[..., None, None] * K + c[..., None, None] * KK
    t = jnp.einsum("...ij,...j->...i", V, rho, precision='highest')
    return _rt_to_mat(R, t)


def se3_log(T: jax.Array) -> jax.Array:
    """Inverse of se3_exp. 4x4 -> [rho, phi]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta < 1e-4
    K = hat(phi)
    # V^{-1} = I - K/2 + (1/theta^2 - (1+cos)/(2 theta sin)) K^2
    half_theta = 0.5 * theta
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_theta * jnp.cos(half_theta) / jnp.maximum(jnp.sin(half_theta), _EPS))
        / theta2,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), K.shape)
    KK = jnp.matmul(K, K, precision='highest')
    Vinv = eye - 0.5 * K + cot_term[..., None, None] * KK
    rho = jnp.einsum("...ij,...j->...i", Vinv, t, precision='highest')
    return jnp.concatenate([rho, phi], axis=-1)


def _rt_to_mat(R: jax.Array, t: jax.Array) -> jax.Array:
    batch = R.shape[:-2]
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def se3_inverse(T: jax.Array) -> jax.Array:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return _rt_to_mat(Rt, -jnp.einsum("...ij,...j->...i", Rt, t, precision='highest'))


def se3_identity(dtype=jnp.float32) -> jax.Array:
    return jnp.eye(4, dtype=dtype)


def renormalize(T: jax.Array) -> jax.Array:
    """Project the rotation block back onto SO(3) (one Newton-Schulz
    polar iteration: R <- R (3I - R^T R) / 2; quadratic convergence, so
    one step takes a 1e-2-scale drift to 1e-4 and f32-noise drift to
    roundoff).

    WHY THIS MUST RUN ON EVERY CARRIED POSE: the reference stores SE3 as
    a Sophus SE3d — a UNIT QUATERNION plus translation, orthonormal by
    construction (cpp/sage_icp/pipeline/sageICP.hpp uses Sophus::SE3d
    throughout). A raw 4x4 f32 matrix representation has no such
    invariant, and the per-frame prediction recursion
        guess = last @ inv(prev) @ last
    with a transpose-based rigid inverse COMPOUNDS any scale error
    multiplicatively (e_{k+1} ~= 2 e_k + e_{k-1}: the transpose of a
    scaled rotation has the SAME scale, so nothing ever cancels).
    Starting from mere f32 rounding noise this reaches ~1% per-axis
    scale by frame ~14 — a 1%-scaled guess displaces an 80 m point by
    0.8 m radially, which collapsed the far-field correspondences and
    drove the round-2..4 bench divergences (round-4 forensics:
    scripts/nonfinite_probe.py showed diag(R) ~= 1.02 in the frame-15
    initial guess on every world at every density)."""
    R = T[..., :3, :3]
    RtR = jnp.matmul(jnp.swapaxes(R, -1, -2), R, precision="highest")
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), RtR.shape)
    R2 = jnp.matmul(R, 1.5 * eye - 0.5 * RtR, precision="highest")
    return _rt_to_mat(R2, T[..., :3, 3])


def transform_points(T: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply SE3 to xyz, preserving the label lane.

    pts: (N, 4) with lane 3 = semantic label
    (reference semantics: cpp/sage_icp/core/Registration.cpp:103-111).
    """
    xyz = jnp.matmul(pts[..., :3], T[:3, :3].T, precision='highest') + T[:3, 3]
    return jnp.concatenate([xyz, pts[..., 3:]], axis=-1)


def rotation_angle(R: jax.Array) -> jax.Array:
    """Angle of a rotation matrix, like Eigen::AngleAxisd(R).angle()
    (used by the adaptive threshold, reference core/Threshold.cpp:30)."""
    phi = so3_log(R)
    return jnp.linalg.norm(phi, axis=-1)


def umeyama_alignment(src: jax.Array, dst: jax.Array, with_scale: bool = False):
    """Umeyama closed-form alignment dst ~= c * R @ src + t.

    Equivalent of Eigen::umeyama used by the ATE metric
    (reference metrics/Metrics.cpp:169). src/dst: (N, 3). Returns 4x4.
    """
    mu_s = jnp.mean(src, axis=0)
    mu_d = jnp.mean(dst, axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    n = src.shape[0]
    cov = jnp.matmul(dc.T, sc, precision='highest') / n
    U, D, Vt = jnp.linalg.svd(cov)
    S = jnp.eye(3, dtype=src.dtype)
    det = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    S = S.at[2, 2].set(jnp.where(det < 0, -1.0, 1.0))
    R = jnp.matmul(jnp.matmul(U, S, precision='highest'), Vt, precision='highest')
    if with_scale:
        var_s = jnp.mean(jnp.sum(sc * sc, axis=-1))
        c = jnp.trace(jnp.matmul(jnp.diag(D), S, precision='highest')) / var_s
    else:
        c = jnp.asarray(1.0, dtype=src.dtype)
    t = mu_d - c * jnp.matmul(R, mu_s, precision='highest')
    T = jnp.eye(4, dtype=src.dtype)
    T = T.at[:3, :3].set(c * R)
    T = T.at[:3, 3].set(t)
    return T
