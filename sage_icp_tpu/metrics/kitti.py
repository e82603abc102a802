"""KITTI odometry evaluation math — parity with the reference metrics
module (cpp/sage_icp/metrics/Metrics.cpp, itself from the KITTI dev-kit).

* seq_error: average relative translational error (%) and rotational error
  (deg/m) over segment lengths 100..800 m sampled every 10 frames
  (Metrics.cpp:34,90-135,140-155 — including its quirk of dividing by the
  literal 3.14, reproduced bit-for-bit so numbers are comparable).
* absolute_trajectory_error: Umeyama alignment then RMSE of rotation and
  translation residuals (Metrics.cpp:157-191).

Host-side numpy: metric evaluation is offline and tiny; no reason to put
it on the device.
"""

from __future__ import annotations

import numpy as np

SEGMENT_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)
STEP_SIZE = 10  # frames (reference Metrics.cpp:96)


def trajectory_distances(poses: np.ndarray) -> np.ndarray:
    d = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(d)])


def _last_frame_from_segment_length(dist, first, length):
    idx = np.nonzero(dist[first:] > dist[first] + length)[0]
    return int(idx[0]) + first if len(idx) else -1


def rotation_error(pose_error: np.ndarray) -> float:
    d = 0.5 * (np.trace(pose_error[:3, :3]) - 1.0)
    return float(np.arccos(np.clip(d, -1.0, 1.0)))


def translation_error(pose_error: np.ndarray) -> float:
    return float(np.linalg.norm(pose_error[:3, 3]))


def calc_sequence_errors(poses_gt: np.ndarray, poses_result: np.ndarray):
    """Per-segment (first_frame, r_err/len, t_err/len, len, speed) tuples
    (reference Metrics.cpp:90-135)."""
    dist = trajectory_distances(poses_gt)
    errors = []
    for first in range(0, len(poses_gt), STEP_SIZE):
        for length in SEGMENT_LENGTHS:
            last = _last_frame_from_segment_length(dist, first, length)
            if last == -1:
                continue
            delta_gt = np.linalg.inv(poses_gt[first]) @ poses_gt[last]
            delta_res = np.linalg.inv(poses_result[first]) @ poses_result[last]
            pose_error = np.linalg.inv(delta_res) @ delta_gt
            r_err = rotation_error(pose_error)
            t_err = translation_error(pose_error)
            num_frames = float(last - first + 1)
            speed = length / (0.1 * num_frames)
            errors.append((first, r_err / length, t_err / length, length, speed))
    return errors


def seq_error(poses_gt: np.ndarray, poses_result: np.ndarray):
    """Returns (avg_trans_error_percent, avg_rot_error_deg_per_m)
    (reference Metrics.cpp:140-155; note the deliberate /3.14*180)."""
    errors = calc_sequence_errors(poses_gt, poses_result)
    if not errors:
        return float("nan"), float("nan")
    t_err = sum(e[2] for e in errors)
    r_err = sum(e[1] for e in errors)
    n = float(len(errors))
    avg_t = 100.0 * (t_err / n)
    avg_r = 100.0 * (r_err / n) / 3.14 * 180.0
    return avg_t, avg_r


def umeyama(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Rigid (no-scale) Umeyama: dst ~= R src + t, as Eigen::umeyama(...,
    false) used at Metrics.cpp:169. src/dst: (3, N)."""
    mu_s = src.mean(axis=1, keepdims=True)
    mu_d = dst.mean(axis=1, keepdims=True)
    cov = (dst - mu_d) @ (src - mu_s).T / src.shape[1]
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    t = mu_d - R @ mu_s
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t[:, 0]
    return T


def absolute_trajectory_error(poses_gt: np.ndarray, poses_result: np.ndarray):
    """Returns (ATE_rot_rmse_rad, ATE_trans_rmse_m)
    (reference Metrics.cpp:157-191)."""
    assert len(poses_gt) == len(poses_result)
    src = poses_result[:, :3, 3].T
    dst = poses_gt[:, :3, 3].T
    T_align = umeyama(src, dst)
    rot_sq, trans_sq = 0.0, 0.0
    for gt, res in zip(poses_gt, poses_result):
        est = T_align @ res
        delta_R = gt[:3, :3] @ est[:3, :3].T
        delta_t = gt[:3, 3] - delta_R @ est[:3, 3]
        theta = rotation_error(np.block([[delta_R, np.zeros((3, 1))], [np.zeros((1, 3)), np.ones((1, 1))]]))
        rot_sq += theta * theta
        trans_sq += float(delta_t @ delta_t)
    n = len(poses_gt)
    return float(np.sqrt(rot_sq / n)), float(np.sqrt(trans_sq / n))
