"""Frozen copy of mujoco_sim_tpu_torch's CPU path for the benchmark's
plain reference (bench_port/refsim): imports rewritten, CUDA wrappers
and graph capture removed.  Do not import the program from here.

Host-side (numpy) rotation helpers for the model compiler."""

from __future__ import annotations

import numpy as np


def quat_mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def axis_angle_quat(axis: np.ndarray, angle: float) -> np.ndarray:
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * np.asarray(axis)])


def euler_to_quat(euler: np.ndarray, seq: str = "xyz") -> np.ndarray:
    """MJCF eulerseq semantics: lowercase = intrinsic (moving axes) rotations,
    i.e. q = q1*q2*q3 for seq 'xyz'; uppercase would be extrinsic."""
    axes = {"x": np.array([1.0, 0, 0]), "y": np.array([0, 1.0, 0]),
            "z": np.array([0, 0, 1.0])}
    q = np.array([1.0, 0, 0, 0])
    for ch, ang in zip(seq, euler):
        qi = axis_angle_quat(axes[ch.lower()], ang)
        if ch.islower():
            q = quat_mul_np(q, qi)      # intrinsic: post-multiply
        else:
            q = quat_mul_np(qi, q)      # extrinsic: pre-multiply
    return q / np.linalg.norm(q)


def zaxis_to_quat(z: np.ndarray) -> np.ndarray:
    """Minimal rotation taking (0,0,1) to z."""
    z = np.asarray(z, dtype=float)
    z = z / np.linalg.norm(z)
    e3 = np.array([0.0, 0.0, 1.0])
    c = float(np.dot(e3, z))
    if c > 1 - 1e-12:
        return np.array([1.0, 0, 0, 0])
    if c < -1 + 1e-12:
        return np.array([0.0, 1.0, 0, 0])  # 180 deg about x
    axis = np.cross(e3, z)
    axis = axis / np.linalg.norm(axis)
    return axis_angle_quat(axis, np.arccos(c))


def mat_to_quat_np(m: np.ndarray) -> np.ndarray:
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                      (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = np.array([(m[2, 1] - m[1, 2]) / s, 0.25 * s,
                      (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s])
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = np.array([(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s,
                      0.25 * s, (m[1, 2] + m[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = np.array([(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                      (m[1, 2] + m[2, 1]) / s, 0.25 * s])
    q = q / np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    return q


def quat_to_mat_np(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def xyaxes_to_quat(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    x = np.asarray(x, float)
    x = x / np.linalg.norm(x)
    y = np.asarray(y, float)
    y = y - x * np.dot(x, y)
    y = y / np.linalg.norm(y)
    z = np.cross(x, y)
    return mat_to_quat_np(np.stack([x, y, z], axis=1))


def rot_vec_np(v: np.ndarray, q: np.ndarray) -> np.ndarray:
    w, u = q[0], q[1:]
    uv = np.cross(u, v)
    return v + 2 * (w * uv + np.cross(u, uv))
