"""Quaternion and spatial (6D) algebra (port of mujoco_sim_tpu/ops/math.py).

Conventions match MuJoCo so that model/state round-trip with the reference
semantics:

* quaternions are (w, x, y, z), unit norm;
* spatial motion vectors are [angular(3); linear(3)];
* spatial force vectors are [torque(3); force(3)].

Everything broadcasts over arbitrary leading batch axes and keeps the dtype
and device of its inputs (f32 on the card, f64 on CPU for parity tests).
No function builds a constant on the host, so none copies to the device.
"""

from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting cross product over the last axis (jnp.cross)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis."""
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def _ident_quat(like: torch.Tensor) -> torch.Tensor:
    q = torch.zeros_like(like)
    q[..., 0].fill_(1.0)
    return q


# ---------------------------------------------------------------------------
# Quaternions
# ---------------------------------------------------------------------------

def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, (w,x,y,z)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (= inverse for unit quaternions)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = norm(q, keepdim=True)
    big = n > 1e-12
    # Degenerate quaternion -> identity, like mju_normalize4.
    safe = torch.where(big, q / torch.where(big, n, 1.0), 0.0)
    return torch.where(big, safe, _ident_quat(q))


def rot_vec_quat(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by quaternion q (active rotation, mju_rotVecQuat)."""
    w = q[..., :1]
    u = q[..., 1:]
    # v' = v + 2w (u x v) + 2 u x (u x v)
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def rot_vec_quat_inv(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return rot_vec_quat(v, quat_inv(q))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> 3x3 rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> quaternion, numerically robust branch-free mix."""
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    # Four candidate constructions; pick the best-conditioned one.
    qw = torch.stack(
        [
            1.0 + tr,
            m[..., 2, 1] - m[..., 1, 2],
            m[..., 0, 2] - m[..., 2, 0],
            m[..., 1, 0] - m[..., 0, 1],
        ],
        dim=-1,
    )
    qx = torch.stack(
        [
            m[..., 2, 1] - m[..., 1, 2],
            1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
            m[..., 0, 1] + m[..., 1, 0],
            m[..., 0, 2] + m[..., 2, 0],
        ],
        dim=-1,
    )
    qy = torch.stack(
        [
            m[..., 0, 2] - m[..., 2, 0],
            m[..., 0, 1] + m[..., 1, 0],
            1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
            m[..., 1, 2] + m[..., 2, 1],
        ],
        dim=-1,
    )
    qz = torch.stack(
        [
            m[..., 1, 0] - m[..., 0, 1],
            m[..., 0, 2] + m[..., 2, 0],
            m[..., 1, 2] + m[..., 2, 1],
            1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2],
        ],
        dim=-1,
    )
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
    scores = torch.stack(
        [
            tr,
            m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
            m[..., 1, 1] - m[..., 0, 0] - m[..., 2, 2],
            m[..., 2, 2] - m[..., 0, 0] - m[..., 1, 1],
        ],
        dim=-1,
    )
    best = torch.argmax(scores, dim=-1)     # first maximum, as jnp.argmax
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = quat_normalize(q)
    # Canonical sign: w >= 0.
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    half = 0.5 * angle
    s = torch.sin(half)
    xyz = axis * s[..., None]
    c = torch.cos(half)[..., None].expand(*xyz.shape[:-1], 1)
    return torch.cat([c, xyz], dim=-1)


def quat_integrate(q: torch.Tensor, omega_local: torch.Tensor, dt) -> torch.Tensor:
    """mju_quatIntegrate: rotate q by local angular velocity omega for dt."""
    scaled = omega_local * dt
    angle = norm(scaled)
    safe = torch.where(angle > 1e-14, angle, 1.0)
    axis = scaled / safe[..., None]
    dq = axis_angle_to_quat(axis, angle)
    dq = torch.where(angle[..., None] > 1e-14, dq, _ident_quat(dq))
    return quat_normalize(quat_mul(q, dq))


def quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """3D velocity that takes qb to qa in unit time (mju_subQuat): local frame."""
    dq = quat_mul(quat_inv(qb), qa)
    dq = dq * torch.where(dq[..., :1] < 0, -1.0, 1.0)  # shortest path
    sin_half = norm(dq[..., 1:])
    angle = 2.0 * torch.atan2(sin_half, dq[..., 0])
    safe = torch.where(sin_half > 1e-14, sin_half, 1.0)
    axis = dq[..., 1:] / safe[..., None]
    return torch.where(sin_half[..., None] > 1e-14, axis * angle[..., None],
                       2.0 * dq[..., 1:])


# ---------------------------------------------------------------------------
# Spatial algebra ([angular; linear] ordering)
# ---------------------------------------------------------------------------

def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product v x m."""
    vw, vl = v[..., :3], v[..., 3:]
    mw, ml = m[..., :3], m[..., 3:]
    return torch.cat(
        [cross(vw, mw), cross(vw, ml) + cross(vl, mw)], dim=-1
    )


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force (dual) cross product v x* f."""
    vw, vl = v[..., :3], v[..., 3:]
    fw, fl = f[..., :3], f[..., 3:]
    return torch.cat(
        [cross(vw, fw) + cross(vl, fl), cross(vw, fl)], dim=-1
    )


def skew(v: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(*v.shape[:-1], 3, 3)


def spatial_inertia(mass: torch.Tensor, inertia_mat: torch.Tensor,
                    com: torch.Tensor) -> torch.Tensor:
    """6x6 spatial inertia about a frame origin.

    mass (...,), inertia_mat (...,3,3) about the COM in the frame's
    orientation, com (...,3) COM offset from frame origin.
    Layout matches [ang; lin] vectors: f = I_spatial @ a.
    """
    c = skew(com)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=com.dtype, device=com.device).expand(c.shape)
    # c c^T for a skew matrix is (v.v)I - v v^T (elementwise, as the JAX
    # package writes it)
    vv = (com * com).sum(-1)[..., None, None]
    outer = com[..., :, None] * com[..., None, :]
    top_left = inertia_mat + m * (vv * eye - outer)
    top_right = m * c
    bot_left = -top_right        # skew^T = -skew
    bot_right = m * eye
    top = torch.cat([top_left, top_right], dim=-1)
    bot = torch.cat([bot_left, bot_right], dim=-1)
    return torch.cat([top, bot], dim=-2)


def transform_motion(v: torch.Tensor, pos: torch.Tensor,
                     rot_new_from_old: torch.Tensor) -> torch.Tensor:
    """Change coordinates of a motion vector.

    New frame origin at `pos` (expressed in old frame), orientation given by
    rotation matrix R mapping old-frame vectors to new-frame vectors.
    """
    w, l = v[..., :3], v[..., 3:]
    w_new = torch.einsum("...ij,...j->...i", rot_new_from_old, w)
    l_new = torch.einsum("...ij,...j->...i", rot_new_from_old,
                         l - cross(pos, w))
    return torch.cat([w_new, l_new], dim=-1)


def normalize_with_norm(v: torch.Tensor, eps: float = 1e-12):
    n = norm(v, keepdim=True)
    return v / torch.clamp(n, min=eps), n[..., 0]
