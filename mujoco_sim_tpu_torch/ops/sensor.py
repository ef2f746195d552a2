"""Sensors (port of mujoco_sim_tpu/ops/sensor.py over a leading env axis).

The interaction wrench through a site's body is recovered from the subtree
momentum balance:  F_cut = sum_subtree (I cacc + v x* I v) - contacts - xfrc
(gravity rides in cacc via the base-acceleration trick).  Matches
mj_rnePostConstraint-based sensordata.

Sensor ids and addresses are Layout constants, so the loop over sensors
unrolls into static column indices; the pieces are collected in address
order and concatenated once into ``sensordata`` (B, nsensordata).
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_sim_tpu_torch.models.model import (
    Model, Data, SensorType, ObjType, GeomType, ConeType, DisableBit,
    contact_rows_per)
from mujoco_sim_tpu_torch.ops import math as mm

def _mtv(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R^T v for R (..., 3, 3), v (..., 3)."""
    return (R * v[..., :, None]).sum(-2)


def _contact_rows(m: Model, dtype):
    """(K, nrows) efc row address of every contact slot, on the device."""
    K = m.ncon_max
    nrows = contact_rows_per(m.max_condim, m.opt.cone)
    return m.layout.const(
        ("sensor_conrows", m.opt.cone, K, m.max_condim, m.contact_efcadr),
        lambda: (np.arange(K)[:, None] * nrows + m.contact_efcadr
                 + np.arange(nrows)[None, :]).astype(np.int64), dtype)


def _contact_bodies(m: Model, d: Data):
    """(b1, b2) body ids (B, K) of each contact slot: a device gather.
    Empty slots (geom -1) read geom 0; their forces are zero."""
    gb = m.layout.dev.geom_bodyid
    con = d.contact
    return (gb[torch.clamp(con.geom1.long(), min=0)],
            gb[torch.clamp(con.geom2.long(), min=0)])


def _contact_body_wrench(m: Model, d: Data, origin: torch.Tensor):
    """Per-body spatial wrench (B, nbody, 6) from active contacts (c-frame
    origin).

    Reconstructs each contact's world force/torque from its row forces
    (pyramidal: normal = sum of rows, tangent_i = mu_i*(f+ - f-);
    elliptic: the rows are [normal, t1, t2, tors, r1, r2] directly);
    rotational axes contribute torque.  Wrench applied positively to
    geom2's body, negatively to geom1's.
    """
    dtype = d.qpos.dtype
    B = d.qpos.shape[0]
    K = m.ncon_max
    if K == 0:
        return torch.zeros((B, m.nbody, 6), dtype=dtype, device=d.qpos.device)
    mc = m.max_condim
    con = d.contact
    b1, b2 = _contact_bodies(m, d)
    f_rows = d.efc_force[:, _contact_rows(m, dtype)]      # (B, K, nrows)
    n = con.frame[:, :, 0]
    t1, t2 = con.frame[:, :, 1], con.frame[:, :, 2]
    torque_local = torch.zeros_like(n)
    if mc == 1:
        force = f_rows[..., 0:1] * n
    elif m.opt.cone == int(ConeType.ELLIPTIC):
        fn = f_rows[..., 0]
        ft = f_rows[..., 1:]
        force = fn[..., None] * n + ft[..., 0:1] * t1
        if mc >= 3:
            force = force + ft[..., 1:2] * t2
        if mc >= 4:
            torque_local = torque_local + ft[..., 2:3] * n
        if mc >= 6:
            torque_local = (torque_local + ft[..., 3:4] * t1
                            + ft[..., 4:5] * t2)
    else:
        naxes = mc - 1
        f_plus = f_rows[..., 0::2][..., :naxes]
        f_minus = f_rows[..., 1::2][..., :naxes]
        fn = (f_plus + f_minus).sum(-1)
        mu = con.friction[..., :naxes]
        ft = mu * (f_plus - f_minus)  # per friction axis
        force = fn[..., None] * n
        # translational friction axes: t1, t2
        force = force + ft[..., 0:1] * t1
        if naxes >= 2:
            force = force + ft[..., 1:2] * t2
        if naxes >= 3:  # torsional about n
            torque_local = torque_local + ft[..., 2:3] * n
        if naxes >= 5:  # rolling
            torque_local = (torque_local + ft[..., 3:4] * t1
                            + ft[..., 4:5] * t2)
    act = con.active[..., None].to(dtype)
    force = force * act
    torque_local = torque_local * act
    # wrench about each body's c-frame origin, summed per body through a
    # one-hot product (a fixed summation order, no atomics)
    out = 0.0
    for sign, b in ((1.0, b2), (-1.0, b1)):
        r = con.pos - torch.take_along_dim(origin, b[..., None], dim=1)
        tau = torque_local + mm.cross(r, force)
        w = torch.cat([tau, force], dim=-1) * sign
        hot = torch.nn.functional.one_hot(b, m.nbody).to(dtype)
        out = out + torch.einsum("zkb,zku->zbu", hot, w)
    return out


def _point_in_site(m: Model, site: int, p_local):
    """Is the contact point inside the site's zone volume (touch sensor)?"""
    lay = m.layout
    t = int(lay.site_type[site])
    s = [float(v) for v in lay.site_size[site]]
    x, y, z = p_local[..., 0], p_local[..., 1], p_local[..., 2]
    if t == int(GeomType.BOX):
        return (x.abs() <= s[0]) & (y.abs() <= s[1]) & (z.abs() <= s[2])
    if t == int(GeomType.CAPSULE):
        zz = torch.clamp(z, -s[1], s[1])
        return x * x + y * y + (z - zz) ** 2 <= s[0] * s[0]
    if t == int(GeomType.CYLINDER):
        return (x * x + y * y <= s[0] * s[0]) & (z.abs() <= s[1])
    if t == int(GeomType.ELLIPSOID):
        return ((x / s[0]) ** 2 + (y / s[1]) ** 2 + (z / s[2]) ** 2) <= 1.0
    return (p_local * p_local).sum(-1) <= s[0] * s[0]   # sphere default


def _contact_normal_forces(m: Model, d: Data):
    """(B, K) normal-force magnitude per contact slot (touch sensor)."""
    dtype = d.qpos.dtype
    mc = m.max_condim
    f_rows = d.efc_force[:, _contact_rows(m, dtype)]
    if mc == 1 or m.opt.cone == int(ConeType.ELLIPTIC):
        fn = f_rows[..., 0]
    else:
        naxes = mc - 1
        fn = (f_rows[..., 0::2][..., :naxes]
              + f_rows[..., 1::2][..., :naxes]).sum(-1)
    return fn * d.contact.active.to(dtype)


def _subtree_mask_np(m: Model, bodyid: int) -> np.ndarray:
    lay = m.layout
    mask = np.zeros(m.nbody)
    for b in range(m.nbody):
        i = b
        while i > 0:
            if i == bodyid:
                mask[b] = 1.0
                break
            i = int(lay.body_parentid[i])
        if bodyid == 0:
            mask[b] = 1.0
    return mask


def _subtree_mask(m: Model, bodyid: int, dtype) -> torch.Tensor:
    return m.layout.const(("subtree_mask", bodyid),
                          lambda: _subtree_mask_np(m, bodyid), dtype)


def _body_cacc(m: Model, d: Data):
    """Body spatial accelerations (B, nbody, 6) including qacc and gravity
    (c-frame)."""
    dtype = d.qpos.dtype
    g = m.opt.gravity.to(dtype)
    a0 = torch.cat([torch.zeros_like(g), -g])
    contrib = d.cdof_dot * d.qvel[..., None] + d.cdof * d.qacc[..., None]
    # ancestor-or-self dof prefix sum as one constant-mask matmul
    return a0 + m.ancestor_mask.to(dtype) @ contrib


def sensors(m: Model, d: Data) -> Data:
    """mj_sensorPos/Vel/Acc equivalent over the supported mjtSensor surface
    (all stages evaluated post-forward, so every quantity is available)."""
    if m.nsensor == 0:
        return d
    from mujoco_sim_tpu_torch.engine import _cinert, _com_dict
    lay = m.layout
    dtype = d.qpos.dtype
    S = SensorType
    B = d.qpos.shape[0]

    origin = _com_dict(m, d)["origin"]                  # (B, nbody, 3)
    types = set(int(t) for t in lay.sensor_type)

    # subtree momentum balance: only for force/torque sensors
    if types & {int(S.FORCE), int(S.TORQUE)}:
        cinert = _cinert(m, d)
        cacc = _body_cacc(m, d)
        Iv = torch.einsum("zbuv,zbv->zbu", cinert, d.cvel)
        f_body = (torch.einsum("zbuv,zbv->zbu", cinert, cacc)
                  + mm.force_cross(d.cvel, Iv))
        f_ext = _contact_body_wrench(m, d, origin)
        xfrc = d.xfrc_applied
        r = d.xipos - origin
        tau_x = xfrc[..., :3] + mm.cross(r, xfrc[..., 3:])
        f_ext = f_ext + torch.cat([tau_x, xfrc[..., 3:]], dim=-1)
        f_net = f_body - f_ext
    if int(S.ACCELEROMETER) in types:
        cacc_a = _body_cacc(m, d)
    if int(S.TOUCH) in types:
        fn_con = _contact_normal_forces(m, d)
        con_b1, con_b2 = _contact_bodies(m, d)
    rf_rows = [k for k in range(m.nsensor)
               if int(lay.sensor_type[k]) == int(S.RANGEFINDER)]
    if rf_rows:
        # mj_ray semantics: ray from the site along its +Z axis, the
        # site's own body excluded, invisible (alpha=0, no material)
        # geoms skipped, -1 on miss
        from mujoco_sim_tpu_torch.ops import raycast
        sids_np = np.asarray(lay.sensor_objid)[np.asarray(rf_rows)]
        geom_mask = (np.asarray(lay.geom_bodyid)[None, :]
                     != np.asarray(lay.site_bodyid)[sids_np][:, None])
        geom_mask &= ~np.asarray(lay.geom_invisible)[None, :]
        sids = lay.const("rf_sites", lambda: sids_np.astype(np.int64), dtype)
        pnt = d.site_xpos[:, sids]
        vec = d.site_xmat[:, sids][..., :, 2]
        rf_dist = raycast.ray_all(m, d, pnt, vec, geom_mask, key="sensors")
        rf_val = torch.where(rf_dist > raycast.INF / 2, -1.0, rf_dist)
        rf_index = {k: i for i, k in enumerate(rf_rows)}

    def body_vel_at(bodyid, point):
        """world-frame (angvel, linvel) of a body-fixed point (cvel frame
        is the body's c-frame origin)."""
        cv = d.cvel[:, bodyid]
        ang, lin = cv[..., :3], cv[..., 3:]
        return ang, lin + mm.cross(ang, point - origin[:, bodyid])

    def frame_of(objtype, objid):
        """(pos, R, quat_fn, bodyid) of a frame-sensor object."""
        if objtype == int(ObjType.SITE):
            b = int(lay.site_bodyid[objid])
            q = lambda: mm.quat_mul(d.xquat[:, b],
                                    m.site_quat.to(dtype)[objid])
            return d.site_xpos[:, objid], d.site_xmat[:, objid], q, b
        if objtype == int(ObjType.GEOM):
            b = int(lay.geom_bodyid[objid])
            q = lambda: mm.quat_mul(d.xquat[:, b],
                                    m.geom_quat.to(dtype)[objid])
            return d.geom_xpos[:, objid], d.geom_xmat[:, objid], q, b
        if objtype == int(ObjType.XBODY):
            return (d.xpos[:, objid], mm.quat_to_mat(d.xquat[:, objid]),
                    lambda: d.xquat[:, objid], objid)
        # BODY: inertial frame
        q = lambda: mm.quat_mul(d.xquat[:, objid],
                                m.body_iquat.to(dtype)[objid])
        return d.xipos[:, objid], d.ximat[:, objid], q, objid

    pieces = {}
    for k in range(m.nsensor):
        st = int(lay.sensor_type[k])
        obj = int(lay.sensor_objid[k])
        adr = int(lay.sensor_adr[k])
        dim = int(lay.sensor_dim[k])
        cutoff = float(lay.sensor_cutoff[k])

        if st in (int(S.FORCE), int(S.TORQUE)):
            bodyid = int(lay.site_bodyid[obj])
            sub = _subtree_mask(m, bodyid, dtype)
            F = torch.einsum("b,zbu->zu", sub, f_net)
            rr = d.site_xpos[:, obj] - origin[:, bodyid]
            R = d.site_xmat[:, obj]
            val = (_mtv(R, F[:, 3:]) if st == int(S.FORCE)
                   else _mtv(R, F[:, :3] - mm.cross(rr, F[:, 3:])))
        elif st == int(S.CLOCK):
            val = d.time[:, None]
        elif st == int(S.JOINTPOS):
            val = d.qpos[:, int(lay.jnt_qposadr[obj])][:, None]
        elif st == int(S.JOINTVEL):
            val = d.qvel[:, int(lay.jnt_dofadr[obj])][:, None]
        elif st == int(S.BALLQUAT):
            a = int(lay.jnt_qposadr[obj])
            val = mm.quat_normalize(d.qpos[:, a:a + 4])
        elif st == int(S.BALLANGVEL):
            a = int(lay.jnt_dofadr[obj])
            val = d.qvel[:, a:a + 3]
        elif st == int(S.TENDONPOS):
            val = d.ten_length[:, obj][:, None]
        elif st == int(S.TENDONVEL):
            val = d.ten_velocity[:, obj][:, None]
        elif st == int(S.ACTUATORPOS):
            val = d.actuator_length[:, obj][:, None]
        elif st == int(S.ACTUATORVEL):
            val = d.actuator_velocity[:, obj][:, None]
        elif st == int(S.ACTUATORFRC):
            val = d.actuator_force[:, obj][:, None]
        elif st == int(S.RANGEFINDER):
            val = rf_val[:, rf_index[k]][:, None]
        elif st in (int(S.JOINTLIMITPOS), int(S.JOINTLIMITVEL),
                    int(S.JOINTLIMITFRC)):
            # value of the joint's limit efc row when active, else 0
            # (mjSENS_JOINTLIMIT* scan of d->efc in mj_sensorPos/Vel/Acc)
            rng = m.jnt_range.to(dtype)[obj]
            margin = m.jnt_margin.to(dtype)[obj]
            q = d.qpos[:, int(lay.jnt_qposadr[obj])]
            dist_lo = q - rng[0]
            dist_hi = rng[1] - q
            lower = dist_lo < dist_hi
            dist = torch.where(lower, dist_lo, dist_hi)
            sign = torch.where(lower, 1.0, -1.0).to(dtype)
            limit_on = not (m.opt.disableflags & int(DisableBit.LIMIT))
            active = dist < margin
            if not (bool(lay.jnt_limited[obj]) and limit_on):
                active = torch.zeros_like(active)
            if st == int(S.JOINTLIMITPOS):
                v_ = dist - margin
            elif st == int(S.JOINTLIMITVEL):
                v_ = sign * d.qvel[:, int(lay.jnt_dofadr[obj])]
            else:
                pos_in_list = np.nonzero(lay.lim_jntid == obj)[0]
                v_ = (d.efc_force[:, int(lay.lim_efcadr[pos_in_list[0]])]
                      if len(pos_in_list) else torch.zeros_like(q))
            val = torch.where(active, v_, 0.0)[:, None]
        elif st in (int(S.TENDONLIMITPOS), int(S.TENDONLIMITVEL),
                    int(S.TENDONLIMITFRC)):
            # the tendon's limit efc row when active, else 0
            rng = m.ten_range.to(dtype)[obj]
            margin = m.ten_margin.to(dtype)[obj]
            length = d.ten_length[:, obj]
            dist_lo = length - rng[0]
            dist_hi = rng[1] - length
            lower = dist_lo < dist_hi
            dist = torch.where(lower, dist_lo, dist_hi)
            sign = torch.where(lower, 1.0, -1.0).to(dtype)
            limit_on = not (m.opt.disableflags & int(DisableBit.LIMIT))
            active = dist < margin
            if not (bool(lay.ten_limited[obj]) and limit_on):
                active = torch.zeros_like(active)
            if st == int(S.TENDONLIMITPOS):
                v_ = dist - margin
            elif st == int(S.TENDONLIMITVEL):
                v_ = sign * d.ten_velocity[:, obj]
            else:
                pos_in_list = np.nonzero(lay.tlim_tenid == obj)[0]
                v_ = (d.efc_force[:, int(lay.tlim_efcadr[pos_in_list[0]])]
                      if len(pos_in_list) else torch.zeros_like(length))
            val = torch.where(active, v_, 0.0)[:, None]
        elif st == int(S.MAGNETOMETER):
            val = _mtv(d.site_xmat[:, obj], m.opt.magnetic.to(dtype))
        elif st == int(S.GYRO):
            b = int(lay.site_bodyid[obj])
            ang, _ = body_vel_at(b, d.site_xpos[:, obj])
            val = _mtv(d.site_xmat[:, obj], ang)
        elif st == int(S.VELOCIMETER):
            b = int(lay.site_bodyid[obj])
            _, lin = body_vel_at(b, d.site_xpos[:, obj])
            val = _mtv(d.site_xmat[:, obj], lin)
        elif st == int(S.ACCELEROMETER):
            # mj_objectAcceleration: spatial acc at the site point + the
            # rotating-frame correction ang x lin, in the site frame
            b = int(lay.site_bodyid[obj])
            ca = cacc_a[:, b]
            rr = d.site_xpos[:, obj] - origin[:, b]
            a_lin = ca[..., 3:] + mm.cross(ca[..., :3], rr)
            ang, lin = body_vel_at(b, d.site_xpos[:, obj])
            val = _mtv(d.site_xmat[:, obj], a_lin + mm.cross(ang, lin))
        elif st == int(S.TOUCH):
            b = int(lay.site_bodyid[obj])
            onb = (con_b1 == b) | (con_b2 == b)
            p_loc = _mtv(d.site_xmat[:, obj][:, None],
                         d.contact.pos - d.site_xpos[:, obj][:, None])
            inz = _point_in_site(m, obj, p_loc)
            val = torch.clamp(
                (fn_con * (onb & inz).to(dtype)).sum(-1), min=0.0)[:, None]
        elif st in (int(S.FRAMEPOS), int(S.FRAMEQUAT), int(S.FRAMEXAXIS),
                    int(S.FRAMEYAXIS), int(S.FRAMEZAXIS),
                    int(S.FRAMELINVEL), int(S.FRAMEANGVEL)):
            ot = int(lay.sensor_objtype[k])
            pos, R, quat_fn, b = frame_of(ot, obj)
            refid = int(lay.sensor_refid[k])
            ref = (frame_of(int(lay.sensor_reftype[k]), refid)
                   if refid >= 0 else None)
            if st == int(S.FRAMEPOS):
                val = (_mtv(ref[1], pos - ref[0]) if ref is not None
                       else pos)
            elif st == int(S.FRAMEQUAT):
                q = quat_fn()
                if ref is not None:
                    q = mm.quat_mul(mm.quat_inv(ref[2]()), q)
                val = mm.quat_normalize(q)
            elif st in (int(S.FRAMEXAXIS), int(S.FRAMEYAXIS),
                        int(S.FRAMEZAXIS)):
                axis = R[..., :, st - int(S.FRAMEXAXIS)]
                val = _mtv(ref[1], axis) if ref is not None else axis
            elif st == int(S.FRAMEANGVEL):
                ang, _ = body_vel_at(b, pos)
                if ref is not None:
                    ang_r, _ = body_vel_at(ref[3], ref[0])
                    ang = _mtv(ref[1], ang - ang_r)
                val = ang
            else:
                _, lin = body_vel_at(b, pos)
                if ref is not None:
                    # relative to the (moving, rotating) ref frame,
                    # expressed in it: R_r^T (v - v_r - w_r x (p - p_r))
                    ang_r, lin_r = body_vel_at(ref[3], ref[0])
                    lin = _mtv(ref[1], lin - lin_r
                               - mm.cross(ang_r, pos - ref[0]))
                val = lin
        elif st in (int(S.SUBTREECOM), int(S.SUBTREELINVEL),
                    int(S.SUBTREEANGMOM)):
            sub = _subtree_mask(m, obj, dtype)
            mass = d.body_mass.to(dtype) * sub          # (B, nbody)
            M = torch.clamp(mass.sum(-1, keepdim=True), min=1e-12)
            com_s = (mass[..., None] * d.xipos).sum(1) / M
            ang_b = d.cvel[..., :3]
            v_b = (d.cvel[..., 3:]
                   + mm.cross(ang_b, d.xipos - origin))  # v at body com
            v_com = (mass[..., None] * v_b).sum(1) / M
            if st == int(S.SUBTREECOM):
                val = com_s
            elif st == int(S.SUBTREELINVEL):
                val = v_com
            else:
                # L about the subtree com: sum I_i w_i + m r x v (relative)
                RI = d.ximat * d.body_inertia.to(dtype)[..., None, :]
                Iw = ((RI[..., :, None, :] * d.ximat[..., None, :, :]
                       ).sum(-1) @ ang_b[..., None])[..., 0]
                rel_r = d.xipos - com_s[:, None]
                rel_v = v_b - v_com[:, None]
                val = (sub[:, None] * (Iw + mass[..., None]
                                       * mm.cross(rel_r, rel_v))).sum(1)
        else:
            continue            # unsupported type defensively left zero

        val = val.reshape(B, dim).to(dtype)
        if cutoff > 0 and st not in (int(S.BALLQUAT), int(S.FRAMEQUAT)):
            if st in (int(S.TOUCH), int(S.RANGEFINDER)):
                # POSITIVE datatype: top clamp only (a -1 miss survives)
                val = torch.clamp(val, max=cutoff)
            else:
                val = torch.clamp(val, -cutoff, cutoff)
        pieces[adr] = val

    # one concatenation in address order; gaps (unsupported types) are zero
    cols, cursor = [], 0
    for adr in sorted(pieces):
        if adr > cursor:
            cols.append(torch.zeros((B, adr - cursor), dtype=dtype,
                                    device=d.qpos.device))
        cols.append(pieces[adr])
        cursor = adr + pieces[adr].shape[1]
    if cursor < m.nsensordata:
        cols.append(torch.zeros((B, m.nsensordata - cursor), dtype=dtype,
                                device=d.qpos.device))
    return d.replace(sensordata=torch.cat(cols, dim=1))
