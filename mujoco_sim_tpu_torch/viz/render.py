"""Offscreen scene renderer (MjVisual equivalent, headless-first).

The reference's GLFW window (src/mujoco_sim/mj_visual.cpp) renders the scene
at 60 FPS with a HUD showing sim time / RTF / timestep / energy
(mj_visual.cpp:174-182).  Here: matplotlib-Agg offscreen rendering of the
geom set with the same HUD, driven from Data snapshots — suitable for
headless containers; the interactive client consumes the SimServer state
stream instead of sharing memory.
"""

from __future__ import annotations

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from mpl_toolkits.mplot3d import Axes3D  # noqa: F401,E402
from mpl_toolkits.mplot3d.art3d import Poly3DCollection  # noqa: E402

from mujoco_sim_tpu_torch.models.model import GeomType  # noqa: E402

_UNIT_BOX_FACES = None


def _box_faces():
    global _UNIT_BOX_FACES
    if _UNIT_BOX_FACES is None:
        c = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                      for sz in (-1, 1)], dtype=float)
        idx = [[0, 1, 3, 2], [4, 5, 7, 6], [0, 1, 5, 4],
               [2, 3, 7, 6], [0, 2, 6, 4], [1, 3, 7, 5]]
        _UNIT_BOX_FACES = (c, idx)
    return _UNIT_BOX_FACES


def _sphere_mesh(n=10):
    u = np.linspace(0, 2 * np.pi, n)
    v = np.linspace(0, np.pi, n)
    x = np.outer(np.cos(u), np.sin(v))
    y = np.outer(np.sin(u), np.sin(v))
    z = np.outer(np.ones_like(u), np.cos(v))
    return x, y, z


def render_frame(m, d, path: str, *, rtf: float | None = None,
                 elev=20.0, azim=45.0, lim=None, figsize=(8, 6)):
    """Render one frame to a PNG file; returns the path."""
    lay = m.layout
    xpos = np.asarray(d.geom_xpos)
    xmat = np.asarray(d.geom_xmat)
    active = np.asarray(d.body_active)

    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(projection="3d")
    centers = []

    for g in range(m.ngeom):
        if not active[lay.geom_bodyid[g]]:
            continue
        t = GeomType(int(lay.geom_type[g]))
        # Data-resident geometry (spawn-time size/rgba overrides)
        size = np.asarray(d.geom_size[g])
        rgba = np.asarray(d.geom_rgba[g])
        p, R = xpos[g], xmat[g]
        color = rgba[:3]
        alpha = float(min(1.0, rgba[3]))
        if t == GeomType.PLANE:
            s = 2.0
            corners = np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0],
                                [-s, s, 0]])
            pts = (R @ corners.T).T + p
            ax.add_collection3d(Poly3DCollection(
                [pts], facecolor="0.85", edgecolor="0.6", alpha=0.5))
        elif t == GeomType.SPHERE:
            x, y, z = _sphere_mesh()
            r = size[0]
            pts = np.stack([x, y, z], -1) * r @ R.T + p
            ax.plot_surface(pts[..., 0], pts[..., 1], pts[..., 2],
                            color=color, alpha=alpha, linewidth=0)
            centers.append(p)
        elif t in (GeomType.BOX,):
            c, idx = _box_faces()
            world = (R @ (c * size).T).T + p
            faces = [[world[i] for i in f] for f in idx]
            ax.add_collection3d(Poly3DCollection(
                faces, facecolor=color, edgecolor="k", linewidths=0.3,
                alpha=alpha))
            centers.append(p)
        elif t in (GeomType.CYLINDER, GeomType.CAPSULE):
            n = 12
            th = np.linspace(0, 2 * np.pi, n)
            circ = np.stack([size[0] * np.cos(th), size[0] * np.sin(th)], -1)
            top = np.concatenate([circ, np.full((n, 1), size[1])], -1)
            bot = np.concatenate([circ, np.full((n, 1), -size[1])], -1)
            wt = (R @ top.T).T + p
            wb = (R @ bot.T).T + p
            faces = [[wt[i], wt[(i + 1) % n], wb[(i + 1) % n], wb[i]]
                     for i in range(n)]
            faces += [list(wt), list(wb)]
            ax.add_collection3d(Poly3DCollection(
                faces, facecolor=color, alpha=alpha, linewidths=0.2,
                edgecolor="k"))
            centers.append(p)
        elif t == GeomType.MESH:
            # RAW triangle surface when the compile stored it (visual
            # fidelity: non-convex assets like the cup render true — the
            # reference renders the real mesh via GL, mj_visual.cpp:
            # 141-189); hull-face rings otherwise (r2-r4 behavior)
            mid_ = int(lay.geom_dataid[g])
            fn = (int(lay.mesh_visfacenum[mid_])
                  if hasattr(lay, "mesh_visfacenum") else 0)
            faces = []
            if fn > 0:
                va = int(lay.mesh_visvertadr[mid_])
                vn = int(lay.mesh_visvertnum[mid_])
                fa = int(lay.mesh_visfaceadr[mid_])
                verts = np.asarray(lay.mesh_visvert[va:va + vn])
                world = (R @ verts.T).T + p
                tri = np.asarray(lay.mesh_visface[fa:fa + fn])
                faces = [list(world[f3]) for f3 in tri]
            else:
                hid = int(lay.geom_hullid[g])
                fpoly = np.asarray(m.mesh_fpoly[hid])
                fmask = np.asarray(m.mesh_fmask[hid]) > 0.5
                for ring in fpoly[fmask]:
                    keep = [ring[0]]
                    for v in ring[1:]:
                        if not np.allclose(v, keep[-1]):
                            keep.append(v)
                    wr = (R @ np.asarray(keep).T).T + p
                    faces.append(list(wr))
            ax.add_collection3d(Poly3DCollection(
                faces, facecolor=color, alpha=alpha, linewidths=0.2,
                edgecolor="k"))
            centers.append(p)

    if lim is None:
        if centers:
            cs = np.asarray(centers)
            mid = cs.mean(axis=0)
            r = max(1.0, float(np.abs(cs - mid).max()) * 1.8)
        else:
            mid, r = np.zeros(3), 2.0
        lim = (mid, r)
    mid, r = lim
    ax.set_xlim(mid[0] - r, mid[0] + r)
    ax.set_ylim(mid[1] - r, mid[1] + r)
    ax.set_zlim(max(-0.05, mid[2] - r), mid[2] + r)
    ax.view_init(elev=elev, azim=azim)
    ax.set_box_aspect((1, 1, 1))

    # HUD (mj_visual.cpp:174-182 parity: time / RTF / dt / energy)
    energy = np.asarray(d.energy)
    hud = (f"time  {float(d.time):8.3f} s\n"
           f"RTF   {rtf if rtf is not None else float('nan'):8.2f}\n"
           f"dt    {float(m.opt.timestep):8.4f} s\n"
           f"energy {float(energy[0]):+.3f} / {float(energy[1]):+.3f}")
    ax.text2D(0.02, 0.98, hud, transform=ax.transAxes, family="monospace",
              fontsize=8, va="top")
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def render_rollout(m, frames, out_dir: str, prefix="frame"):
    """Render a sequence of Data snapshots to numbered PNGs."""
    import os
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    lim = None
    for i, d in enumerate(frames):
        paths.append(render_frame(m, d, os.path.join(
            out_dir, f"{prefix}_{i:04d}.png"), lim=lim))
    return paths
