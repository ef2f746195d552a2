"""Live viewer client: renders a running SimServer's marker stream.

The reference's MjVisual is an in-process GLFW window with mouse camera and
keyboard spawning (src/mujoco_sim/mj_visual.cpp:56-189, keyboard spawn
src/mj_main.cpp:40-46).  TPU-native equivalent: the sim runs wherever the
chips are; this client connects over TCP, consumes the ``markers`` stream at
the configured rate and renders with matplotlib — interactively when a
display exists (mouse-drag camera via the 3D axes + arrow/+/- keys), or
frame-dump mode for headless use.  Keys: b/s/c spawn box/sphere/cylinder
(random size/color, like the reference's 'b' key), x destroys the newest
spawned object, q quits.
"""

from __future__ import annotations

import math
import random

import numpy as np

from mujoco_sim_tpu_torch.io.client import SimClient


class LiveViewer:
    def __init__(self, host="127.0.0.1", port=7500, rate=60.0,
                 interactive: bool | None = None, out_dir: str | None = None,
                 spawn_classes: dict | None = None):
        import matplotlib
        if interactive is None:
            import os
            interactive = bool(os.environ.get("DISPLAY"))
        if not interactive:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        self.plt = plt
        self.host, self.port, self.rate = host, port, rate
        self.interactive = interactive
        self.out_dir = out_dir
        self.client = SimClient(host, port)      # control channel
        # key -> (spawnable class, ObjectInfo.type) for b/s/c
        self.spawn_classes = spawn_classes or {
            "b": ("cube", 0), "s": ("sphere", 1), "c": ("cylinder", 2)}
        self.spawned: list[str] = []
        self.azim, self.elev, self.zoom = 45.0, 20.0, 2.0
        self.fig = plt.figure(figsize=(7, 6))
        self.ax = self.fig.add_subplot(projection="3d")
        self.fig.canvas.mpl_connect("key_press_event", self._on_key)
        self._frame = 0

    # ---------------- keyboard (mj_main.cpp:40-46 parity) ----------------
    def _on_key(self, ev):
        if ev.key in self.spawn_classes:
            cls, typ = self.spawn_classes[ev.key]
            r = random.uniform(0.04, 0.1)
            ang = random.uniform(0, 2 * math.pi)
            try:
                names = self.client.spawn_objects([{
                    "info": {"name": cls, "type": typ,
                             "size": [r, r, r],
                             "rgba": [random.random(), random.random(),
                                      random.random(), 1.0]},
                    "class": cls,
                    "pose": [0.5 * math.cos(ang), 0.5 * math.sin(ang),
                             0.5, 1, 0, 0, 0]}])
                self.spawned.extend(names)
            except Exception:
                pass
        elif ev.key == "x" and self.spawned:
            try:
                self.client.destroy_objects([self.spawned.pop()])
            except Exception:
                pass
        elif ev.key == "left":
            self.azim -= 10
        elif ev.key == "right":
            self.azim += 10
        elif ev.key == "up":
            self.elev = min(89, self.elev + 5)
        elif ev.key == "down":
            self.elev = max(-89, self.elev - 5)
        elif ev.key in ("+", "="):
            self.zoom = max(0.3, self.zoom * 0.8)
        elif ev.key == "-":
            self.zoom = min(20.0, self.zoom * 1.25)
        elif ev.key == "q":
            self._running = False

    # ---------------- drawing ----------------
    def _draw(self, msg: dict):
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection
        ax = self.ax
        ax.cla()
        markers = msg.get("markers", {}).get("markers", [])
        t = msg.get("markers", {}).get("time", 0.0)
        for mk in markers:
            typ = mk["type"]
            p = np.asarray(mk["position"])
            R = np.asarray(mk.get("mat", np.eye(3).ravel())).reshape(3, 3)
            size = np.asarray(mk["size"])
            rgba = mk.get("rgba", [0.5, 0.5, 0.5, 1.0])
            color, alpha = rgba[:3], min(1.0, rgba[3])
            if typ == 0:     # plane
                s = 1.5
                corners = np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0],
                                    [-s, s, 0]])
                ax.add_collection3d(Poly3DCollection(
                    [(R @ corners.T).T + p], facecolor="0.85",
                    edgecolor="0.6", alpha=0.4))
            elif typ == 6:   # box
                c = np.array([[sx, sy, sz] for sx in (-1, 1)
                              for sy in (-1, 1) for sz in (-1, 1)])
                w = (R @ (c * size).T).T + p
                idx = [[0, 1, 3, 2], [4, 5, 7, 6], [0, 1, 5, 4],
                       [2, 3, 7, 6], [0, 2, 6, 4], [1, 3, 7, 5]]
                ax.add_collection3d(Poly3DCollection(
                    [[w[i] for i in f] for f in idx], facecolor=color,
                    edgecolor="k", linewidths=0.3, alpha=alpha))
            elif typ in (3, 5):  # capsule/cylinder: axis segment + end dots
                axis = R[:, 2] * size[1]
                seg = np.stack([p - axis, p + axis])
                ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], c=color,
                        linewidth=8, alpha=alpha, solid_capstyle="round")
            else:            # sphere/ellipsoid/mesh -> dot scaled by size
                ax.scatter([p[0]], [p[1]], [p[2]], s=2000 * max(
                    size[0], 0.02), c=[color], alpha=alpha)
        z = self.zoom
        ax.set_xlim(-z, z)
        ax.set_ylim(-z, z)
        ax.set_zlim(-0.05, 1.5 * z)
        ax.view_init(elev=self.elev, azim=self.azim)
        ax.set_box_aspect((1, 1, 0.8))
        ax.text2D(0.02, 0.98, f"t = {t:7.3f} s   [{len(markers)} geoms]  "
                  "keys: b/s/c spawn, x destroy, arrows/+/- camera, q quit",
                  transform=ax.transAxes, fontsize=7, va="top")

    def run(self, max_frames: int | None = None):
        """Consume the stream; returns number of frames rendered."""
        import os
        stream_client = SimClient(self.host, self.port)
        self._running = True
        n = 0
        if self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
        for msg in stream_client.subscribe(["markers"], rate=self.rate):
            if not self._running:
                break
            self._draw(msg)
            if self.interactive:
                self.plt.pause(0.001)
            if self.out_dir:
                self.fig.savefig(os.path.join(
                    self.out_dir, f"live_{self._frame:05d}.png"), dpi=90)
            self._frame += 1
            n += 1
            if max_frames is not None and n >= max_frames:
                break
        stream_client.close()
        return n

    def close(self):
        self._running = False
        self.client.close()
        self.plt.close(self.fig)
