"""Blocking JSON-lines client for SimServer (test-driver equivalent of the
reference's rospy service proxies, test/test_spawn_and_destroy.py:58-66)."""

from __future__ import annotations

import json
import socket


class SimClient:
    def __init__(self, host="127.0.0.1", port=7500, timeout=120.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.f = self.sock.makefile("rw")

    def call(self, op: str, **kw) -> dict:
        req = {"op": op, **kw}
        self.f.write(json.dumps(req) + "\n")
        self.f.flush()
        line = self.f.readline()
        if not line:
            raise ConnectionError("server closed")
        return json.loads(line)

    def spawn_objects(self, objects) -> list[str]:
        return self.call("spawn_objects", objects=objects)["names"]

    def destroy_objects(self, names) -> list[dict]:
        return self.call("destroy_objects", names=names)["object_states"]

    def reset(self) -> bool:
        return self.call("reset").get("success", False)

    def screenshot(self, out_dir="/tmp/mst_screenshot", name="snapshot"):
        return self.call("screenshot", out_dir=out_dir, name=name)

    def cmd_vel(self, robot: str, twist):
        return self.call("cmd_vel", robot=robot, twist=list(twist))

    def get_state(self, names=None) -> dict:
        return self.call("get_state", names=names)

    def subscribe(self, topics, rate=60.0):
        """Generator of streamed messages (closes on iterator exit)."""
        req = {"op": "subscribe", "topics": topics, "rate": rate}
        self.f.write(json.dumps(req) + "\n")
        self.f.flush()
        try:
            for line in self.f:
                yield json.loads(line)
        finally:
            self.close()

    def subscribe_latest(self, topics, rate=60.0):
        """Like subscribe, but each yield drains the socket and returns only
        the NEWEST complete message.  A consumer slower than the publish
        rate otherwise reads an ever-growing backlog — the cross-server
        state sync was applying minutes-stale peer poses (its per-message
        jax update runs ~30/s vs the 120 Hz stream, and the peer's jit
        -compile window alone queues hundreds of t=0 messages).  Reads the
        raw socket; do not interleave with call()."""
        import select

        req = {"op": "subscribe", "topics": topics, "rate": rate}
        self.f.write(json.dumps(req) + "\n")
        self.f.flush()
        buf = b""
        try:
            while True:
                data = self.sock.recv(65536)      # block for fresh bytes
                if not data:
                    return
                buf += data
                while True:                        # greedy drain
                    r, _, _ = select.select([self.sock], [], [], 0.0)
                    if not r:
                        break
                    data = self.sock.recv(65536)
                    if not data:
                        break
                    buf += data
                *lines, buf = buf.split(b"\n")     # keep the partial tail
                lines = [ln for ln in lines if ln.strip()]
                if lines:
                    yield json.loads(lines[-1])
        finally:
            self.close()

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass
