"""Sensors (port of mujoco_sim_tpu/ops/sensor.py): only the sensor-free
case is ported so far; the sensor surface is ROADMAP §A.7."""

from __future__ import annotations

from mujoco_sim_tpu_torch.models.model import Model, Data


def sensors(m: Model, d: Data) -> Data:
    """mj_sensorPos/Vel/Acc equivalent: returns d unchanged when the model
    has no sensors."""
    if m.nsensor == 0:
        return d
    raise NotImplementedError("sensors are not ported yet (ROADMAP §A.7)")
