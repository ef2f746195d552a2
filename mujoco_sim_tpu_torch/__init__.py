"""mujoco_sim_tpu_torch: the batched physics step of mujoco_sim_tpu, ported
to PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

Imports torch and numpy only (never jax or mujoco_sim_tpu).  Typical use::

    import torch
    import mujoco_sim_tpu_torch as mst
    m = mst.put_model(mst.load_model("scene.xml"), torch.float32, "cuda")
    d = mst.make_data(m, nenv=4096)
    d = mst.rollout(m, d, nsteps=1000)
"""

from mujoco_sim_tpu_torch.engine import (  # noqa: F401
    put_model, make_data, forward, step, set_const,
)
from mujoco_sim_tpu_torch.models.compile import load_model  # noqa: F401
from mujoco_sim_tpu_torch.models.model import Model, Data  # noqa: F401
from mujoco_sim_tpu_torch.parallel.rollout import (  # noqa: F401
    batched_step, rollout,
)
