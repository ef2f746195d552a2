"""mujoco_sim_tpu_torch: the batched physics step of mujoco_sim_tpu, ported
to PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

Imports torch and numpy only (never jax or mujoco_sim_tpu).  Typical use::

    import torch
    import mujoco_sim_tpu_torch as mst
    m = mst.put_model(mst.load_model("scene.xml"))     # float32, on the card
    d = mst.make_data(m, nenv=4096)
    d = mst.rollout(m, d, nsteps=1000)
"""

from mujoco_sim_tpu_torch.engine import (  # noqa: F401
    put_model, make_data, forward, step, step1, step2, step_with_control,
    inverse, set_const,
)
from mujoco_sim_tpu_torch.models.compile import (  # noqa: F401
    load_model, compile_spec,
)
from mujoco_sim_tpu_torch.models.model import (  # noqa: F401
    Model, Data, Option, Contact, JointType, GeomType, EqType, Integrator,
    DisableBit,
)
from mujoco_sim_tpu_torch.parallel.rollout import (  # noqa: F401
    batched_step, rollout,
)


def load_urdf_model(path: str, **kw):
    """Compile a URDF file to a host Model (pass it through put_model)."""
    from mujoco_sim_tpu_torch.models.urdf import compile_urdf

    return compile_urdf(path, **kw)
