"""chol_solve's share of its roofline: the mean bound of its launches
(roofline.chol_solve_bound_s at the (N, n) each call saw) over the mean
device time of its kernels, both from one eager step of the cell's law
from the state the window ended at.  Eager, because a graph replay's
trace misnames launches inside WHILE bodies."""

from harness import roofline

UNIT = "%"
MODULE, FUNCTION = "mujoco_sim_tpu_torch.ops.chol", "chol_solve_cuda"
KERNEL = "chol_solve"


def prepare(probe):
    probe.wrap(MODULE, FUNCTION,
               lambda A, b: (b.numel() // A.shape[-1], A.shape[-1]))


def read(ctx):
    return ctx.roofline_pct(FUNCTION, KERNEL, roofline.chol_solve_bound_s)
