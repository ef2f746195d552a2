"""hull_ref_face_depth's share of its roofline (csrc/hull_sat.cu): the
mean bound of its launches (roofline.hull_sat_bound_s at the shapes each
call saw) over the mean device time of its kernels, both from one eager
step of the cell's law from the state the window ended at."""

import torch

from harness import roofline

UNIT = "%"
MODULE, FUNCTION = "mujoco_sim_tpu_torch.ops.hull_sat", \
    "hull_ref_face_depth_cuda"
KERNEL = "hull_sat_kernel"


def _shape(pts_local, planes, k_out, pts_mask=None, lateral_filter=False,
           lateral_slack=0.0):
    N = pts_local.numel() // (3 * pts_local.shape[-2])
    return (N, pts_local.shape[-2], planes.shape[-2], int(k_out),
            pts_mask is not None, bool(lateral_filter),
            isinstance(lateral_slack, torch.Tensor))


def prepare(probe):
    probe.wrap(MODULE, FUNCTION, _shape)


def read(ctx):
    return ctx.roofline_pct(FUNCTION, KERNEL, roofline.hull_sat_bound_s)
