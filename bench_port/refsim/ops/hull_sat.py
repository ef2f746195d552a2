"""Frozen copy of mujoco_sim_tpu_torch's CPU path for the benchmark's
plain reference (bench_port/refsim): imports rewritten, CUDA wrappers
and graph capture removed.  Do not import the program from here.

Hull face-SAT reference-face depth query: hand-written CUDA kernel + twin.

Port of mujoco_sim_tpu/ops/pallas_sat.py (kernel) and of the plain form of
mujoco_sim_tpu/ops/collision._hull_ref_face_depth (twin).  The query is
the hot op of the mesh narrowphase: V points of one hull against the F
face planes of another, the SAT reference face, the vertex depths along
its normal, an optional lateral filter and the K smallest depths.

``hull_ref_face_depth`` picks its path from the tensor's device, never
from a switch: a CUDA tensor launches csrc/hull_sat.cu (built by
ops/cuda_build.py at first use) or raises; a CPU tensor takes the plain
twin.  ``LAUNCHES`` counts kernel launches and nothing else.
"""

from __future__ import annotations


import torch


# the opt-in shared memory of one block on the H100 (and H200)
SMEM_BYTES = 232448


def smem_fits(V: int, F: int) -> bool:
    """Whether one warp's tables fit a block's shared memory: the limit of
    both face-SAT kernels (csrc/face_sat.cuh, stage_floats / team_floats):
    a double buffer of the points, mask, planes (padded to a multiple of
    8) and slack a team, F + 2 V floats of scratch above V = 32, four teams
    a warp up to V = 32.  That is F <= ~1780 up to V = 32 and
    10 V + 9 F <= ~58 000 beyond."""
    r4 = lambda n: (n + 3) // 4 * 4
    stage = r4(3 * V) + r4(V) + 4 * ((F + 7) // 8 * 8) + 4
    teams, scratch = (4, 0) if V <= 32 else (1, r4(F + 2 * V))
    return teams * (2 * stage + scratch) * 4 <= SMEM_BYTES


def _pts_vs_planes(pts_local, planes):
    """(..., k, 3) x (..., f, 4) -> signed distances (..., k, f), as
    broadcast-multiply + reduce over the 3-axis."""
    prod = pts_local[..., :, None, :] * planes[..., None, :, :3]
    return prod.sum(-1) - planes[..., None, :, 3]


def top_k_largest(x: torch.Tensor, k: int):
    """(values, indices) of the k LARGEST of x along the last axis.

    k argmax/mask passes: ties resolve to the lowest index (torch.argmax
    returns the first maximum), the tie order of the JAX package.  Never
    torch.topk/sort here: their tie order is not fixed.
    """
    n = x.shape[-1]
    if k >= n:
        # every element is selected; callers mask by value, so identity
        # order suffices
        idx = torch.arange(n, device=x.device).expand(x.shape)
        return x, idx
    iota = torch.arange(n, device=x.device)
    cur = x
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(cur, dim=-1)
        v = torch.amax(cur, dim=-1)
        vals.append(v)
        idxs.append(i)
        cur = torch.where(iota == i[..., None], -torch.inf, cur)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def hull_ref_face_depth_plain(pts_local, planes, k_out, pts_mask=None,
                              lateral_filter=False, lateral_slack=0.0):
    """Plain PyTorch version (any device, any float dtype, any leading
    dims): materializes the (..., V, F) support tensor."""
    vals = _pts_vs_planes(pts_local, planes)    # (..., V, F)
    if pts_mask is not None:
        vals = torch.where(pts_mask[..., :, None] > 0.5, vals, 1e9)
    per_face_min = vals.amin(dim=-2)            # (..., F) support separation
    sep = per_face_min.amax(dim=-1)             # >0 => a face separates
    ref_f = torch.argmax(per_face_min, dim=-1)  # first maximum
    plane = torch.take_along_dim(
        planes, ref_f[..., None, None].expand(ref_f.shape + (1, 4)),
        dim=-2)[..., 0, :]
    nref = plane[..., :3]
    depth = (pts_local * nref[..., None, :]).sum(-1) - plane[..., 3:4]
    if lateral_filter:
        vert_sdf = vals.amax(dim=-1)            # (..., V) true convex sdf
        slack = torch.as_tensor(lateral_slack, dtype=depth.dtype,
                                device=depth.device)[..., None] + 1e-4
        keep = vert_sdf <= torch.clamp(depth, min=0.0) + slack
        # edge/vertex-region contacts can have EVERY vert laterally
        # outside; keep the raw manifold then rather than emitting nothing
        any_keep = keep.any(dim=-1, keepdim=True)
        depth = torch.where(keep | ~any_keep, depth, 1e9)
    if pts_mask is not None:
        depth = torch.where(pts_mask > 0.5, depth, 1e9)
    neg, idx = top_k_largest(-depth, k_out)
    return -neg, idx, nref, sep



def hull_ref_face_depth(pts_local, planes, k_out, pts_mask=None,
                        lateral_filter=False, lateral_slack=0.0):
    """Vertex depths measured along the face-normal SAT axis.

    The reference face maximizes (over faces) the minimum (over points)
    signed distance: for face-dominated contact this is the true MTV axis.
    lateral_filter drops vertices laterally OUTSIDE the other hull (their
    max-over-faces sdf exceeds their ref-face depth + slack), unless that
    drops all of them.  Returns (depth (..., k_out), point idx (..., k_out),
    nref (..., 3) local, sep (...,)).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    twin.
    """
    if pts_local.device.type == "cpu":
        return hull_ref_face_depth_plain(pts_local, planes, k_out, pts_mask,
                                         lateral_filter, lateral_slack)
    raise ValueError(f"hull_ref_face_depth: unsupported device "
                     f"{pts_local.device}")
