"""Hull face-SAT reference-face depth query: hand-written CUDA kernel + twin.

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

import ctypes
import functools

import torch

from mujoco_sim_tpu_torch.ops import cuda_build

LAUNCHES = 0
SOURCE = cuda_build.source_path("hull_sat")
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


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = cuda_build.load("hull_sat")
    lib.hull_sat_f32.restype = ctypes.c_int
    lib.hull_sat_f32.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    return lib


def hull_ref_face_depth_cuda(pts_local, planes, k_out, pts_mask=None,
                             lateral_filter=False, lateral_slack=0.0):
    """Launch the CUDA kernel.  pts_local (..., V, 3), planes (..., F, 4),
    pts_mask (..., V) or None, lateral_slack a float or (...,): float32,
    contiguous, on one CUDA device.  A missing mask and a float slack reach
    the kernel as a null pointer and a float: nothing is allocated but the
    outputs."""
    global LAUNCHES
    fn = "hull_ref_face_depth_cuda"
    lead = pts_local.shape[:-2]
    V, F, K = pts_local.shape[-2], planes.shape[-2], int(k_out)
    if (pts_local.dim() < 3 or pts_local.shape[-1] != 3
            or planes.shape != lead + (F, 4)):
        raise ValueError(f"{fn}: shapes {tuple(pts_local.shape)} / "
                         f"{tuple(planes.shape)}")
    operands = dict(pts_local=pts_local, planes=planes)
    if pts_mask is not None:
        if pts_mask.shape != lead + (V,):
            raise ValueError(f"{fn}: mask shape {tuple(pts_mask.shape)}")
        operands["pts_mask"] = pts_mask
    slack_scalar = 0.0
    if isinstance(lateral_slack, torch.Tensor):
        if lateral_slack.shape != lead:
            raise ValueError(f"{fn}: slack shape "
                             f"{tuple(lateral_slack.shape)}")
        operands["slack"] = lateral_slack
    else:
        slack_scalar = float(lateral_slack)
    if not 1 <= K < V:
        raise ValueError(f"{fn}: k_out={K} must be in 1..V-1 (V={V})")
    if not smem_fits(V, F):
        raise ValueError(f"{fn}: V={V}, F={F} exceed the kernel's shared "
                         f"memory ({SMEM_BYTES} bytes a block)")
    dev = cuda_build.check_f32_cuda(fn, **operands)
    N = 1
    for s in lead:
        N *= s
    depth = torch.empty(lead + (K,), dtype=torch.float32, device=dev)
    idx = torch.empty(lead + (K,), dtype=torch.int64, device=dev)
    nref = torch.empty(lead + (3,), dtype=torch.float32, device=dev)
    sep = torch.empty(lead, dtype=torch.float32, device=dev)
    rc = cuda_build.launch(
        dev, _load().hull_sat_f32,
        pts_local.data_ptr(), planes.data_ptr(),
        None if pts_mask is None else pts_mask.data_ptr(),
        operands["slack"].data_ptr() if "slack" in operands else None,
        depth.data_ptr(), idx.data_ptr(), nref.data_ptr(), sep.data_ptr(),
        N, V, F, K, int(bool(lateral_filter)), slack_scalar)
    if rc != 0:
        raise RuntimeError(f"hull_sat kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    cuda_build.count_launch("hull_ref_face_depth", dev)
    return depth, idx, nref, sep


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
    if pts_local.device.type == "cuda":
        return hull_ref_face_depth_cuda(pts_local, planes, k_out, pts_mask,
                                        lateral_filter, lateral_slack)
    if pts_local.device.type == "cpu":
        return hull_ref_face_depth_plain(pts_local, planes, k_out, pts_mask,
                                         lateral_filter, lateral_slack)
    raise ValueError(f"hull_ref_face_depth: unsupported device "
                     f"{pts_local.device}")
