"""Face-SAT depth query returning the reference plane: CUDA kernel + twin.

Port of the TPU kernel benchmarks/pallas_sat_proto.py ``make_kernel`` and
its wrapper ``sat_pallas``: V points of one hull against the F face planes
of another; the SAT reference face (the face whose minimum support
distance is largest, lowest index on ties), every point's depth along it,
the K smallest depths with their indices, the reference PLANE (normal and
offset) and the separation.  Unlike ops/hull_sat.py there is no lateral
filter, the plane's offset is returned, and a picked entry is replaced by
1e9 (so when only masked entries remain the lowest index is picked again).

Nothing in the step calls it; its entry point is
scripts/torch_sat_proto.py.

``face_sat_depth`` picks its path from the tensor's device, never from a
switch: a CUDA tensor launches csrc/face_sat.cu (built by ops/cuda_build.py
at first use) or raises; a CPU tensor takes the plain twin.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mujoco_sim_tpu_torch.ops import cuda_build
from mujoco_sim_tpu_torch.ops.hull_sat import SMEM_BYTES, smem_fits
from mujoco_sim_tpu_torch.runtime import profiler

_BIG = 1e9


def face_sat_depth_plain(pts, planes, vmask, K=2):
    """Plain PyTorch version (any device, any float dtype, any leading
    dims), written from the TPU kernel's body: materializes the
    (..., V, F) support tensor.  Returns (depth (..., K), idx (..., K)
    int32, plane (..., 4), sep (...,))."""
    V, F = pts.shape[-2], planes.shape[-2]
    px, py, pz = (pts[..., :, None, c] for c in range(3))       # (..., V, 1)
    n0, n1, n2, nd = (planes[..., None, :, c] for c in range(4))
    vals = px * n0 + py * n1 + pz * n2 - nd                     # (..., V, F)
    live = vmask > 0.5
    vals = torch.where(live[..., :, None], vals, _BIG)
    pfm = vals.amin(dim=-2)                                     # (..., F)
    sep = pfm.amax(dim=-1)
    # argmax over F via compare + iota-min (ties -> lowest index)
    fio = torch.arange(F, device=pts.device)
    ref_f = torch.where(pfm >= sep[..., None], fio, F).amin(dim=-1)
    ref_f = torch.clamp(ref_f, max=F - 1)
    plane = torch.take_along_dim(
        planes, ref_f[..., None, None].expand(ref_f.shape + (1, 4)),
        dim=-2)[..., 0, :]
    depth = (pts[..., 0] * plane[..., None, 0] + pts[..., 1]
             * plane[..., None, 1] + pts[..., 2] * plane[..., None, 2]
             - plane[..., None, 3])                             # (..., V)
    cur = torch.where(live, depth, _BIG)
    vio = torch.arange(V, device=pts.device)
    deps, idxs = [], []
    for _ in range(K):
        dk = cur.amin(dim=-1)
        ik = torch.where(cur <= dk[..., None], vio, V).amin(dim=-1)
        ik = torch.clamp(ik, max=V - 1)
        deps.append(dk)
        idxs.append(ik)
        cur = torch.where(vio == ik[..., None], _BIG, cur)
    return (torch.stack(deps, dim=-1),
            torch.stack(idxs, dim=-1).to(torch.int32), plane, sep)


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = cuda_build.load("face_sat")
    lib.face_sat_f32.restype = ctypes.c_int
    lib.face_sat_f32.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    return lib


def face_sat_depth_cuda(pts, planes, vmask, K=2):
    """Launch the CUDA kernel.  pts (..., V, 3), planes (..., F, 4), vmask
    (..., V): float32, contiguous, on one CUDA device."""
    fn = "face_sat_depth_cuda"
    lead = pts.shape[:-2]
    V, F, K = pts.shape[-2], planes.shape[-2], int(K)
    if (pts.dim() < 3 or pts.shape[-1] != 3 or planes.shape != lead + (F, 4)
            or vmask.shape != lead + (V,)):
        raise ValueError(f"{fn}: shapes {tuple(pts.shape)} / "
                         f"{tuple(planes.shape)} / {tuple(vmask.shape)}")
    if not 1 <= K <= V:
        raise ValueError(f"{fn}: K={K} must be in 1..V (V={V})")
    if not smem_fits(V, F):
        raise ValueError(f"{fn}: V={V}, F={F} exceed the kernel's shared "
                         f"memory ({SMEM_BYTES} bytes a block)")
    dev = cuda_build.check_f32_cuda(fn, pts=pts, planes=planes, vmask=vmask)
    N = 1
    for s in lead:
        N *= s
    depth = torch.empty(lead + (K,), dtype=torch.float32, device=dev)
    idx = torch.empty(lead + (K,), dtype=torch.int32, device=dev)
    plane = torch.empty(lead + (4,), dtype=torch.float32, device=dev)
    sep = torch.empty(lead, dtype=torch.float32, device=dev)
    cuda_build.launch(
        dev, _load().face_sat_f32,
        pts.data_ptr(), planes.data_ptr(), vmask.data_ptr(),
        depth.data_ptr(), idx.data_ptr(), plane.data_ptr(),
        sep.data_ptr(), N, V, F, K)
    profiler.count("face_sat_depth", dev)
    return depth, idx, plane, sep


def face_sat_depth(pts, planes, vmask, K=2):
    """(depth (..., K), idx (..., K) int32, plane (..., 4), sep (...,)) of
    the face-SAT query.  CUDA tensors launch the kernel (or raise); CPU
    tensors take the plain twin."""
    if pts.device.type == "cuda":
        return face_sat_depth_cuda(pts, planes, vmask, K)
    if pts.device.type == "cpu":
        return face_sat_depth_plain(pts, planes, vmask, K)
    raise ValueError(f"face_sat_depth: unsupported device {pts.device}")
