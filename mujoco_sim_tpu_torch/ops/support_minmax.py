"""Support extents of a vertex cloud along many axes: CUDA kernel + twin.

Port of mujoco_sim_tpu/ops/pallas_support.py (kernel) and of the product
and two reductions of mujoco_sim_tpu/ops/manifold._support_minmax (twin):
``mn[c] = min_v axes[c] . w[v]`` and ``mx[c] = max_v`` of the same, per
instance.  Reductions are UNMASKED: the hull tables pad by repeating a
real vertex, so pads never win.

``support_minmax`` picks its path from the tensor's device: a CUDA tensor
launches csrc/support_minmax.cu (built by ops/cuda_build.py at first use;
a persistent grid of warps, teams of 8 lanes x 9 axes an instance up to
C = 72 and a warp of 32 lanes x 8 axes beyond, vertices staged as float4
and double-buffered, any V) or raises; a CPU tensor takes the plain twin.
``LAUNCHES`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mujoco_sim_tpu_torch.ops import cuda_build

LAUNCHES = 0
SOURCE = cuda_build.source_path("support_minmax")


def support_minmax_plain(axes: torch.Tensor, w: torch.Tensor):
    """axes (..., C, 3), w (..., V, 3) -> (mn, mx) (..., C): the (C, V)
    product as a three-term sum, then two reductions."""
    p = (axes[..., :, None, 0] * w[..., None, :, 0]
         + axes[..., :, None, 1] * w[..., None, :, 1]
         + axes[..., :, None, 2] * w[..., None, :, 2])
    return p.amin(dim=-1), p.amax(dim=-1)


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = cuda_build.load("support_minmax")
    lib.support_minmax_f32.restype = ctypes.c_int
    lib.support_minmax_f32.argtypes = ([ctypes.c_void_p] * 4
                                       + [ctypes.c_longlong]
                                       + [ctypes.c_int] * 2
                                       + [ctypes.c_void_p])
    return lib


def support_minmax_cuda(axes: torch.Tensor, w: torch.Tensor):
    """Launch the CUDA kernel: axes (..., C, 3), w (..., V, 3), float32,
    contiguous, on one CUDA device, same leading dims."""
    global LAUNCHES
    fn = "support_minmax_cuda"
    lead = axes.shape[:-2]
    if (axes.dim() < 3 or axes.shape[-1] != 3 or w.shape[-1] != 3
            or w.shape[:-2] != lead):
        raise ValueError(f"{fn}: shapes {tuple(axes.shape)} / "
                         f"{tuple(w.shape)}")
    C, V = axes.shape[-2], w.shape[-2]
    if C < 1 or V < 1:
        raise ValueError(f"{fn}: C={C}, V={V}: both must be >= 1")
    dev = cuda_build.check_f32_cuda(fn, axes=axes, w=w)
    N = 1
    for s in lead:
        N *= s
    mn = torch.empty(lead + (C,), dtype=torch.float32, device=dev)
    mx = torch.empty(lead + (C,), dtype=torch.float32, device=dev)
    rc = cuda_build.launch(
        dev, _load().support_minmax_f32,
        axes.data_ptr(), w.data_ptr(), mn.data_ptr(), mx.data_ptr(), N, C, V)
    if rc != 0:
        raise RuntimeError(f"support_minmax kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 1
    cuda_build.count_launch("support_minmax", dev)
    return mn, mx


def support_minmax(axes: torch.Tensor, w: torch.Tensor):
    """(min, max) over the V vertices of axis . vertex, for C axes.
    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    twin."""
    if axes.device.type == "cuda":
        return support_minmax_cuda(axes, w)
    if axes.device.type == "cpu":
        return support_minmax_plain(axes, w)
    raise ValueError(f"support_minmax: unsupported device {axes.device}")
