"""Frozen copy of mujoco_sim_tpu_torch's CPU path for the benchmark's
plain reference (bench_port/refsim): imports rewritten, CUDA wrappers
and graph capture removed.  Do not import the program from here.

Support extents of a vertex cloud along many axes: CUDA kernel + twin.

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


import torch




def support_minmax_plain(axes: torch.Tensor, w: torch.Tensor):
    """axes (..., C, 3), w (..., V, 3) -> (mn, mx) (..., C): the (C, V)
    product as a three-term sum, then two reductions."""
    p = (axes[..., :, None, 0] * w[..., None, :, 0]
         + axes[..., :, None, 1] * w[..., None, :, 1]
         + axes[..., :, None, 2] * w[..., None, :, 2])
    return p.amin(dim=-1), p.amax(dim=-1)



def support_minmax(axes: torch.Tensor, w: torch.Tensor):
    """(min, max) over the V vertices of axis . vertex, for C axes.
    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    twin."""
    if axes.device.type == "cpu":
        return support_minmax_plain(axes, w)
    raise ValueError(f"support_minmax: unsupported device {axes.device}")
