"""The control's precision: TF32 matmuls, emulated.

TF32 keeps float32's exponent and 10 of its 23 mantissa bits: a matmul in
TF32 rounds each float32 input to that and accumulates in float32.
``emulated()`` makes every matmul, batched matmul and einsum of float32
tensors do so (the reference's code reaches its products through these),
on any device, whichever kernel the library would pick.
"""

from __future__ import annotations

import contextlib

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (ties away from zero), for a
    float32 tensor; any other tensor unchanged."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def emulated():
    saved = (torch.matmul, torch.bmm, torch.einsum,
             torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
             torch.Tensor.matmul)

    def wrap(fn):
        def f(*a, **k):
            return fn(*(round_tf32(x) for x in a), **k)
        return f

    def einsum(eq, *ops):
        if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
            ops = ops[0]
        return saved[2](eq, *(round_tf32(x) for x in ops))

    torch.matmul, torch.bmm = wrap(saved[0]), wrap(saved[1])
    torch.einsum = einsum
    torch.Tensor.__matmul__ = wrap(saved[3])
    torch.Tensor.__rmatmul__ = wrap(saved[4])
    torch.Tensor.matmul = wrap(saved[5])
    try:
        yield
    finally:
        (torch.matmul, torch.bmm, torch.einsum, torch.Tensor.__matmul__,
         torch.Tensor.__rmatmul__, torch.Tensor.matmul) = saved
