"""The Cholesky twins above the register-resident size classes, against the
JAX package on the CPU: the cases of test_chol_twins_above_the_size_classes
(tests/test_torch_kernels_twins.py) at every size edge of the CUDA
kernels' panel layout (utils/kernel_cases.CHOL_BIG_CASES: both sides of
every panel, thread-count and shared-memory edge, a batch of 1031 at
n = 66, a stiff 1e9 row, a floored pivot).

On the CPU the wrappers take the twins, so the wrappers are what is called
here.  chol_solve's twin is held to the JAX package's linalg.cholesky +
cho_solve at 2e-5 (absolute + relative), the band of
tests/test_pallas_chol.py; chol_factor's twin to linalg.cholesky at the
same band, with zeros above the diagonal.  The JAX functions run eagerly
(tracing and compiling their unrolled leaves costs more than running
them); the Pallas kernel in interpret mode (~14 s a size) is held to the
twins at n = 65 and 72 in tests/test_torch_kernels_twins.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu.ops import linalg as jlinalg
from mujoco_sim_tpu_torch.ops import chol, chol_factor
from mujoco_sim_tpu_torch.utils import kernel_cases
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

F32 = np.float32


@pytest.mark.parametrize("case", kernel_cases.CHOL_BIG_CASES)
def test_chol_twins_above_the_size_classes(case):
    A, b = kernel_cases.chol_big_case(case)
    A, b = A.astype(F32), b.astype(F32)
    x = chol.chol_solve(torch.tensor(A), torch.tensor(b)).numpy()
    L = chol_factor.chol_factor(torch.tensor(A)).numpy()
    assert x.dtype == F32 and L.dtype == F32
    Lj = jlinalg.cholesky(jnp.asarray(A))
    xj = np.asarray(jlinalg.cho_solve(Lj, jnp.asarray(b)))
    assert np.isfinite(x).all() and np.isfinite(L).all()
    np.testing.assert_allclose(x, xj, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(L, np.asarray(Lj), rtol=2e-5, atol=2e-5)
    assert (np.triu(L, 1) == 0).all()
    if case == "stiff_n96":
        r = np.einsum("bij,bj->bi", A.astype(np.float64), x) - b
        assert np.abs(r).max() < 1e-2, np.abs(r).max()
    if case == "floor_n72":
        # the floored pivot is stored as a_jj / sqrt(1e-30) ~ -1e12 s and
        # divided by as such: x_2 is b_2 over ~1e12 and more, not b_2 / ~0
        assert np.abs(x[:, 1]).max() < 1e-20
