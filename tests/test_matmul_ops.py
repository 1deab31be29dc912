"""Matmul-form operators must match the roll/composition implementations."""

import numpy as np
import pytest
import scipy.ndimage as ndi

import jax.numpy as jnp

from nsol_tpu.ops import conv as C
from nsol_tpu.ops import grad as G
from nsol_tpu.ops import kernels as K
from nsol_tpu.ops import matmul_ops as M

SHAPES = {2: (40, 50), 3: (20, 30, 40)}
SPACINGS = {2: [1.5, 2.0], 3: [1.5, 2.0, 0.7]}


@pytest.mark.parametrize("ndim", [2, 3])
def test_matmul_blur_matches_ndimage(ndim, rng):
    x = rng.rand(*SHAPES[ndim])
    cov = np.diag([1.5, 1.0, 0.8][:ndim]) ** 2
    spacing = SPACINGS[ndim]
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=spacing)
    A, A_adj = M.make_matmul_blur_operators(
        cov, alpha_cut=3, spacing=spacing, shape=x.shape, dtype=np.float64)
    ours = np.asarray(A(jnp.asarray(x)))
    ref = ndi.convolve(x, kern, mode="wrap")
    np.testing.assert_array_almost_equal(ours, ref, decimal=10)


@pytest.mark.parametrize("ndim", [2, 3])
def test_matmul_normal_blur_matches_composition(ndim, rng):
    x = rng.rand(*SHAPES[ndim])
    cov = np.diag([1.2, 1.0, 0.8][:ndim]) ** 2
    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, method="separable")
    nA = M.make_matmul_normal_blur_operator(
        cov, alpha_cut=3, shape=x.shape, dtype=np.float64)
    ours = np.asarray(nA(jnp.asarray(x)))
    ref = np.asarray(A_adj(A(jnp.asarray(x))))
    np.testing.assert_array_almost_equal(ours, ref, decimal=10)


@pytest.mark.parametrize("ndim", [2, 3])
def test_matmul_laplacian_matches_gradient_normal(ndim, rng):
    x = rng.rand(*SHAPES[ndim])
    spacing = SPACINGS[ndim]
    nB = M.matmul_gradient_normal_fn(x.shape, spacing, dtype=np.float64)
    ours = np.asarray(nB(jnp.asarray(x)))
    ref = np.asarray(G.gradient_normal(jnp.asarray(x), spacing))
    np.testing.assert_array_almost_equal(ours, ref, decimal=10)


def test_circulant_matrix_even_kernel():
    """Origin convention for even-length taps matches ndimage."""
    n = 8
    x = np.arange(n, dtype=np.float64)
    taps = [1.0, -1.0]
    Cm = M.circulant_matrix(taps, n, dtype=np.float64)
    ref = ndi.convolve(x, np.asarray(taps), mode="wrap")
    np.testing.assert_array_almost_equal(Cm @ x, ref, decimal=12)
