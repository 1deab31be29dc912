"""Matmul-form operators: separable convolutions as per-axis matmuls.

A circular convolution along one axis is exactly a multiplication by an
(n × n) circulant matrix, and the zero-boundary ``DᵀD`` Laplacian is a
tridiagonal matrix — so the whole separable operator chain becomes one
small matmul per axis per apply. Matrices are built host-side (tiny) and
hoisted to runtime arguments by ``jit_closed``.

``precision`` defaults to HIGHEST: true-f32 products. A lower precision
(bf16 or TF32 operands) loses mantissa bits on every operator apply, and
the normal-equation CG amplifies that loss into a converged objective
that fails the parity gate against the float64 reference.
"""

import numpy as np
import jax.numpy as jnp
from jax import lax

from nsol_tpu.ops.grad import _spacing_array

__all__ = [
    "circulant_matrix", "laplacian_matrix",
    "matmul_convolve_fn", "matmul_gradient_normal_fn",
    "make_matmul_blur_operators", "make_matmul_normal_blur_operator",
]


def circulant_matrix(taps, n, dtype=np.float32):
    """(n, n) matrix C with ``(Cx)[i] = Σ_j k[j] x[(i + c − j) mod n]``,
    c = len(k)//2 — the ndimage-convolve wrap semantics along one axis."""
    taps = np.asarray(taps, dtype=np.float64)
    L = len(taps)
    c = L // 2
    C = np.zeros((n, n), dtype=np.float64)
    for j in range(L):
        off = c - j
        for i in range(n):
            C[i, (i + off) % n] += taps[j]
    return C.astype(dtype)


def laplacian_matrix(n, spacing=1.0, dtype=np.float32):
    """(n, n) matrix of the 1-D ``DᵀD`` with the forward-difference
    zero-boundary convention: tridiag(−1, 2, −1)/h² with first diagonal
    entry 1/h² and last 2/h² (see nsol_tpu/ops/grad.py::gradient_normal)."""
    h2 = float(spacing) ** 2
    T = (np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1)
         + np.diag(np.full(n - 1, -1.0), -1))
    T[0, 0] = 1.0
    return (T / h2).astype(dtype)


def _apply_axis_matrix(x, C, axis, precision=lax.Precision.HIGHEST):
    """y[..., i, ...] = Σ_m C[i, m] x[..., m, ...] along ``axis``."""
    y = jnp.tensordot(x, C, axes=([axis], [1]), precision=precision)
    return jnp.moveaxis(y, -1, axis)


def matmul_convolve_fn(factors, shape, dtype=np.float32,
                       precision=lax.Precision.HIGHEST):
    """Separable wrap convolution as a chain of per-axis circulant matmuls."""
    Cs = [jnp.asarray(circulant_matrix(f, n, dtype))
          for f, n in zip(factors, shape)]

    def apply(x):
        for ax, C in enumerate(Cs):
            x = _apply_axis_matrix(x, C, ax, precision)
        return x

    return apply


def matmul_gradient_normal_fn(shape, spacing=None, dtype=np.float32,
                              precision=lax.Precision.HIGHEST):
    """``DᵀD`` as a sum of per-axis tridiagonal matmuls (matches
    :func:`nsol_tpu.ops.grad.gradient_normal` exactly)."""
    ndim = len(shape)
    s = _spacing_array(spacing, ndim)
    # component i differentiates array axis ndim-1-i with spacing s[i]
    Ts = [jnp.asarray(laplacian_matrix(shape[ax], s[ndim - 1 - ax], dtype))
          for ax in range(ndim)]

    def apply(x):
        out = None
        for ax, T in enumerate(Ts):
            t = _apply_axis_matrix(x, T, ax, precision)
            out = t if out is None else out + t
        return out

    return apply


def make_matmul_blur_operators(cov, alpha_cut=3, spacing=None, shape=None,
                               dtype=np.float32):
    """Gaussian blur pair ``(A, A_adj)`` as per-axis matmuls (diagonal
    covariance only)."""
    from nsol_tpu.ops.kernels import gaussian_kernel
    from nsol_tpu.ops.conv import separable_factors

    kernel64 = gaussian_kernel(cov, alpha_cut=alpha_cut, spacing=spacing,
                               dtype=np.float64)
    factors = separable_factors(kernel64)
    if factors is None:
        raise ValueError("matmul path requires a separable (diagonal-"
                         "covariance) kernel")
    if shape is None:
        raise ValueError("matmul path requires a static shape")
    A = matmul_convolve_fn(factors, shape, dtype)
    return A, A


def make_matmul_normal_blur_operator(cov, alpha_cut=3, spacing=None,
                                     shape=None, dtype=np.float32):
    """``AᵀA`` as per-axis circulant matmuls with the
    self-correlated factors."""
    from nsol_tpu.ops.kernels import gaussian_kernel
    from nsol_tpu.ops.conv import separable_factors

    kernel64 = gaussian_kernel(cov, alpha_cut=alpha_cut, spacing=spacing,
                               dtype=np.float64)
    factors = separable_factors(kernel64)
    if factors is None or shape is None:
        raise ValueError("matmul path requires a separable kernel and a "
                         "static shape")
    auto = [np.convolve(f, f[::-1]) for f in factors]
    return matmul_convolve_fn(auto, shape, dtype)
