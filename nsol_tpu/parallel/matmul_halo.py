"""Matmul-form sharded operators: halo exchange + banded/circulant matmuls.

Composes the two independent optimizations of this build:

* the single-device matmul path (nsol_tpu/ops/matmul_ops.py) — separable
  stencils as per-axis circulant/tridiagonal matmuls;
* the distribution layer (nsol_tpu/parallel/halo.py) — spatial domain
  decomposition along array axis 0 with ppermute halo exchange.

A block sharded along axis 0 sees *complete* local axes (1..nd−1), which get
the exact circulant/tridiagonal matmuls of the single-chip path. Along the
sharded axis a convolution is a **banded Toeplitz matmul on the halo-padded
block**: pad with ``lo``/``hi`` ghost planes (ring for the wrap-boundary blur,
ppermute-zeros for the zero-boundary ``DᵀD``), then multiply by the
``(local, local+L−1)`` band matrix whose rows carry the taps. The band matrix
is identical on every rank; the only rank-dependent piece is the global
zero-boundary correction of ``DᵀD`` at rank 0 (one elementwise fixup selected
by ``lax.axis_index``).

The reference has no distribution anywhere (SURVEY.md §2); these operators
realize BASELINE config 5's "sharded 512³ TV-deconvolution with psum-reduced
CG" on the same matmul operators as the single-device path.

All functions here run *inside* ``shard_map``.
"""

import numpy as np
import jax.numpy as jnp
from jax import lax

from nsol_tpu.ops.grad import _spacing_array
from nsol_tpu.ops.matmul_ops import (
    circulant_matrix, laplacian_matrix, _apply_axis_matrix)
from nsol_tpu.parallel.halo import (
    exchange_halo_wrap, exchange_plane_up, exchange_plane_down)

__all__ = [
    "band_matrix", "make_sharded_matmul_blur_operators",
    "make_sharded_matmul_normal_blur_operator",
    "make_sharded_matmul_gradient_normal",
]


def band_matrix(taps, local, dtype=np.float32):
    """(local, local+L−1) Toeplitz band applying ndimage-convolve semantics
    along the padded sharded axis: with ``xp`` the block padded by
    ``lo = L−1−c`` leading and ``hi = c`` trailing ghost planes (c = L//2),
    ``(Band @ xp)[i] = Σ_j k[j] x[i + c − j]`` — exactly
    :func:`nsol_tpu.ops.matmul_ops.circulant_matrix`'s convention on the
    local window."""
    taps = np.asarray(taps, dtype=np.float64)
    L = len(taps)
    Band = np.zeros((local, local + L - 1), dtype=np.float64)
    for m in range(L):
        idx = np.arange(local)
        Band[idx, idx + m] = taps[L - 1 - m]
    return Band.astype(dtype)


def _apply_band_axis0(xp, Band):
    """y = Band @ xp along axis 0 of the halo-padded block (matmul)."""
    return jnp.tensordot(Band, xp, axes=([1], [0]),
                         precision=lax.Precision.HIGHEST)


def _blur_factors(cov, alpha_cut, spacing, ndim_hint=None):
    from nsol_tpu.ops.kernels import gaussian_kernel
    from nsol_tpu.ops.conv import separable_factors

    kernel64 = gaussian_kernel(cov, alpha_cut=alpha_cut, spacing=spacing,
                               dtype=np.float64)
    return separable_factors(kernel64)


def _make_sharded_separable_apply(factors, local_shape, axis_name, n_shards,
                                  dtype):
    """Separable wrap convolution on a block sharded along axis 0: ring-halo
    + band matmul on axis 0, circulant matmuls on the complete local axes."""
    ndim = len(local_shape)
    taps0 = np.asarray(factors[0], dtype=np.float64)
    L = len(taps0)
    c = L // 2
    lo, hi = L - 1 - c, c  # matches conv._per_axis_pads / halo blur ops
    Band0 = jnp.asarray(band_matrix(taps0, local_shape[0], dtype))
    Cs = [jnp.asarray(circulant_matrix(factors[ax], local_shape[ax], dtype))
          for ax in range(1, ndim)]

    def apply(x):
        xp = exchange_halo_wrap(x, axis_name, n_shards, lo=lo, hi=hi, axis=0)
        y = _apply_band_axis0(xp, Band0)
        for ax, C in enumerate(Cs, start=1):
            y = _apply_axis_matrix(y, C, ax)
        return y

    return apply


def make_sharded_matmul_blur_operators(cov, alpha_cut=3, spacing=None,
                                       local_shape=None, axis_name="space",
                                       n_shards=1, dtype=np.float32):
    """Gaussian blur pair ``(A, A_adj)`` on the sharded matmul path (diagonal
    covariance only; the Gaussian stencil is flip-symmetric so A_adj = A)."""
    factors = _blur_factors(cov, alpha_cut, spacing)
    if factors is None:
        raise ValueError("sharded matmul path requires a separable "
                         "(diagonal-covariance) kernel")
    if local_shape is None:
        raise ValueError("sharded matmul path requires a static local shape")
    A = _make_sharded_separable_apply(factors, local_shape, axis_name,
                                      n_shards, dtype)
    return A, A


def make_sharded_matmul_normal_blur_operator(cov, alpha_cut=3, spacing=None,
                                             local_shape=None,
                                             axis_name="space", n_shards=1,
                                             dtype=np.float32):
    """``AᵀA`` on the sharded matmul path: one separable pass with the
    self-correlated per-axis factors (see
    :func:`nsol_tpu.ops.conv.make_normal_blur_operator`)."""
    factors = _blur_factors(cov, alpha_cut, spacing)
    if factors is None:
        raise ValueError("sharded matmul path requires a separable "
                         "(diagonal-covariance) kernel")
    if local_shape is None:
        raise ValueError("sharded matmul path requires a static local shape")
    auto = [np.convolve(f, f[::-1]) for f in factors]
    return _make_sharded_separable_apply(auto, local_shape, axis_name,
                                         n_shards, dtype)


def make_sharded_matmul_gradient_normal(local_shape, spacing=None,
                                        axis_name="space", n_shards=1,
                                        dtype=np.float32):
    """``DᵀD`` on the sharded matmul path, matching
    :func:`nsol_tpu.ops.grad.gradient_normal` on the assembled global array.

    Local axes get the exact per-axis tridiagonal matrices of
    :func:`nsol_tpu.ops.matmul_ops.matmul_gradient_normal_fn`. The sharded
    axis applies the interior band ``(−1, 2, −1)/h²`` to the 1-plane
    halo-padded block: ppermute's zeros-at-the-edge convention supplies the
    global zero boundary, which makes the *last* global row come out right
    (``2x[n−1] − x[n−2]``) but leaves the first global row as ``2x[0] − x[1]``
    where the forward-difference convention wants ``x[0] − x[1]`` — fixed by
    subtracting ``x[0]/h²`` on rank 0 only.
    """
    ndim = len(local_shape)
    s = _spacing_array(spacing, ndim)
    # component i differentiates array axis ndim-1-i with spacing s[i]
    h2_0 = float(s[ndim - 1]) ** 2
    Ts = [jnp.asarray(laplacian_matrix(local_shape[ax],
                                       float(s[ndim - 1 - ax]), dtype))
          for ax in range(1, ndim)]
    band0 = np.array([-1.0, 2.0, -1.0]) / h2_0
    Band0 = jnp.asarray(band_matrix(band0, local_shape[0], dtype))
    inv_h2 = 1.0 / h2_0

    def apply(x):
        prev = exchange_plane_down(x, axis_name, n_shards, axis=0)
        nxt = exchange_plane_up(x, axis_name, n_shards, axis=0)
        xp = jnp.concatenate([prev, x, nxt], axis=0)
        t = _apply_band_axis0(xp, Band0)
        rank = lax.axis_index(axis_name)
        corr = jnp.where(rank == 0, inv_h2, 0.0).astype(x.dtype)
        first = t[0:1] - corr * x[0:1]
        out = jnp.concatenate([first, t[1:]], axis=0)
        for ax, T in enumerate(Ts, start=1):
            out = out + _apply_axis_matrix(x, T, ax)
        return out

    return apply
