"""Finite-difference gradient/divergence operators on shaped arrays.

Instead of the reference's flattened 1-D arrays convolved by
``scipy.ndimage`` (nsol/linear_operators.py:98-169), arrays stay shaped and
the 2-point stencils are expressed as shifted-slice subtractions which XLA
fuses into single elementwise passes. The gradient returns a stacked ``(d, *shape)``
array (component order x, y[, z] — i.e. last array axis first), matching the
reference's ``concat(Dx, Dy, Dz)`` stacking semantics
(nsol/linear_operators.py:121-144) without the axis-0 concatenation quirk.

Exact conventions (verified against scipy.ndimage.convolve):

* forward difference  ``D(x)[i]  = x[i+1] - x[i]`` with ``x[n] := 0``
* adjoint             ``Dᵀ(y)[i] = y[i-1] - y[i]`` with ``y[-1] := 0``
  (= minus backward difference; reference: nsol/linear_operators.py:98-106)

so that ``<D x, y> == <x, Dᵀ y>`` holds exactly.

``spacing`` is ordered spatially (x, y[, z]): component ``i`` differentiates
array axis ``ndim-1-i`` and divides by ``spacing[i]``
(reference: nsol/kernels.py:102-112, 160-190, 240-286).
"""

import numpy as np
import jax.numpy as jnp

__all__ = [
    "forward_difference", "forward_difference_adjoint",
    "gradient", "gradient_adjoint", "make_gradient_operators",
    "gradient_normal",
]


def _spacing_array(spacing, ndim):
    if spacing is None:
        return np.ones(ndim)
    s = np.atleast_1d(np.asarray(spacing, dtype=np.float64))
    if s.size == 1:
        return np.full(ndim, float(s[0]))
    if s.size != ndim:
        raise ValueError("spacing must have %d entries" % ndim)
    return s


def forward_difference(x, axis):
    """``D(x)[i] = x[i+1] - x[i]`` along ``axis`` with zero pad on the right."""
    upper = jnp.concatenate(
        [
            jax_slice(x, axis, 1, None),
            jnp.zeros_like(jax_slice(x, axis, 0, 1)),
        ],
        axis=axis,
    )
    return upper - x


def forward_difference_adjoint(y, axis):
    """``Dᵀ(y)[i] = y[i-1] - y[i]`` along ``axis`` with zero pad on the left."""
    lower = jnp.concatenate(
        [
            jnp.zeros_like(jax_slice(y, axis, 0, 1)),
            jax_slice(y, axis, 0, -1),
        ],
        axis=axis,
    )
    return lower - y


def jax_slice(x, axis, start, stop):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, stop)
    return x[tuple(idx)]


def gradient(x, spacing=None):
    """Stacked forward-difference gradient: ``(d, *x.shape)``.

    Component ``i`` is the derivative along spatial direction i (x first,
    i.e. the *last* array axis), scaled by ``1/spacing[i]``
    (reference stacking: nsol/linear_operators.py:121-144).
    """
    ndim = x.ndim
    s = _spacing_array(spacing, ndim)
    comps = [
        forward_difference(x, ndim - 1 - i) / s[i].astype(x.dtype)
        for i in range(ndim)
    ]
    return jnp.stack(comps, axis=0)


def gradient_adjoint(g, spacing=None):
    """Adjoint of :func:`gradient`: maps ``(d, *shape) -> shape``.

    ``Σ_i Dᵢᵀ(g[i]) / spacing[i]`` (reference:
    nsol/linear_operators.py:158-169, adjoint = sum of per-axis adjoints).
    """
    ndim = g.ndim - 1
    s = _spacing_array(spacing, ndim)
    out = forward_difference_adjoint(g[0], ndim - 1) / s[0].astype(g.dtype)
    for i in range(1, ndim):
        out = out + (
            forward_difference_adjoint(g[i], ndim - 1 - i)
            / s[i].astype(g.dtype)
        )
    return out


def gradient_normal(x, spacing=None):
    """Fused ``DᵀD x = Σ_ax Dᵀ_ax D_ax x`` in one pass per axis.

    Algebraically identical to ``gradient_adjoint(gradient(x))`` but
    evaluated as the direct second-difference stencil — per axis
    ``(2x[i] − x[i−1] − x[i+1]) / h²`` with the zero-boundary corrections
    implied by the forward-difference pair (first entry ``x[0]−x[1]``,
    last entry ``2x[n−1]−x[n−2]``). Halves the operator passes of the
    normal-equation CG (see nsol_tpu/solvers/tikhonov.py).
    """
    ndim = x.ndim
    s = _spacing_array(spacing, ndim)
    out = None
    for i in range(ndim):
        axis = ndim - 1 - i
        up = jnp.concatenate(
            [jax_slice(x, axis, 1, None),
             jnp.zeros_like(jax_slice(x, axis, 0, 1))], axis=axis)
        down = jnp.concatenate(
            [jnp.zeros_like(jax_slice(x, axis, 0, 1)),
             jax_slice(x, axis, 0, -1)], axis=axis)
        t = 2.0 * x - up - down
        # boundary correction at i=0: want x[0] − x[1], formula gives
        # 2x[0] − x[1] (down pad is 0) → subtract x at the first slab.
        first = jax_slice(t, axis, 0, 1) - jax_slice(x, axis, 0, 1)
        t = jnp.concatenate([first, jax_slice(t, axis, 1, None)], axis=axis)
        t = t / (s[i] ** 2).astype(x.dtype)
        out = t if out is None else out + t
    return out


def make_gradient_operators(spacing=None):
    """Return ``(grad, grad_adj)`` closures over a fixed spacing.

    Drop-in analogue of the reference's
    ``LinearOperators{1,2,3}D.get_gradient_operators()``
    (nsol/linear_operators.py:121-144), but shape-polymorphic and jittable.
    """
    def grad(x):
        return gradient(x, spacing)

    def grad_adj(g):
        return gradient_adjoint(g, spacing)

    return grad, grad_adj
