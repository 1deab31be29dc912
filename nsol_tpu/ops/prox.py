"""Proximal operators as fused elementwise jit functions.

Closed-form proxes become single fused elementwise passes under jit. The iterative
``prox_linear_least_squares`` (inner quadratic solve) lives in
:mod:`nsol_tpu.solvers.tikhonov`, mirroring the reference's layering where
``proximal_operators.py`` reaches up into the Tikhonov solver
(nsol/proximal_operators.py:43-78).

Conventions (reference: nsol/proximal_operators.py):

* ``prox_ell1_denoising``: shifted soft-threshold (:95-98)
* ``prox_ell2_denoising``: ``(x + τ·x0)/(1+τ)`` (:117-120)
* ``prox_tv_conj``: *componentwise* projection ``x / max(1, |x|)`` — NOT the
  per-pixel gradient-vector norm; a deliberate reference quirk we preserve
  (:138-140)
* ``prox_huber_conj``: scale by ``1/(1+σγ)`` then the same projection, γ=0.05
  (:156-159; the reference mutates its input in place — we are functional)
* vectorial (grouped) soft-thresholding used by the ADMM v-update
  (nsol/admm_linear_solver.py:239-253)
"""

import jax.numpy as jnp

__all__ = [
    "soft_threshold", "prox_ell1_denoising", "prox_ell2_denoising",
    "prox_tv_conj", "prox_huber_conj", "vectorial_soft_threshold",
]

#: Default Huber regularizer smoothing (reference: nsol/proximal_operators.py:157).
HUBER_CONJ_GAMMA = 0.05


def soft_threshold(t, ell):
    """``max(|t|−ℓ, 0)·sign(t)`` (reference: nsol/admm_linear_solver.py:308-309)."""
    return jnp.maximum(jnp.abs(t) - ell, 0.0) * jnp.sign(t)


def prox_ell1_denoising(x, tau, x0, x_scale=1.0):
    """Prox of ``g(x)=‖x−x0‖₁``: shifted soft-threshold."""
    x0 = x0 / x_scale
    return x0 + soft_threshold(x - x0, tau)


def prox_ell2_denoising(x, tau, x0, x_scale=1.0):
    """Prox of ``g(x)=½‖x−x0‖₂²``: ``(x + τ·x0)/(1+τ)``."""
    x0 = x0 / x_scale
    return (x + tau * x0) / (1.0 + tau)


def prox_tv_conj(x, sigma):
    """Projection onto the (componentwise) unit ball: ``x / max(1,|x|)``."""
    return x / jnp.maximum(1.0, jnp.abs(x))


def prox_huber_conj(x, sigma, gamma=HUBER_CONJ_GAMMA):
    """Huber-conjugate prox: shrink by ``1/(1+σγ)`` then project."""
    y = x / (1.0 + sigma * gamma)
    return y / jnp.maximum(1.0, jnp.abs(y))


def vectorial_soft_threshold(t, tau):
    """Grouped soft-thresholding of a stacked gradient field ``(d, *shape)``.

    Shrinks the per-pixel magnitude ``‖t‖ = √(Σ_k t_k²)`` by ``τ`` and
    rescales components; zero where ``‖t‖ ≤ τ``
    (reference: nsol/admm_linear_solver.py:239-253).
    """
    norm = jnp.sqrt(jnp.sum(t * t, axis=0))
    scale = jnp.where(norm > tau,
                      jnp.maximum(norm - tau, 0.0)
                      / jnp.where(norm > tau, norm, 1.0),
                      0.0)
    return t * scale[jnp.newaxis]
