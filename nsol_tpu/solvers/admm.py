"""ADMM for TV-regularized (robust) deconvolution as nested scans.

Solves ``min_x ½‖ρ((Ax−b)²)‖ + α TV(Bx − b_reg)``
(reference: nsol/admm_linear_solver.py). Per iteration (:202-218):

1. x-update: inner Tikhonov solve with ``alpha=ρ, b_reg = v − w + b_reg``
   (:220-237) — here a fixed-trip CGLS scan nested inside the outer scan
2. v-update: vectorial soft-thresholding of ``Bx + w − b_reg`` with
   threshold ``τ = α/ρ`` (:239-253)
3. dual update ``w = Bx + w − b_reg − v`` (:216)

The inner solver inherits the reference's defaults: ``minimizer="lsmr"``
(→ CGLS), ``iter_max`` Krylov iterations, non-negativity clip from the
default bounds ``(0, ∞)`` (nsol/tikhonov_linear_solver.py:83).

``B`` maps to the stacked ``(d, *shape)`` gradient field of
:func:`nsol_tpu.ops.grad.gradient`; the whole outer loop is one scanned XLA
program — ~iterations × (2·iter_max + 2) operator applications with zero
host round-trips.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from nsol_tpu.ops.prox import vectorial_soft_threshold
from nsol_tpu.solvers.tikhonov import tikhonov_solve

__all__ = ["admm_solve"]


def admm_solve(A, A_adj, B, B_adj, b, b_reg, x0, alpha, rho,
               iterations=10, iter_max=10, data_loss="linear",
               data_loss_scale=1.0, minimizer="lsmr",
               inner_bounds=(0.0, np.inf), record_fn=None,
               record_trajectory=False, axis_name=None,
               normal_A=None, normal_B=None, irls_cg_iters=8):
    """Run ``iterations`` ADMM steps from ``x0``. Pure; callers jit.

    ``alpha`` (TV weight) and ``rho`` (augmented-Lagrangian weight) may be
    traced — the study engine vmaps the ``alpha×rho`` grid over this
    function (reference sweeps it serially:
    nsol/admm_linear_solver_parameter_study.py:40-45).

    Returns ``(x, records)`` with records as in
    :func:`nsol_tpu.solvers.primal_dual.primal_dual_solve`.
    """
    dtype = x0.dtype
    alpha = jnp.asarray(alpha, dtype)
    rho = jnp.asarray(rho, dtype)
    Bx0 = B(x0)
    b_reg = jnp.broadcast_to(jnp.asarray(b_reg, dtype), Bx0.shape)

    v0 = Bx0 - b_reg
    w0 = jnp.zeros_like(v0)

    # Aᵀb is loop-invariant — precompute once outside the scan for the
    # normal-equation inner solver.
    At_b = A_adj(b) if minimizer == "cg" else None

    def step(carry, _):
        x, v, w = carry
        x = tikhonov_solve(
            A, A_adj, B, B_adj, b, b_reg=v - w + b_reg, x0=x, alpha=rho,
            data_loss=data_loss, data_loss_scale=data_loss_scale,
            minimizer=minimizer, iter_max=iter_max, bounds=inner_bounds,
            axis_name=axis_name, normal_A=normal_A, normal_B=normal_B,
            At_b=At_b, irls_cg_iters=irls_cg_iters)
        t = B(x) + w - b_reg
        v = vectorial_soft_threshold(t, alpha / rho)
        w = t - v

        out = None
        if record_fn is not None or record_trajectory:
            out = {}
            if record_fn is not None:
                out["measures"] = record_fn(x)
            if record_trajectory:
                out["x"] = x
        return (x, v, w), out

    (x, _, _), ys = lax.scan(step, (x0, v0, w0), None, length=iterations)

    records = None
    if ys is not None:
        records = {}
        if record_fn is not None:
            first = record_fn(x0)
            records["measures"] = jax.tree_util.tree_map(
                lambda f, y: jnp.concatenate([f[jnp.newaxis], y], axis=0),
                first, ys["measures"])
        if record_trajectory:
            records["x"] = jnp.concatenate([x0[jnp.newaxis], ys["x"]], axis=0)
    return x, records
