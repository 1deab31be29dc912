"""Chambolle–Pock first-order primal-dual solver as a ``lax.scan`` loop.

Solves ``min_x f(x) + α g(Bx)`` given ``prox_f``, ``prox_{g*}``, the linear
operator pair ``B/Bᵀ`` and its squared norm ``L2``
(reference: nsol/primal_dual_solver.py). Step-size schedules:

* ``ALG2``       — accelerated: ``τ0=1/√L2, σ0=1/(L2·τ0), γ=0.35λ``;
  per-iteration ``θ=1/√(1+2γτ), τ←τθ, σ←σ/θ`` (reference :278-306)
* ``ALG2_AHMOD`` — Arrow–Hurwicz: ``τ0=0.02, σ0=4/(L2·τ0)``, same τ/σ update
  but over-relaxation θ forced to 0 (reference :374-403)
* ``ALG3``       — constant steps from ``μ=2√(γδ/L2)``, Huber δ=0.05,
  ``θ=1/(1+μ), σ=μ/(2δ), τ=μ/(2γ)`` (reference :321-358)

with ``λ = 1/α`` (reference :222) and the primal prox always invoked with
step ``τ·λ`` (reference :246).

Differences from the reference: the iteration is a single scanned
XLA program (one compile, no per-iteration host dispatch); the observer's
per-iteration trajectory copy (nsol/primal_dual_solver.py:260-261 — an O(n)
host copy per iteration) becomes an in-graph ``record_fn`` carry that
accumulates scalar measures on device.
"""

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["primal_dual_solve", "ALG_TYPES"]

ALG_TYPES = ("ALG2", "ALG2_AHMOD", "ALG3")

#: Huber smoothing δ used by ALG3 (reference: nsol/primal_dual_solver.py:321).
ALG3_HUBER_DELTA = 0.05


def primal_dual_solve(prox_f, prox_g_conj, B, B_adj, x0, alpha, L2,
                      iterations, alg_type="ALG2", record_fn=None,
                      record_trajectory=False):
    """Run ``iterations`` primal-dual steps from ``x0``. Pure; callers jit.

    Parameters
    ----------
    prox_f : callable ``(x, tau) -> x`` — prox of the data term
    prox_g_conj : callable ``(p, sigma) -> p`` — prox of the conjugate
        regularizer
    B, B_adj : linear operator pair (e.g. stacked gradient / divergence)
    alpha : regularization weight (may be traced — the vmapped alpha-sweep
        of the study engine relies on this)
    L2 : squared operator norm of B (2D: ≤ 8/h², 3D: ≤ 16/h²;
        reference: nsol/primal_dual_solver.py:46-49)
    record_fn : optional callable ``x -> pytree`` of per-iteration scalars
    record_trajectory : also stack every iterate (observer parity; memory-
        hostile on the accelerator, off by default)

    Returns
    -------
    ``(x, records)`` where records is a pytree of ``(iterations+1, ...)``
    arrays (entry 0 = initial x0 state, matching the reference observer's
    add_x-at-init; nsol/primal_dual_solver.py:218-219) or None.
    """
    if alg_type not in ALG_TYPES:
        raise ValueError("alg_type must be one of %s" % (ALG_TYPES,))

    dtype = x0.dtype
    alpha = jnp.asarray(alpha, dtype)
    L2 = jnp.asarray(L2, dtype)
    lmbda = 1.0 / alpha

    if alg_type == "ALG2":
        tau0 = 1.0 / jnp.sqrt(L2)
        sigma0 = 1.0 / (L2 * tau0)
        gamma = 0.35 * lmbda
    elif alg_type == "ALG2_AHMOD":
        tau0 = jnp.asarray(0.02, dtype)
        sigma0 = 4.0 / (L2 * tau0)
        gamma = 0.35 * lmbda
    else:  # ALG3: constant steps
        gamma_l = lmbda
        delta = jnp.asarray(ALG3_HUBER_DELTA, dtype)
        mu = 2.0 * jnp.sqrt(gamma_l * delta / L2)
        theta_const = 1.0 / (1.0 + mu)
        sigma0 = mu / (2.0 * delta)
        tau0 = mu / (2.0 * gamma_l)
        gamma = theta_const  # constant θ rides the gamma slot (reference :357)

    p0 = jnp.zeros_like(B(x0))

    def step(carry, _):
        x, x_mean, p, tau, sigma = carry
        p = prox_g_conj(p + sigma * B(x_mean), sigma)
        x_new = prox_f(x - tau * B_adj(p), tau * lmbda)

        if alg_type == "ALG2":
            theta = 1.0 / jnp.sqrt(1.0 + 2.0 * gamma * tau)
            tau = tau * theta
            sigma = sigma / theta
        elif alg_type == "ALG2_AHMOD":
            theta_upd = 1.0 / jnp.sqrt(1.0 + 2.0 * gamma * tau)
            tau = tau * theta_upd
            sigma = sigma / theta_upd
            theta = jnp.asarray(0.0, dtype)
        else:
            theta = gamma

        x_mean = x_new + theta * (x_new - x)
        out = None
        if record_fn is not None or record_trajectory:
            out = {}
            if record_fn is not None:
                out["measures"] = record_fn(x_new)
            if record_trajectory:
                out["x"] = x_new
        return (x_new, x_mean, p, tau, sigma), out

    init = (x0, x0, p0, tau0, sigma0)
    (x, _, _, _, _), ys = lax.scan(step, init, None, length=iterations)

    records = None
    if ys is not None:
        records = {}
        if record_fn is not None:
            first = record_fn(x0)
            records["measures"] = jax.tree_util.tree_map(
                lambda f, y: jnp.concatenate([f[jnp.newaxis], y], axis=0),
                first, ys["measures"])
        if record_trajectory:
            records["x"] = jnp.concatenate(
                [x0[jnp.newaxis], ys["x"]], axis=0)
    return x, records
