"""Jittable bounded L-BFGS for the robust-loss minimizer path.

The reference escapes to ``scipy.optimize.minimize(method="L-BFGS-B")`` with
box bounds and analytic cost/gradient for non-linear data losses
(nsol/tikhonov_linear_solver.py:197-220). On an accelerator that host round-trip would
dominate, so this is a from-scratch limited-memory BFGS with projection onto
the box and an Armijo backtracking line search — all fixed-trip-count
``lax.scan``/``lax.while_loop`` so the entire optimization compiles into one
XLA program. Parity with L-BFGS-B is defined on the converged objective,
not on iterate trajectories.
"""

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["lbfgs_box"]


def _project(x, lower, upper):
    return jnp.clip(x, lower, upper)


def lbfgs_box(cost_fn, x0, lower=-jnp.inf, upper=jnp.inf, iters=50,
              history=10, max_backtracks=25, armijo_c=1e-4, tol=0.0,
              axis_name=None):
    """Minimize ``cost_fn`` over the box ``[lower, upper]``.

    Parameters
    ----------
    cost_fn : callable ``x -> scalar`` (differentiated with ``jax.grad``)
    x0 : array, starting point (projected onto the box first, mirroring the
         reference's x0 clipping at nsol/tikhonov_linear_solver.py:142-143)
    iters : static int, number of outer iterations
    history : static int, L-BFGS memory size
    axis_name : optional mesh axis for a *sharded* minimization inside
         ``shard_map``: ``x0`` is the local block of the global unknown,
         ``cost_fn`` must already return the psum-reduced global cost, and
         every curvature/line-search inner product here is psum-reduced so
         all ranks take identical steps — a distributed L-BFGS whose iterates
         are exact shards of the single-device trajectory.
    """
    if axis_name is None:
        _dot = lambda a, b: jnp.sum(a * b)
    else:
        _dot = lambda a, b: lax.psum(jnp.sum(a * b), axis_name)

    x0 = _project(x0, lower, upper)
    value_and_grad = jax.value_and_grad(cost_fn)
    f0, g0 = value_and_grad(x0)

    n = x0.size
    dtype = x0.dtype
    S = jnp.zeros((history,) + x0.shape, dtype)
    Y = jnp.zeros((history,) + x0.shape, dtype)
    if axis_name is not None:
        # Inside shard_map the history buffers are updated from the sharded
        # iterate and must carry its varying-manual-axis type from the start.
        S = lax.pcast(S, (axis_name,), to="varying")
        Y = lax.pcast(Y, (axis_name,), to="varying")
    rho = jnp.zeros((history,), dtype)

    def two_loop(g, S, Y, rho, gamma):
        """Standard two-loop recursion over the circular history."""
        def first(carry, i):
            q, alphas = carry
            valid = rho[i] > 0
            a = jnp.where(valid, rho[i] * _dot(S[i], q), 0.0)
            q = q - a * Y[i]
            return (q, alphas.at[i].set(a)), None

        (q, alphas), _ = lax.scan(
            first, (g, jnp.zeros((history,), dtype)),
            jnp.arange(history - 1, -1, -1))
        r = gamma * q

        def second(r, i):
            valid = rho[i] > 0
            b = jnp.where(valid, rho[i] * _dot(Y[i], r), 0.0)
            r = r + (alphas[i] - b) * S[i]
            return r, None

        r, _ = lax.scan(second, r, jnp.arange(history))
        return r

    def body(carry, k):
        x, f, g, S, Y, rho, gamma = carry

        d = -two_loop(g, S, Y, rho, gamma)
        # Safeguard: fall back to steepest descent if not a descent direction.
        gTd = _dot(g, d)
        d = jnp.where(gTd < 0, d, -g)
        gTd = jnp.minimum(gTd, -_dot(g, g))

        # Projected Armijo backtracking: x(t) = P(x + t d).
        def ls_cond(state):
            t, fx, xt, it = state
            # Armijo on the projected step: f(x_t) <= f + c * g·(x_t - x)
            return jnp.logical_and(
                it < max_backtracks,
                fx > f + armijo_c * _dot(g, xt - x))

        def ls_body(state):
            t, _, _, it = state
            t = t * 0.5
            xt = _project(x + t * d, lower, upper)
            fxt = cost_fn(xt)
            return (t, fxt, xt, it + 1)

        t0 = jnp.asarray(1.0, dtype)
        x1 = _project(x + t0 * d, lower, upper)
        f1 = cost_fn(x1)
        t, f_new, x_new, _ = lax.while_loop(
            ls_cond, ls_body, (t0, f1, x1, jnp.asarray(0, jnp.int32)))

        # Keep the old point if the line search failed to decrease.
        improved = f_new < f
        x_new = jnp.where(improved, x_new, x)
        f_new = jnp.where(improved, f_new, f)
        _, g_new = value_and_grad(x_new)

        s = x_new - x
        y = g_new - g
        sy = _dot(s, y)
        slot = k % history
        good = sy > 1e-10
        S = S.at[slot].set(jnp.where(good, s, jnp.zeros_like(s)))
        Y = Y.at[slot].set(jnp.where(good, y, jnp.zeros_like(y)))
        rho = rho.at[slot].set(jnp.where(good, 1.0 / jnp.where(good, sy, 1.0),
                                         0.0))
        yy = _dot(y, y)
        gamma = jnp.where(good, sy / jnp.where(yy > 0, yy, 1.0), gamma)

        return (x_new, f_new, g_new, S, Y, rho, gamma), f_new

    init = (x0, f0, g0, S, Y, rho, jnp.asarray(1.0, dtype))
    (x, f, g, *_), _ = lax.scan(body, init, jnp.arange(iters))
    return x
