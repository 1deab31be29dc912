"""Matrix-free CGLS: the jittable replacement for scipy.sparse.linalg.lsmr.

The reference solves its Tikhonov subproblem with lsmr on the augmented
rectangular system ``[A; √α·B] x = [b; √α·b_reg]`` with ``atol=btol=0`` so it
always runs exactly ``iter_max`` Krylov iterations
(nsol/tikhonov_linear_solver.py:146-158). We replace lsmr (Golub–Kahan) with
CGLS — CG on the normal equations applied in factored form, which never forms
``AᵀA``, has the same per-iteration cost (one ``A`` + one ``Aᵀ`` apply), and
is a fixed-trip-count ``lax.scan`` that XLA compiles without host
synchronization. Parity with the reference is defined on the converged
objective (bench.py's parity gate), not iterate-by-iterate equality.

Distribution: the operator outputs may be pytrees (e.g. the augmented
``(data, reg)`` pair), and all inner products run through ``tree_vdot``
which accepts an optional ``axis_name`` to ``psum``-reduce across a mesh —
making the same code the single-chip and the sharded CG
(SURVEY.md §5 "Distributed communication backend").
"""

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["tree_vdot", "cgls", "cg"]


def tree_vdot(a, b, axis_name=None):
    """Σ over all leaves of ``<a_i, b_i>``; psum-reduced when ``axis_name``."""
    leaves_a = jax.tree_util.tree_leaves(a)
    leaves_b = jax.tree_util.tree_leaves(b)
    s = sum(jnp.sum(x * y) for x, y in zip(leaves_a, leaves_b))
    if axis_name is not None:
        s = lax.psum(s, axis_name)
    return s


def cgls(apply_A, apply_At, b, x0, iters, axis_name=None):
    """Minimize ``‖A x − b‖²`` from ``x0`` with ``iters`` CGLS steps.

    ``apply_A: x -> y`` (pytree out), ``apply_At: y -> x`` with ``x`` a plain
    array. Fixed iteration count (matching the reference's atol=btol=0 lsmr
    usage); returns the final iterate only. Pure function — callers jit.
    """
    r0 = jax.tree_util.tree_map(lambda bi, ai: bi - ai, b, apply_A(x0))
    s0 = apply_At(r0)
    gamma0 = tree_vdot(s0, s0, axis_name)
    # Freeze threshold: once the normal-equation residual has dropped to
    # machine-noise relative to its start, further updates only accumulate
    # roundoff (running a Krylov recurrence far past convergence destabilizes
    # it) — so the iteration becomes a no-op from there on.
    eps = jnp.finfo(x0.dtype).eps
    floor = gamma0 * eps * eps

    def body(carry, _):
        x, r, p, gamma, active = carry
        q = apply_A(p)
        qq = tree_vdot(q, q, axis_name)
        ok = jnp.logical_and(active, qq > 0)
        alpha = jnp.where(ok, gamma / jnp.where(qq > 0, qq, 1.0), 0.0)
        x = x + alpha * p
        r = jax.tree_util.tree_map(lambda ri, qi: ri - alpha * qi, r, q)
        s = apply_At(r)
        gamma_new = tree_vdot(s, s, axis_name)
        beta = jnp.where(ok, gamma_new / jnp.where(gamma > 0, gamma, 1.0),
                         0.0)
        p = s + beta * p
        active = jnp.logical_and(active, gamma_new > floor)
        return (x, r, p, gamma_new, active), None

    init = (x0, r0, s0, gamma0, gamma0 > floor)
    (x, _, _, _, _), _ = lax.scan(body, init, None, length=iters)
    return x


def cg(apply_M, b, x0, iters, axis_name=None):
    """Plain CG for SPD ``M x = b`` on plain arrays (used for
    normal-equation solves where the caller assembles ``M = AᵀA + αBᵀB``).
    Pure function — callers jit."""
    r0 = jax.tree_util.tree_map(lambda bi, mi: bi - mi, b, apply_M(x0))
    gamma0 = tree_vdot(r0, r0, axis_name)

    def body(carry, _):
        x, r, p, gamma = carry
        q = apply_M(p)
        pq = tree_vdot(p, q, axis_name)
        alpha = gamma / jnp.where(pq > 0, pq, 1.0)
        alpha = jnp.where(pq > 0, alpha, 0.0)
        x = x + alpha * p
        r = jax.tree_util.tree_map(lambda ri, qi: ri - alpha * qi, r, q)
        gamma_new = tree_vdot(r, r, axis_name)
        beta = gamma_new / jnp.where(gamma > 0, gamma, 1.0)
        beta = jnp.where(gamma > 0, beta, 0.0)
        p = jax.tree_util.tree_map(lambda ri, pi: ri + beta * pi, r, p)
        return (x, r, p, gamma_new), None

    (x, _, _, _), _ = lax.scan(body, (x0, r0, r0, gamma0), None, length=iters)
    return x
