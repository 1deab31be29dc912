"""Determinism tests: bitwise-reproducible jit outputs.

SURVEY.md §5 maps the reference's (absent) race-detection concern class to
determinism guarantees on the accelerator: the same jitted solve on the same inputs
must produce bitwise-identical results across executions, and the sharded
execution must be deterministic as well.
"""

import numpy as np

import jax
import jax.numpy as jnp
from functools import partial

from nsol_tpu.ops import conv as C
from nsol_tpu.ops import grad as G
from nsol_tpu.ops import prox as prox_ops
from nsol_tpu.solvers.admm import admm_solve
from nsol_tpu.solvers.primal_dual import primal_dual_solve
from nsol_tpu.parallel import make_mesh, sharded_tv_admm_solve


def test_pd_bitwise_deterministic(rng):
    b = jnp.asarray(rng.rand(24, 24))
    grad_op, grad_adj = G.make_gradient_operators()

    def solve(b):
        def prox_f(x, tau):
            return prox_ops.prox_ell2_denoising(x, tau, b)

        x, _ = primal_dual_solve(prox_f, prox_ops.prox_tv_conj,
                                 grad_op, grad_adj, b, 0.5, 8.0,
                                 iterations=20)
        return x

    f = jax.jit(solve)
    x1 = np.asarray(f(b))
    x2 = np.asarray(f(jnp.array(b)))
    np.testing.assert_array_equal(x1, x2)


def test_admm_bitwise_deterministic(rng):
    shape = (16, 16)
    cov = np.diag([0.8, 0.8])
    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, method="separable")
    Bg, Bg_adj = G.make_gradient_operators()
    b = jnp.asarray(rng.rand(*shape))

    f = jax.jit(partial(admm_solve, A, A_adj, Bg, Bg_adj,
                        iterations=8, iter_max=5))
    x1, _ = f(b, 0.0, b, 0.01, 0.5)
    x2, _ = f(jnp.array(b), 0.0, jnp.array(b), 0.01, 0.5)
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))


def test_sharded_solve_deterministic(rng):
    mesh = make_mesh((4,), ("space",))
    shape = (16, 12, 10)
    cov = np.diag([0.8] * 3)
    b = rng.rand(*shape)
    x1 = np.asarray(sharded_tv_admm_solve(
        mesh, cov, b, np.array(b), 0.01, 0.5, iterations=3, iter_max=3))
    x2 = np.asarray(sharded_tv_admm_solve(
        mesh, cov, np.array(b), np.array(b), 0.01, 0.5,
        iterations=3, iter_max=3))
    np.testing.assert_array_equal(x1, x2)
