"""Solver-level tests.

Strategy (SURVEY.md §4): since the reference package itself cannot run here
(pysitk missing), parity is checked against *oracles built from the
reference's own dependencies* — scipy.sparse.linalg.lsmr for the inner
quadratic solve, scipy.ndimage for operators, and small numpy
re-implementations of the published Chambolle–Pock/ADMM updates — plus the
reference suite's own invariance tests (x_scale invariance to 1e-7,
tests/solvers_test.py:51).
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import scipy.optimize
import scipy.sparse.linalg

import jax.numpy as jnp

from nsol_tpu.ops import grad as G
from nsol_tpu.ops import prox as prox_ops
from nsol_tpu.ops import kernels as K
from nsol_tpu.ops import conv as C
from nsol_tpu.ops import losses as lf
from nsol_tpu.solvers.admm import admm_solve
from nsol_tpu.solvers.cg import cgls
from nsol_tpu.solvers.tikhonov import tikhonov_solve
from nsol_tpu.solvers.wrappers import (
    TikhonovLinearSolver, ADMMLinearSolver, PrimalDualSolver,
)
from nsol_tpu.observer import Observer


# --------------------------------------------------------------- oracles

def _np_gradient_ops(shape, spacing=None):
    """scipy.ndimage-based gradient pair matching the reference exactly."""
    ndim = len(shape)
    spacing = np.ones(ndim) if spacing is None else np.asarray(spacing)

    def grad(x):
        outs = []
        for i in range(ndim):
            kf = K.forward_difference_kernel(ndim - 1 - i, ndim,
                                             spacing=spacing[i])
            outs.append(ndi.convolve(x, kf, mode="constant"))
        return np.stack(outs, axis=0)

    def grad_adj(g):
        out = np.zeros(shape)
        for i in range(ndim):
            kb = K.backward_difference_kernel(ndim - 1 - i, ndim,
                                              spacing=spacing[i])
            out += ndi.convolve(g[i], -kb, mode="constant")
        return out

    return grad, grad_adj


def _reference_pd_tvl2_denoise(b, alpha, L2, iterations):
    """Literal numpy evaluation of the reference PD ALG2 iteration for TVL2
    denoising (nsol/primal_dual_solver.py:215-306 with
    prox_ell2_denoising / prox_tv_conj)."""
    shape = b.shape
    grad, grad_adj = _np_gradient_ops(shape)
    lmbda = 1.0 / alpha
    tau = 1.0 / np.sqrt(L2)
    sigma = 1.0 / (L2 * tau)
    gamma = 0.35 * lmbda
    x = b.copy()
    x_mean = b.copy()
    p = np.zeros((len(shape),) + shape)
    for _ in range(iterations):
        q = p + sigma * grad(x_mean)
        p = q / np.maximum(1, np.abs(q))
        t = x - tau * grad_adj(p)
        tl = tau * lmbda
        x_new = (t + tl * b) / (1.0 + tl)
        theta = 1.0 / np.sqrt(1.0 + 2.0 * gamma * tau)
        tau *= theta
        sigma /= theta
        x_mean = x_new + theta * (x_new - x)
        x = x_new
    return x


# ------------------------------------------------------------- CGLS/lsmr

def test_cgls_converges_to_lsmr_solution(rng):
    """CGLS and lsmr agree on the converged augmented Tikhonov solution."""
    shape = (24, 26)
    n = shape[0] * shape[1]
    cov = np.diag([1.5, 1.5]) ** 2
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(2))

    x_true = rng.rand(*shape)
    b = ndi.convolve(x_true, kern, mode="wrap")
    alpha = 0.05

    # scipy oracle on the augmented system (reference construction,
    # nsol/tikhonov_linear_solver.py:226-256)
    def A_flat(v):
        return ndi.convolve(v.reshape(shape), kern, mode="wrap").reshape(-1)

    def aug_mv(v):
        return np.concatenate([A_flat(v), np.sqrt(alpha) * v])

    def aug_rmv(u):
        return A_flat(u[:n]) + np.sqrt(alpha) * u[n:]

    Aop = scipy.sparse.linalg.LinearOperator((2 * n, n), matvec=aug_mv,
                                             rmatvec=aug_rmv)
    rhs = np.concatenate([b.reshape(-1), np.zeros(n)])
    x_lsmr = scipy.sparse.linalg.lsmr(Aop, rhs, maxiter=400, atol=0,
                                      btol=0)[0].reshape(shape)

    # our CGLS on the shaped problem
    Aj, Aj_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                       method="fft")
    sqrt_a = np.sqrt(alpha)
    x_cgls = cgls(
        lambda x: (Aj(x), sqrt_a * x),
        lambda y: Aj_adj(y[0]) + sqrt_a * y[1],
        (jnp.asarray(b), jnp.zeros(shape)),
        jnp.zeros(shape), iters=400)
    np.testing.assert_allclose(np.asarray(x_cgls), x_lsmr, atol=1e-6)


def test_tikhonov_lsmr_path_objective_parity(rng):
    """Fixed-budget CGLS reaches an objective at least as good as the
    reference's 10-iteration lsmr on TK0 deconvolution."""
    shape = (32, 32)
    cov = np.diag([1.2, 1.2]) ** 2
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(2))
    x_true = rng.rand(*shape)
    b = ndi.convolve(x_true, kern, mode="wrap") + 0.01 * rng.randn(*shape)
    alpha = 0.02
    n = b.size

    def A_flat(v):
        return ndi.convolve(v.reshape(shape), kern, mode="wrap").reshape(-1)

    def aug_mv(v):
        return np.concatenate([A_flat(v), np.sqrt(alpha) * v])

    def aug_rmv(u):
        return A_flat(u[:n]) + np.sqrt(alpha) * u[n:]

    Aop = scipy.sparse.linalg.LinearOperator((2 * n, n), matvec=aug_mv,
                                             rmatvec=aug_rmv)
    rhs = np.concatenate([b.reshape(-1), np.zeros(n)])
    x_ref = np.clip(scipy.sparse.linalg.lsmr(
        Aop, rhs, maxiter=10, atol=0, btol=0)[0], 0, np.inf).reshape(shape)

    Aj, Aj_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                       method="fft")
    ident = lambda z: z
    x_ours = np.asarray(tikhonov_solve(
        Aj, Aj_adj, ident, ident, jnp.asarray(b), 0.0, jnp.zeros(shape),
        alpha, minimizer="lsmr", iter_max=10))

    def objective(x):
        r = ndi.convolve(x, kern, mode="wrap") - b
        return 0.5 * np.sum(r ** 2) + 0.5 * alpha * np.sum(x ** 2)

    assert objective(x_ours) <= objective(x_ref) * 1.01


def test_tikhonov_lbfgs_path_vs_scipy(rng):
    """Robust-loss minimizer path vs scipy L-BFGS-B on the same cost."""
    shape = (16, 18)
    cov = np.diag([1.0, 1.0]) ** 2
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(2))
    x_true = rng.rand(*shape)
    b = ndi.convolve(x_true, kern, mode="wrap") + 0.05 * rng.randn(*shape)
    alpha, scale = 0.05, 0.7

    def cost_np(v):
        x = v.reshape(shape)
        r = (ndi.convolve(x, kern, mode="wrap") - b).reshape(-1)
        c = 0.5 * np.sum(np.asarray(
            lf.huber(jnp.asarray(r ** 2), f_scale=scale)))
        return c + alpha * 0.5 * np.sum(x ** 2)

    def grad_np(v):
        x = v.reshape(shape)
        r = ndi.convolve(x, kern, mode="wrap") - b
        w = np.asarray(lf.gradient_huber(
            jnp.asarray(r ** 2), f_scale=scale)) * r
        g = ndi.convolve(w, kern, mode="wrap") + alpha * x
        return g.reshape(-1)

    res = scipy.optimize.minimize(
        cost_np, np.zeros(shape[0] * shape[1]), jac=grad_np,
        method="L-BFGS-B", bounds=[(0, np.inf)] * b.size,
        options={"maxiter": 100})

    Aj, Aj_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                       method="fft")
    ident = lambda z: z
    x_ours = np.asarray(tikhonov_solve(
        Aj, Aj_adj, ident, ident, jnp.asarray(b), 0.0, jnp.zeros(shape),
        alpha, data_loss="huber", data_loss_scale=scale,
        minimizer="L-BFGS-B", iter_max=100))

    ours_cost = cost_np(x_ours.reshape(-1))
    # Converged-objective parity within 1%
    assert ours_cost <= res.fun * 1.01


def test_tikhonov_irls_path_vs_scipy(rng):
    """IRLS minimizer reaches the L-BFGS-B objective on the robust cost.

    ``minimizer="irls"`` is the documented MM improvement over the
    reference's scipy escape hatch: same cost (the b_reg-ignoring quirk
    included), so the converged objectives must agree.
    """
    shape = (16, 18)
    cov = np.diag([1.0, 1.0]) ** 2
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(2))
    x_true = rng.rand(*shape)
    b = ndi.convolve(x_true, kern, mode="wrap") + 0.05 * rng.randn(*shape)
    alpha, scale = 0.05, 0.7

    def cost_np(v):
        x = v.reshape(shape)
        r = (ndi.convolve(x, kern, mode="wrap") - b).reshape(-1)
        c = 0.5 * np.sum(np.asarray(
            lf.huber(jnp.asarray(r ** 2), f_scale=scale)))
        return c + alpha * 0.5 * np.sum(x ** 2)

    def grad_np(v):
        x = v.reshape(shape)
        r = ndi.convolve(x, kern, mode="wrap") - b
        w = np.asarray(lf.gradient_huber(
            jnp.asarray(r ** 2), f_scale=scale)) * r
        g = ndi.convolve(w, kern, mode="wrap") + alpha * x
        return g.reshape(-1)

    res = scipy.optimize.minimize(
        cost_np, np.zeros(shape[0] * shape[1]), jac=grad_np,
        method="L-BFGS-B", bounds=[(0, np.inf)] * b.size,
        options={"maxiter": 200})

    Aj, Aj_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                       method="fft")
    ident = lambda z: z
    x_ours = np.asarray(tikhonov_solve(
        Aj, Aj_adj, ident, ident, jnp.asarray(b), 0.0, jnp.zeros(shape),
        alpha, data_loss="huber", data_loss_scale=scale,
        minimizer="irls", iter_max=10, irls_cg_iters=10))

    assert cost_np(x_ours.reshape(-1)) <= res.fun * 1.01


def test_tikhonov_irls_linear_matches_bounded_oracle(rng):
    """With a linear loss, IRLS degenerates to projected-Newton CG on the
    quadratic — and honors the box constraints properly (the lsmr path only
    clips post hoc). Oracle: scipy.optimize.lsq_linear on the augmented
    system with bounds."""
    shape = (12, 14)
    cov = np.diag([1.0, 1.0]) ** 2
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(2))
    # Data with a negative bias so the non-negativity bound is active.
    b = ndi.convolve(rng.rand(*shape) - 0.4, kern, mode="wrap")
    alpha = 0.05
    n = b.size

    def A_flat(v):
        return ndi.convolve(v.reshape(shape), kern, mode="wrap").reshape(-1)

    rows = np.stack([A_flat(e) for e in np.eye(n)], axis=1)
    aug = np.vstack([rows, np.sqrt(alpha) * np.eye(n)])
    rhs = np.concatenate([b.reshape(-1), np.zeros(n)])
    res = scipy.optimize.lsq_linear(aug, rhs, bounds=(0, np.inf))

    Aj, Aj_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                       method="fft")
    ident = lambda z: z
    x_ours = np.asarray(tikhonov_solve(
        Aj, Aj_adj, ident, ident, jnp.asarray(b), 0.0, jnp.zeros(shape),
        alpha, data_loss="linear", minimizer="irls", iter_max=8,
        irls_cg_iters=15))

    def objective(x):
        r = A_flat(x.reshape(-1)) - b.reshape(-1)
        return 0.5 * np.sum(r ** 2) + 0.5 * alpha * np.sum(x ** 2)

    assert x_ours.min() >= 0.0
    assert objective(x_ours) <= objective(res.x.reshape(shape)) * 1.005


def test_tikhonov_irls_monotone_descent(rng):
    """Each IRLS sweep decreases the robust cost on this problem. (MM
    descent holds for the unprojected step; the box projection could in
    principle break strict monotonicity — see the note in the irls branch
    of tikhonov_solve — so this is a regression check on representative
    data, not a proof.)"""
    shape = (16, 16)
    cov = np.diag([1.0, 1.0]) ** 2
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(2))
    b = ndi.convolve(rng.rand(*shape), kern, mode="wrap") \
        + 0.05 * rng.randn(*shape)
    alpha, scale = 0.05, 0.5

    Aj, Aj_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                       method="fft")
    ident = lambda z: z

    def cost_np(x):
        r = (ndi.convolve(np.asarray(x), kern, mode="wrap") - b).reshape(-1)
        c = 0.5 * np.sum(np.asarray(
            lf.cauchy(jnp.asarray(r ** 2), f_scale=scale)))
        return c + alpha * 0.5 * np.sum(np.asarray(x) ** 2)

    costs = []
    x = jnp.zeros(shape)
    for _ in range(6):
        x = tikhonov_solve(
            Aj, Aj_adj, ident, ident, jnp.asarray(b), 0.0, x, alpha,
            data_loss="cauchy", data_loss_scale=scale,
            minimizer="irls", iter_max=1, irls_cg_iters=12)
        costs.append(cost_np(x))
    assert all(c1 <= c0 + 1e-9 for c0, c1 in zip(costs, costs[1:]))


def test_admm_irls_matches_lbfgs_objective(rng):
    """Robust ADMM with IRLS inner solves lands on the same (or better)
    total objective as the box-L-BFGS inner path."""
    shape = (24, 24)
    cov = np.diag([1.0, 1.0]) ** 2
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(2))
    x_true = rng.rand(*shape)
    b = ndi.convolve(x_true, kern, mode="wrap") + 0.05 * rng.randn(*shape)
    alpha, rho, scale = 0.01, 0.5, 1.0

    Aj, Aj_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                       method="fft")
    D, D_adj = G.make_gradient_operators(shape)

    def total_objective(x):
        x = np.asarray(x)
        r = (ndi.convolve(x, kern, mode="wrap") - b).reshape(-1)
        data = 0.5 * np.sum(np.asarray(
            lf.huber(jnp.asarray(r ** 2), f_scale=scale)))
        g = np.asarray(G.gradient(jnp.asarray(x)))
        tv = np.sum(np.sqrt(np.sum(g ** 2, axis=0)))
        return data + alpha * tv

    common = dict(b=jnp.asarray(b), b_reg=0.0, x0=jnp.zeros(shape),
                  alpha=alpha, rho=rho, iterations=10,
                  data_loss="huber", data_loss_scale=scale)
    x_lbfgs, _ = admm_solve(Aj, Aj_adj, D, D_adj, iter_max=20,
                            minimizer="L-BFGS-B", **common)
    x_irls, _ = admm_solve(Aj, Aj_adj, D, D_adj, iter_max=5,
                           minimizer="irls", irls_cg_iters=8, **common)
    assert total_objective(x_irls) <= total_objective(x_lbfgs) * 1.02


# --------------------------------------------------------- primal-dual

def test_pd_tvl2_denoising_matches_reference_iterates(rng):
    """Iterate-level parity: identical algorithm, identical operators →
    final x equal to ~1e-8 after 20 iterations."""
    shape = (20, 22)
    b = rng.rand(*shape) * 5.0
    alpha, L2, iters = 0.5, 8.0, 20

    x_ref = _reference_pd_tvl2_denoise(b, alpha, L2, iters)

    grad_j, grad_adj_j = G.make_gradient_operators()
    bj = jnp.asarray(b)
    solver = PrimalDualSolver(
        prox_f=lambda x, tau: prox_ops.prox_ell2_denoising(x, tau, bj),
        prox_g_conj=prox_ops.prox_tv_conj,
        B=grad_j, B_conj=grad_adj_j, L2=L2, x0=b, alpha=alpha,
        iterations=iters)
    solver.run()
    np.testing.assert_allclose(solver.get_x(), x_ref, atol=1e-8)


@pytest.mark.parametrize("alg_type", ["ALG2", "ALG2_AHMOD", "ALG3"])
def test_pd_x_scale_invariance(alg_type, rng):
    """Ports the reference's only solver-level test: solving pre-scaled data
    with x_scale=1 equals solving raw data with x_scale=max(x) to 7 decimals
    (tests/solvers_test.py:68-96)."""
    shape = (18, 16)
    b = rng.rand(*shape) * 255.0
    x_scale = b.max()
    alpha, L2, iters = 0.7, 8.0, 15
    grad_j, grad_adj_j = G.make_gradient_operators()

    def make_solver(b_arr, scale):
        bj = jnp.asarray(b_arr / scale)
        return PrimalDualSolver(
            prox_f=lambda x, tau: prox_ops.prox_ell2_denoising(x, tau, bj),
            prox_g_conj=prox_ops.prox_tv_conj,
            B=grad_j, B_conj=grad_adj_j, L2=L2, x0=b_arr,
            alpha=alpha, iterations=iters, x_scale=scale,
            alg_type=alg_type)

    s1 = make_solver(b / x_scale, 1.0)
    s1.run()
    s2 = make_solver(b, x_scale)
    s2.run()
    np.testing.assert_array_almost_equal(
        s1.get_x(), s2.get_x() / x_scale, decimal=7)


def test_pd_observer_measures_recorded(rng):
    shape = (12, 12)
    b = rng.rand(*shape)
    grad_j, grad_adj_j = G.make_gradient_operators()
    bj = jnp.asarray(b)
    solver = PrimalDualSolver(
        prox_f=lambda x, tau: prox_ops.prox_ell2_denoising(x, tau, bj),
        prox_g_conj=prox_ops.prox_tv_conj,
        B=grad_j, B_conj=grad_adj_j, L2=8.0, x0=b, alpha=0.5, iterations=5)
    obs = Observer()
    obs.set_measures({
        "Data": lambda x: 0.5 * jnp.sum((x - bj) ** 2),
        "Reg": lambda x: jnp.sum(jnp.sqrt(jnp.sum(grad_j(x) ** 2, axis=0))),
    })
    solver.set_observer(obs)
    solver.run()
    res = obs.get_measures_results()
    assert res["Data"].shape == (6,)  # init + 5 iterations
    assert res["Reg"].shape == (6,)
    assert res["Data"][0] == 0.0  # x0 == b
    assert obs.get_computational_time() is not None


# ---------------------------------------------------------------- ADMM

def test_admm_tvl2_deconvolution_objective(rng):
    """ADMM reduces the TV-L2 objective and beats the blurred input."""
    shape = (24, 24)
    cov = np.diag([1.0, 1.0]) ** 2
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(2))
    x_true = np.zeros(shape)
    x_true[6:18, 6:18] = 1.0
    b = ndi.convolve(x_true, kern, mode="wrap") + 0.02 * rng.randn(*shape)
    alpha, rho = 0.01, 0.5

    Aj, Aj_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                       method="fft")
    grad_j, grad_adj_j = G.make_gradient_operators()
    solver = ADMMLinearSolver(
        A=Aj, A_adj=Aj_adj, b=b, B=grad_j, B_adj=grad_adj_j,
        x0=np.array(b), dimension=2, alpha=alpha, rho=rho,
        iterations=20, iter_max=10)
    solver.run()
    x = solver.get_x()

    def objective(v):
        r = ndi.convolve(v, kern, mode="wrap") - b
        g = np.stack([
            ndi.convolve(v, K.forward_difference_kernel(1, 2),
                         mode="constant"),
            ndi.convolve(v, K.forward_difference_kernel(0, 2),
                         mode="constant")])
        return 0.5 * np.sum(r ** 2) + alpha * np.sum(
            np.sqrt(np.sum(g ** 2, axis=0)))

    assert objective(x) < objective(b)
    # Reconstruction should be closer to the truth than the observation.
    assert np.mean((x - x_true) ** 2) < np.mean((b - x_true) ** 2)


def test_admm_x_scale_invariance(rng):
    shape = (16, 16)
    cov = np.diag([0.8, 0.8]) ** 2
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(2))
    x_true = rng.rand(*shape) * 200.0
    b = ndi.convolve(x_true, kern, mode="wrap")
    x_scale = b.max()

    Aj, Aj_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                       method="fft")
    grad_j, grad_adj_j = G.make_gradient_operators()

    def run(b_arr, scale):
        s = ADMMLinearSolver(
            A=Aj, A_adj=Aj_adj, b=b_arr, B=grad_j, B_adj=grad_adj_j,
            x0=np.array(b_arr), dimension=2, alpha=0.05, rho=0.5,
            iterations=8, iter_max=10, x_scale=scale)
        s.run()
        return s.get_x()

    x1 = run(b / x_scale, 1.0)
    x2 = run(b, x_scale)
    np.testing.assert_array_almost_equal(x1, x2 / x_scale, decimal=7)


def test_tikhonov_wrapper_scale_invariance(rng):
    shape = (16, 16)
    cov = np.diag([0.8, 0.8]) ** 2
    x_true = rng.rand(*shape) * 100.0
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(2))
    b = ndi.convolve(x_true, kern, mode="wrap")
    x_scale = b.max()

    Aj, Aj_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                       method="fft")
    ident = lambda z: z

    def run(b_arr, scale):
        s = TikhonovLinearSolver(
            A=Aj, A_adj=Aj_adj, b=b_arr, B=ident, B_adj=ident,
            x0=np.zeros(shape), alpha=0.02, iter_max=15, x_scale=scale)
        s.run()
        return s.get_x()

    x1 = run(b / x_scale, 1.0)
    x2 = run(b, x_scale)
    np.testing.assert_array_almost_equal(x1, x2 / x_scale, decimal=7)


def _reference_pd_denoise_oracle(b, alpha, L2, iterations, alg_type,
                                 variant="TVL2"):
    """Literal numpy evaluation of the reference PD iteration for all three
    step-size schedules (nsol/primal_dual_solver.py:215-403)."""
    shape = b.shape
    grad, grad_adj = _np_gradient_ops(shape)
    lmbda = 1.0 / alpha
    if alg_type == "ALG2":
        tau = 1.0 / np.sqrt(L2)
        sigma = 1.0 / (L2 * tau)
        gamma = 0.35 * lmbda
    elif alg_type == "ALG2_AHMOD":
        tau = 0.02
        sigma = 4.0 / (L2 * tau)
        gamma = 0.35 * lmbda
    else:  # ALG3
        gamma_l = lmbda
        delta = 0.05
        mu = 2.0 * np.sqrt(gamma_l * delta / L2)
        theta_const = 1.0 / (1.0 + mu)
        sigma = mu / (2.0 * delta)
        tau = mu / (2.0 * gamma_l)

    def prox_g_conj(q, sg):
        if variant.startswith("TV"):
            return q / np.maximum(1, np.abs(q))
        y = q / (1.0 + sg * 0.05)
        return y / np.maximum(1, np.abs(y))

    x = b.copy()
    x_mean = b.copy()
    p = np.zeros((len(shape),) + shape)
    for _ in range(iterations):
        p = prox_g_conj(p + sigma * grad(x_mean), sigma)
        t = x - tau * grad_adj(p)
        tl = tau * lmbda
        x_new = (t + tl * b) / (1.0 + tl)
        if alg_type == "ALG2":
            theta = 1.0 / np.sqrt(1.0 + 2.0 * gamma * tau)
            tau *= theta
            sigma /= theta
        elif alg_type == "ALG2_AHMOD":
            th = 1.0 / np.sqrt(1.0 + 2.0 * gamma * tau)
            tau *= th
            sigma /= th
            theta = 0.0
        else:
            theta = theta_const
        x_mean = x_new + theta * (x_new - x)
        x = x_new
    return x


@pytest.mark.parametrize("alg_type", ["ALG2_AHMOD", "ALG3"])
def test_pd_alg_variants_match_reference_iterates(alg_type, rng):
    """Iterate-level parity for the AHMOD and ALG3 step schedules."""
    b = rng.rand(16, 18) * 4.0
    alpha, L2, iters = 0.5, 8.0, 15
    x_ref = _reference_pd_denoise_oracle(b, alpha, L2, iters, alg_type)

    grad_j, grad_adj_j = G.make_gradient_operators()
    bj = jnp.asarray(b)
    solver = PrimalDualSolver(
        prox_f=lambda x, tau: prox_ops.prox_ell2_denoising(x, tau, bj),
        prox_g_conj=prox_ops.prox_tv_conj,
        B=grad_j, B_conj=grad_adj_j, L2=L2, x0=np.array(b), alpha=alpha,
        iterations=iters, alg_type=alg_type)
    solver.run()
    np.testing.assert_allclose(solver.get_x(), x_ref, atol=1e-9)


def test_pd_huber_conj_matches_reference_iterates(rng):
    """HuberL2 denoising (prox_huber_conj dual) iterate parity."""
    b = rng.rand(14, 14) * 3.0
    alpha, L2, iters = 0.6, 8.0, 12
    x_ref = _reference_pd_denoise_oracle(b, alpha, L2, iters, "ALG2",
                                         variant="HuberL2")
    grad_j, grad_adj_j = G.make_gradient_operators()
    bj = jnp.asarray(b)
    solver = PrimalDualSolver(
        prox_f=lambda x, tau: prox_ops.prox_ell2_denoising(x, tau, bj),
        prox_g_conj=prox_ops.prox_huber_conj,
        B=grad_j, B_conj=grad_adj_j, L2=L2, x0=np.array(b), alpha=alpha,
        iterations=iters)
    solver.run()
    np.testing.assert_allclose(solver.get_x(), x_ref, atol=1e-9)


def test_tikhonov_lsq_linear_matches_scipy(rng):
    """``minimizer="lsq_linear"`` (projected FISTA on the normal equations)
    vs the scipy.optimize.lsq_linear oracle on the same bounded augmented
    system (reference dispatch: nsol/tikhonov_linear_solver.py:161-171).
    Bias the data negative so the non-negativity bound is active."""
    shape = (12, 14)
    cov = np.diag([1.0, 1.0]) ** 2
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(2))
    b = ndi.convolve(rng.rand(*shape) - 0.4, kern, mode="wrap")
    alpha = 0.05
    n = b.size

    def A_flat(v):
        return ndi.convolve(v.reshape(shape), kern, mode="wrap").reshape(-1)

    rows = np.stack([A_flat(e) for e in np.eye(n)], axis=1)
    aug = np.vstack([rows, np.sqrt(alpha) * np.eye(n)])
    rhs = np.concatenate([b.reshape(-1), np.zeros(n)])
    res = scipy.optimize.lsq_linear(aug, rhs, bounds=(0, np.inf))

    Aj, Aj_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                       method="fft")
    ident = lambda z: z
    x_ours = np.asarray(tikhonov_solve(
        Aj, Aj_adj, ident, ident, jnp.asarray(b), 0.0, jnp.zeros(shape),
        alpha, data_loss="linear", minimizer="lsq_linear", iter_max=400))

    def objective(x):
        r_aug = aug @ x.reshape(-1) - rhs
        return 0.5 * np.sum(r_aug ** 2)

    assert x_ours.min() >= 0.0
    assert objective(x_ours) <= objective(res.x) * 1.005


def test_tikhonov_least_squares_matches_scipy(rng):
    """``minimizer="least_squares"`` applies the robust loss to the WHOLE
    augmented residual (reference: nsol/tikhonov_linear_solver.py:174-194)
    — oracle: scipy.optimize.least_squares(method='trf') with the same
    loss/f_scale/bounds on the dense augmented system.

    Uses soft_l1 and cauchy, where the package's loss convention is
    bit-identical to scipy's (huber differs: reference γ=1.345 vs scipy
    γ=1) and the cost is smooth, so both optimizers reach the same
    minimum. Both start from clip(b) — the reference clips x0 into the
    bounds and its apps seed from the observation. huber is not oracle-
    checked here: its ρ' kink can stall the box L-BFGS a few % above the
    TRF optimum (seed-dependent), a known optimizer-quality limit noted
    in the least_squares branch of tikhonov_solve.
    """
    shape = (10, 12)
    cov = np.diag([1.0, 1.0]) ** 2
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(2))
    b = ndi.convolve(rng.rand(*shape), kern, mode="wrap") \
        + 0.3 * rng.randn(*shape)
    alpha, scale = 0.05, 0.5
    n = b.size

    def A_flat(v):
        return ndi.convolve(v.reshape(shape), kern, mode="wrap").reshape(-1)

    rows = np.stack([A_flat(e) for e in np.eye(n)], axis=1)
    aug = np.vstack([rows, np.sqrt(alpha) * np.eye(n)])
    rhs = np.concatenate([b.reshape(-1), np.zeros(n)])
    x0 = np.clip(b.reshape(-1), 0, None)

    Aj, Aj_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                       method="fft")
    ident = lambda z: z

    def objective(x, loss_fn):
        r_aug = jnp.asarray(aug @ np.asarray(x).reshape(-1) - rhs)
        return 0.5 * float(np.sum(np.asarray(
            loss_fn(r_aug ** 2, f_scale=scale))))

    for loss, loss_fn, tol in (("soft_l1", lf.soft_l1, 1.0 + 1e-6),
                               ("cauchy", lf.cauchy, 1.0 + 1e-5)):
        res = scipy.optimize.least_squares(
            lambda x: aug @ x - rhs, x0, method="trf", loss=loss,
            f_scale=scale, bounds=(0, np.inf))
        x_ours = np.asarray(tikhonov_solve(
            Aj, Aj_adj, ident, ident, jnp.asarray(b), 0.0,
            jnp.asarray(x0.reshape(shape)), alpha, data_loss=loss,
            data_loss_scale=scale, minimizer="least_squares",
            iter_max=300))
        assert x_ours.min() >= 0.0
        # compare under OUR loss convention at both solutions (scipy's
        # huber γ differs, so res.cost itself is not directly comparable)
        assert objective(x_ours, loss_fn) <= \
            objective(res.x, loss_fn) * tol, loss


def test_resolve_minimizer():
    """minimizer='auto' picks the fastest valid inner engine by
    data-loss/separability (mirroring parallel/mesh.py's auto-select);
    explicit strings pass through untouched."""
    from nsol_tpu.solvers.tikhonov import resolve_minimizer

    sep = np.diag([1.0, 1.0])
    nonsep = np.array([[1.0, 0.6], [0.6, 1.0]])
    assert resolve_minimizer("auto", "linear", cov=sep) == "cg"
    assert resolve_minimizer("auto", "huber", cov=sep) == "irls"
    assert resolve_minimizer("auto", "linear", cov=nonsep) == "lsmr"
    assert resolve_minimizer("auto", "cauchy", cov=nonsep) == "L-BFGS-B"
    # no blur information at all -> reference defaults
    assert resolve_minimizer("auto", "linear") == "lsmr"
    assert resolve_minimizer("auto", "soft_l1") == "L-BFGS-B"
    for explicit in ("lsmr", "cg", "irls", "L-BFGS-B"):
        assert resolve_minimizer(explicit, "linear", cov=sep) == explicit


def test_admm_wrapper_auto_minimizer_builds_hints(rng):
    """ADMMLinearSolver(minimizer='auto') with the blur_cov hint
    resolves to cg, auto-builds the fused normal operators, and matches
    an explicit minimizer='cg' solve; a reflective set_data_loss to a
    robust loss re-resolves to irls."""
    from nsol_tpu.ops import conv as C, grad as G
    from nsol_tpu.solvers.wrappers import ADMMLinearSolver

    shape = (24, 20)
    cov = np.diag([1.0, 1.0])
    b = rng.rand(*shape).astype(np.float32)
    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                     dtype=np.float32)
    Bg, Bg_adj = G.make_gradient_operators()

    def build(minimizer):
        return ADMMLinearSolver(
            A=A, A_adj=A_adj, b=b, B=Bg, B_adj=Bg_adj, x0=np.array(b),
            alpha=0.01, rho=0.5, iterations=3, iter_max=4,
            minimizer=minimizer, x_scale=float(b.max()),
            blur_cov=cov, dimension=2)

    s_auto = build("auto")
    assert s_auto._resolved_minimizer() == "cg"
    s_auto.run()
    assert s_auto._normal_A is not None  # hints auto-built
    assert s_auto._normal_B is not None
    s_cg = build("cg")
    s_cg.run()
    np.testing.assert_allclose(s_auto.get_x(), s_cg.get_x(), atol=1e-6)

    s_auto.set_data_loss("huber")
    assert s_auto._resolved_minimizer() == "irls"
