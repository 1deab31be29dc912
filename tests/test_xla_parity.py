"""The XLA solver paths against independent float64 numpy/scipy references.

Each reference below re-implements one algorithm in plain numpy with
``scipy.ndimage`` stencils (wrap-boundary blur, zero-padded forward
differences), sharing no operator or solver code with the package. The
configurations are those the accelerator kernels used to cover: PD
denoising for every reconstruction type and step schedule, ADMM
TV-deconvolution with linear and robust losses, TK0/TK1 Tikhonov, the
normal operators with anisotropic spacing on non-cubic shapes, and the
wrappers' vmapped sweeps.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi

import jax
import jax.numpy as jnp

from nsol_tpu.ops import conv as C
from nsol_tpu.ops import grad as G
from nsol_tpu.ops import kernels as K
from nsol_tpu.ops import matmul_ops as MM
from nsol_tpu.ops import prox as P
from nsol_tpu.solvers.admm import admm_solve
from nsol_tpu.solvers.primal_dual import primal_dual_solve
from nsol_tpu.solvers.tikhonov import tikhonov_solve

SHAPES = {2: (20, 17), 3: (10, 9, 7)}
HUBER_GAMMA = 1.345


# ---------------------------------------------------------------------------
# numpy references
# ---------------------------------------------------------------------------

def np_grad(x, spacing=None):
    """Stacked forward differences; component i is array axis ndim-1-i."""
    s = np.ones(x.ndim) if spacing is None else np.asarray(spacing, float)
    return np.stack([np.diff(x, axis=x.ndim - 1 - i, append=0) / s[i]
                     for i in range(x.ndim)])


def np_grad_adj(g, spacing=None):
    ndim = g.ndim - 1
    s = np.ones(ndim) if spacing is None else np.asarray(spacing, float)
    out = np.zeros(g.shape[1:])
    for i in range(ndim):
        ax = ndim - 1 - i
        y = g[i]
        lower = np.concatenate(
            [np.zeros_like(np.take(y, [0], axis=ax)),
             np.take(y, np.arange(y.shape[ax] - 1), axis=ax)], axis=ax)
        out += (lower - y) / s[i]
    return out


def np_blur(x, kernel):
    return ndi.convolve(x, kernel, mode="wrap")


def np_loss_grad(loss, f2):
    if loss == "linear":
        return np.ones_like(f2)
    if loss == "soft_l1":
        return 1.0 / np.sqrt(1.0 + f2)
    if loss == "huber":
        return np.where(f2 < HUBER_GAMMA ** 2, 1.0,
                        HUBER_GAMMA / np.sqrt(np.maximum(f2, 1e-300)))
    raise ValueError(loss)


def np_cg(apply_M, rhs, x0, iters):
    r = rhs - apply_M(x0)
    x, p, gamma = x0.copy(), r.copy(), np.sum(r * r)
    for _ in range(iters):
        q = apply_M(p)
        pq = np.sum(p * q)
        a = gamma / pq if pq > 0 else 0.0
        x = x + a * p
        r = r - a * q
        gamma_new = np.sum(r * r)
        beta = gamma_new / gamma if gamma > 0 else 0.0
        p = r + beta * p
        gamma = gamma_new
    return x


def np_tikhonov(A, B, Bt, b, b_reg, x0, alpha, loss="linear", iter_max=5,
                cg_iters=4):
    """``min ½Σρ(r²) + α/2‖Bx − b_reg‖²`` with box (0, ∞): normal-equation
    CG for the linear loss, projected-Newton IRLS otherwise (whose cost
    ignores ``b_reg``, as the reference's minimize path does)."""
    x0 = np.maximum(x0, 0.0)
    if loss == "linear":
        x = np_cg(lambda v: A(A(v)) + alpha * Bt(B(v)),
                  A(b) + alpha * Bt(b_reg), x0, iter_max)
        return np.maximum(x, 0.0)
    x = x0
    for _ in range(iter_max):
        r = A(x) - b
        w = np_loss_grad(loss, r * r)
        g = A(w * r) + alpha * Bt(B(x))
        free = np.where((x <= 0) & (g > 0), 0.0, 1.0)

        def apply_M(v):
            vf = free * v
            return free * (A(w * A(vf)) + alpha * Bt(B(vf))) + (v - vf)

        v = np_cg(apply_M, -free * g, np.zeros_like(x), cg_iters)
        x = np.maximum(x + v, 0.0)
    return x


def np_admm(A, b, alpha, rho, iterations, loss, iter_max, cg_iters):
    x = b.copy()
    v = np_grad(x)
    w = np.zeros_like(v)
    for _ in range(iterations):
        x = np_tikhonov(A, np_grad, np_grad_adj, b, v - w, x, rho, loss,
                        iter_max, cg_iters)
        t = np_grad(x) + w
        norm = np.sqrt(np.sum(t * t, axis=0))
        shrink = np.where(norm > alpha / rho,
                          (norm - alpha / rho) / np.where(norm > 0, norm, 1),
                          0.0)
        v = t * shrink
        w = t - v
    return x


def np_pd(rtype, alg, b, alpha, L2, iterations):
    """Chambolle–Pock with the reference's three step schedules."""
    lmbda = 1.0 / alpha
    if alg == "ALG2":
        tau = 1.0 / np.sqrt(L2)
        sigma = 1.0 / (L2 * tau)
        gamma = 0.35 * lmbda
    elif alg == "ALG2_AHMOD":
        tau = 0.02
        sigma = 4.0 / (L2 * tau)
        gamma = 0.35 * lmbda
    else:
        delta = 0.05
        mu = 2.0 * np.sqrt(lmbda * delta / L2)
        theta_c = 1.0 / (1.0 + mu)
        sigma = mu / (2.0 * delta)
        tau = mu / (2.0 * lmbda)

    def prox_f(x, t):
        if rtype.endswith("L1"):
            d = x - b
            return b + np.sign(d) * np.maximum(np.abs(d) - t, 0.0)
        return (x + t * b) / (1.0 + t)

    def prox_g_conj(p, s):
        if rtype.startswith("Huber"):
            p = p / (1.0 + s * 0.05)
        return p / np.maximum(1.0, np.abs(p))

    x = b.copy()
    x_mean = b.copy()
    p = np.zeros_like(np_grad(b))
    for _ in range(iterations):
        p = prox_g_conj(p + sigma * np_grad(x_mean), sigma)
        x_new = prox_f(x - tau * np_grad_adj(p), tau * lmbda)
        if alg == "ALG3":
            theta = theta_c
        else:
            th = 1.0 / np.sqrt(1.0 + 2.0 * gamma * tau)
            tau, sigma = tau * th, sigma / th
            theta = th if alg == "ALG2" else 0.0
        x_mean = x_new + theta * (x_new - x)
        x = x_new
    return x


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------

def _kernel(ndim, spacing=None):
    return K.gaussian_kernel(np.eye(ndim), alpha_cut=3, spacing=spacing)


def _observation(ndim, seed=0, blur=True):
    rng = np.random.RandomState(seed)
    x = ndi.gaussian_filter(rng.rand(*SHAPES[ndim]), 1.0)
    x = (x > np.median(x)) * 0.8 + 0.1
    if blur:
        x = np_blur(x, _kernel(ndim))
    return x + 0.05 * rng.randn(*x.shape)


def _blur_ops(shape):
    cov = np.eye(len(shape))
    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                     method="auto")
    return cov, A, A_adj


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("alg", ["ALG2", "ALG2_AHMOD", "ALG3"])
@pytest.mark.parametrize("rtype", ["TVL1", "TVL2", "HuberL1", "HuberL2"])
def test_primal_dual_matches_numpy(rtype, alg, ndim):
    b = _observation(ndim, blur=False)
    alpha, L2, iters = 0.3, 4.0 * ndim, 15
    bj = jnp.asarray(b)
    prox_f = (P.prox_ell1_denoising if rtype.endswith("L1")
              else P.prox_ell2_denoising)
    prox_g = (P.prox_tv_conj if rtype.startswith("TV")
              else P.prox_huber_conj)
    Bg, Bg_adj = G.make_gradient_operators()
    x, _ = jax.jit(lambda b0: primal_dual_solve(
        lambda x, t: prox_f(x, t, b0), prox_g, Bg, Bg_adj, b0, alpha, L2,
        iterations=iters, alg_type=alg))(bj)
    want = np_pd(rtype, alg, b, alpha, L2, iters)
    np.testing.assert_allclose(np.asarray(x), want, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("loss", ["linear", "huber", "soft_l1"])
def test_admm_tv_deconvolution_matches_numpy(loss, ndim):
    b = _observation(ndim)
    shape = b.shape
    cov, A, A_adj = _blur_ops(shape)
    minimizer = "cg" if loss == "linear" else "irls"
    nA = C.make_normal_blur_operator(cov, alpha_cut=3, shape=shape)
    nB = MM.matmul_gradient_normal_fn(shape, dtype=np.float64)
    Bg, Bg_adj = G.make_gradient_operators()
    x, _ = jax.jit(lambda b0: admm_solve(
        A, A_adj, Bg, Bg_adj, b0, 0.0, b0, 0.02, 0.5, iterations=4,
        iter_max=3, data_loss=loss, minimizer=minimizer,
        normal_A=nA if minimizer == "cg" else None, normal_B=nB,
        irls_cg_iters=3))(jnp.asarray(b))
    kern = _kernel(ndim)
    want = np_admm(lambda v: np_blur(v, kern), b, 0.02, 0.5, 4, loss, 3, 3)
    np.testing.assert_allclose(np.asarray(x), want, rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("loss", ["linear", "huber"])
@pytest.mark.parametrize("reg", ["TK0", "TK1"])
def test_tikhonov_matches_numpy(reg, loss):
    b = _observation(2) * 3.0  # robust weights active on the larger residuals
    shape = b.shape
    cov, A, A_adj = _blur_ops(shape)
    ident = lambda v: v
    if reg == "TK0":
        B, Bt, nB = ident, ident, ident
        np_B = np_Bt = ident
    else:
        B, Bt = G.make_gradient_operators()
        nB = G.gradient_normal
        np_B, np_Bt = np_grad, np_grad_adj
    minimizer = "cg" if loss == "linear" else "irls"
    nA = C.make_normal_blur_operator(cov, alpha_cut=3, shape=shape)
    x = jax.jit(lambda b0: tikhonov_solve(
        A, A_adj, B, Bt, b0, 0.0, b0, 0.05, data_loss=loss,
        minimizer=minimizer, iter_max=4, normal_A=nA, normal_B=nB,
        irls_cg_iters=3))(jnp.asarray(b))
    kern = _kernel(2)
    want = np_tikhonov(lambda v: np_blur(v, kern), np_B, np_Bt, b,
                       np.zeros_like(np_B(b)), b, 0.05, loss, 4, 3)
    np.testing.assert_allclose(np.asarray(x), want, rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("spacing", [None, "aniso"])
@pytest.mark.parametrize("form", ["normal", "weighted"])
@pytest.mark.parametrize("shape", [(18, 13), (11, 8, 14)])
def test_normal_operators_match_scipy(shape, form, spacing):
    """``AᵀA + ρDᵀD`` (CG apply) and ``Aᵀ(w⊙Av) + ρDᵀD`` (IRLS apply)
    on the CLI's operators against ``scipy.ndimage``."""
    ndim = len(shape)
    sp = None if spacing is None else [1.3, 0.7, 2.0][:ndim]
    cov = np.diag([1.0, 1.4, 0.8][:ndim]) ** 2
    rng = np.random.RandomState(3)
    v = rng.rand(*shape)
    w = rng.rand(*shape)
    rho = 0.7
    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, spacing=sp,
                                     shape=shape, method="auto")
    nA = C.make_normal_blur_operator(cov, alpha_cut=3, spacing=sp,
                                     shape=shape)
    nB = MM.matmul_gradient_normal_fn(shape, sp, dtype=np.float64)
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=sp)
    DtD = np_grad_adj(np_grad(v, sp), sp)
    vj, wj = jnp.asarray(v), jnp.asarray(w)
    if form == "normal":
        got = jax.jit(lambda u: nA(u) + rho * nB(u))(vj)
        want = np_blur(np_blur(v, kern), kern) + rho * DtD
    else:
        got = jax.jit(lambda u, ww: A_adj(ww * A(u)) + rho * nB(u))(vj, wj)
        want = np_blur(w * np_blur(v, kern), kern) + rho * DtD
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10,
                               atol=1e-12)


def _sweep_solver(kind, ndim):
    """A wrapper solver, its sweep grid and Reg/Data measures."""
    from nsol_tpu.ops import losses as lf, measures as sim, priors
    from nsol_tpu.solvers.wrappers import (
        ADMMLinearSolver, PrimalDualSolver, TikhonovLinearSolver)

    Bg, Bg_adj = G.make_gradient_operators()
    if kind == "pd":
        b = _observation(ndim, blur=False) * 100.0
        s = float(b.max())
        bj = jnp.asarray(b / s)
        solver = PrimalDualSolver(
            lambda x, t: P.prox_ell2_denoising(x, t, bj), P.prox_tv_conj,
            Bg, Bg_adj, L2=8, x0=b, iterations=6, x_scale=s)
        measures = {"Reg": lambda x: priors.total_variation(x, Bg),
                    "Data": lambda x: sim.sum_of_squared_differences(
                        x, jnp.asarray(b))}
        return solver, {"alpha": np.array([0.05, 0.2, 0.6])}, measures
    b = _observation(ndim) * 100.0
    cov, A, A_adj = _blur_ops(b.shape)
    data = lambda x: lf.cost_from_residual(A(x) - jnp.asarray(b))
    if kind == "admm":
        solver = ADMMLinearSolver(
            A=A, A_adj=A_adj, b=b, B=Bg, B_adj=Bg_adj, x0=b,
            iterations=3, iter_max=4, minimizer="auto",
            x_scale=float(b.max()), blur_cov=cov)
        grid = {"alpha": np.array([0.01, 0.01, 0.05]),
                "rho": np.array([0.3, 1.0, 0.5])}
        return solver, grid, {
            "Reg": lambda x: priors.total_variation(x, Bg), "Data": data}
    solver = TikhonovLinearSolver(
        A=A, A_adj=A_adj, b=b, B=Bg, B_adj=Bg_adj, x0=b, iter_max=5,
        minimizer="auto", x_scale=float(b.max()), blur_cov=cov,
        reg_kind="TK1")
    return solver, {"alpha": np.array([0.01, 0.1, 0.4])}, {
        "Reg": lambda x: priors.first_order_tikhonov(x, Bg), "Data": data}


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("kind", ["pd", "admm", "tk1"])
def test_run_sweep_matches_serial_solves(kind, ndim):
    """Each wrapper's vmapped ``run_sweep`` equals serial ``run()`` calls
    of the same solver, iterates and Reg/Data records alike."""
    solver, grid, measures = _sweep_solver(kind, ndim)
    x_all, recs = solver.run_sweep(grid, measures=measures)
    n = len(next(iter(grid.values())))
    assert x_all.shape == (n,) + np.asarray(solver.get_x0()).shape
    for i in range(n):
        for key, vals in grid.items():
            getattr(solver, "set_" + key)(vals[i])
        solver.run()
        x = solver.get_x()
        np.testing.assert_allclose(x_all[i], x, rtol=1e-9, atol=1e-9)
        for name, fn in measures.items():
            assert recs[name].shape[0] == n
            np.testing.assert_allclose(recs[name][i][-1],
                                       float(fn(jnp.asarray(x))),
                                       rtol=1e-9)
