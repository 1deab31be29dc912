"""Benchmark suite over the BASELINE.json configurations, XLA paths only.

Covers configs 1-4 (the north-star config 3 solve lives in bench.py; the
sharded config 5 runs in ``chip_smoke.py --four-cards``) plus the scale
legs:

1. 2D Lena 256 TV-L2 denoising, Chambolle–Pock, 50 iters (single and
   batched ×64)
2. 2D Lena 256 robust L2-deconvolution (Gaussian blur, huber loss), ADMM
   with box-L-BFGS or IRLS inner solves (single and batched ×16)
3. Shepp-Logan 64³ ADMM batched ×16, and the 8×8 alpha×rho study sweep
4. Batched 64-alpha L-curve sweep over 2D Man 1024 TV-L2 denoising
5. TK1L2 64-alpha sweep over Lena 256², and the synthetic 256³ linear,
   256³ huber and 512³ linear deconvolutions

Timing: each timed call starts from the previous call's output and the
window ends in ``block_until_ready``. Prints one JSON line per config,
each naming the device it ran on.

Usage: ``python benchmarks/suite.py [NAME_SUBSTRING ...] [--trace DIR]``;
``--trace`` writes a ``jax.profiler`` trace of one more call after each
config's (untraced) timed window under ``DIR/<config>``; read it with
benchmarks/trace_summary.py.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nsol_tpu.jitutil import jit_closed, setup_compile_cache  # noqa: E402
from nsol_tpu.io import DataReader  # noqa: E402
from nsol_tpu.ops import conv as C  # noqa: E402
from nsol_tpu.ops import grad as G  # noqa: E402
from nsol_tpu.ops import prox as prox_ops  # noqa: E402
from nsol_tpu.solvers import primal_dual as _pd  # noqa: E402
from nsol_tpu.solvers import admm as _admm  # noqa: E402
from nsol_tpu.data import data_dir  # noqa: E402

DTYPE = np.float32
#: where ``--trace`` writes; None runs untraced
TRACE_DIR = None


def _read(name):
    r = DataReader(os.path.join(data_dir(), name))
    r.read_data()
    return r.get_data().astype(DTYPE)


def _chain_time(fn, x0, n=10, tag=None):
    """Seconds per call of ``fn`` after one warm-up call, chained: each
    call starts from the previous call's output. ``fn`` may return the iterate alone or a tuple
    whose first element is it. With ``TRACE_DIR`` set, one more call after
    the untraced window is traced into ``TRACE_DIR/<tag>``."""
    from nsol_tpu import profiling

    def step(x):
        out = fn(x)
        return out[0] if isinstance(out, tuple) else out

    # one untimed step first: it compiles the eager ops ``fn`` wraps
    # around its jitted call (e.g. an index into the result)
    xi = jax.block_until_ready(step(x0))
    t0 = time.perf_counter()
    for _ in range(n):
        xi = step(xi)
    jax.block_until_ready(xi)
    per = (time.perf_counter() - t0) / n
    if TRACE_DIR and tag:
        with profiling.trace(os.path.join(TRACE_DIR, tag)):
            jax.block_until_ready(step(xi))
    return per


def config1_lena_pd_denoise():
    """2D Lena 256 TV-L2 denoising, PD ALG2, 50 iterations."""
    noisy = _read("2D_Lena_256_noise.png")
    x_scale = float(noisy.max())
    b = jnp.asarray(noisy / x_scale)
    grad_op, grad_adj = G.make_gradient_operators()

    def solve(x0):
        def prox_f(x, tau):
            return prox_ops.prox_ell2_denoising(x, tau, b)

        x, _ = _pd.primal_dual_solve(
            prox_f, prox_ops.prox_tv_conj, grad_op, grad_adj,
            x0, jnp.asarray(0.6, DTYPE), jnp.asarray(8.0, DTYPE),
            iterations=50)
        return x

    f = jit_closed(solve, (b,))
    jax.block_until_ready(f(b))
    tag = "lena256_tvl2_pd_50it"
    per = _chain_time(f, b, tag=tag)
    return {"config": tag,
            "iters_per_sec": round(50 / per, 1),
            "ms_per_solve": round(per * 1e3, 3)}


def _config2_run(minimizer, iter_max, tag, **solver_kw):
    """2D Lena 256 robust (huber) L2-deconvolution, ADMM — the robust-loss
    minimizer path. ``minimizer`` selects the inner engine: "L-BFGS-B"
    (reference-parity box quasi-Newton) or "irls" (MM reweighted CG, the
    documented improvement). Reports the converged total objective
    ``½Σ huber(r²) + α·TV(x)`` so the two inner engines' parity is visible
    in the JSON."""
    from nsol_tpu.ops import losses as lf

    blurred = _read("2D_Lena_256_blur_noise.png")
    x_scale = float(blurred.max())
    b = jnp.asarray(blurred / x_scale)
    cov = np.diag([1.0, 1.0])
    A, A_adj = C.make_blur_operators(cov, alpha_cut=3,
                                     shape=blurred.shape, method="auto",
                                     dtype=DTYPE)
    Bg, Bg_adj = G.make_gradient_operators()
    br = jnp.zeros((2,) + blurred.shape, DTYPE)
    alpha = jnp.asarray(0.01, DTYPE)

    def solve(x0):
        x, _ = _admm.admm_solve(
            A, A_adj, Bg, Bg_adj, b, br, x0,
            alpha, jnp.asarray(0.5, DTYPE),
            iterations=10, iter_max=iter_max, data_loss="huber",
            data_loss_scale=1.0, minimizer=minimizer, **solver_kw)
        r = (A(x) - b).reshape(-1)
        g = Bg(x)
        obj = 0.5 * jnp.sum(lf.huber(r * r, f_scale=1.0)) \
            + alpha * jnp.sum(jnp.sqrt(jnp.sum(g * g, axis=0)))
        return x, obj

    f = jit_closed(solve, (b,))
    _, obj = f(b)
    objective = float(np.asarray(obj))

    # the timed region includes the objective computation for both inner
    # engines — fair relatively, ~1 op-chain heavier than a bare solve
    per = _chain_time(f, b, n=5, tag=tag)
    return {"config": tag,
            "iters_per_sec": round(10 / per, 1),
            "ms_per_solve": round(per * 1e3, 3),
            "objective": round(objective, 2)}


def config2_lena_robust_deconv():
    return _config2_run("L-BFGS-B", 10, "lena256_huber_admm_lbfgs_10it")


def config2_lena_robust_deconv_irls():
    # 3 sweeps x 6 CG reaches the same converged objective as the L-BFGS
    # path (the JSON reports both; the suite gates their agreement)
    return _config2_run("irls", 3, "lena256_huber_admm_irls_10it",
                        irls_cg_iters=6)


def _batched(tag, one, b, alphas, iters):
    """Batched protocol for the small configs: ONE vmapped batch of
    ``len(alphas)`` solves per dispatch, chained across calls (each
    round's outputs are the next round's x0 batch); per-solve time =
    batch time / batch."""
    NB = len(alphas)
    X0 = jnp.broadcast_to(b, (NB,) + b.shape)
    f = jit_closed(lambda X: jax.vmap(one)(alphas, X), (X0,))
    jax.block_until_ready(f(X0))
    per = _chain_time(f, X0, n=6, tag=tag) / NB
    return {"config": tag, "batch": NB,
            "ms_per_solve": round(per * 1e3, 3),
            "iters_per_sec": round(iters / per, 1)}


def config1_batched():
    """Config 1 (Lena 256² TVL2 PD, 50 it), 64 solves per dispatch."""
    noisy = _read("2D_Lena_256_noise.png")
    b = jnp.asarray(noisy / float(noisy.max()))
    alphas = jnp.linspace(0.3, 0.9, 64, dtype=DTYPE)
    grad_op, grad_adj = G.make_gradient_operators()
    L2 = jnp.asarray(8.0, DTYPE)

    def one(alpha, x0):
        def prox_f(x, tau):
            return prox_ops.prox_ell2_denoising(x, tau, b)

        x, _ = _pd.primal_dual_solve(
            prox_f, prox_ops.prox_tv_conj, grad_op, grad_adj,
            x0, alpha, L2, iterations=50)
        return x

    return _batched("lena256_tvl2_pd_50it_batched64", one, b, alphas, 50)


def config2_batched():
    """Config 2 (Lena 256² huber ADMM, IRLS inner, 10 outer it), 16
    solves per dispatch."""
    blurred = _read("2D_Lena_256_blur_noise.png")
    b = jnp.asarray(blurred / float(blurred.max()))
    alphas = jnp.linspace(0.005, 0.02, 16, dtype=DTYPE)
    cov = np.diag([1.0, 1.0])
    A, A_adj = C.make_blur_operators(cov, alpha_cut=3,
                                     shape=blurred.shape, method="auto",
                                     dtype=DTYPE)
    nA = C.make_normal_blur_operator(cov, alpha_cut=3,
                                     shape=blurred.shape, dtype=DTYPE)
    Bg, Bg_adj = G.make_gradient_operators()
    br = jnp.zeros((2,) + blurred.shape, DTYPE)
    rho = jnp.asarray(0.5, DTYPE)

    def one(alpha, x0):
        x, _ = _admm.admm_solve(
            A, A_adj, Bg, Bg_adj, b, br, x0, alpha, rho,
            iterations=10, iter_max=3, data_loss="huber",
            data_loss_scale=1.0, minimizer="irls", irls_cg_iters=6,
            normal_A=nA, normal_B=G.gradient_normal)
        return x

    return _batched("lena256_huber_admm_irls_10it_batched16", one, b,
                    alphas, 10)


def config3_batched():
    """Config 3 (Shepp 64³ TVL2 ADMM 50×10), 16 solves per dispatch."""
    import scipy.ndimage as ndi

    from nsol_tpu.data import path as data_path
    from nsol_tpu.io import read_nifti
    from nsol_tpu.ops import kernels as K
    from nsol_tpu.ops import matmul_ops as MM

    img = read_nifti(data_path("3D_SheppLoganPhantom_64.nii.gz"))
    x_true = img.data.astype(np.float64)
    shape = x_true.shape
    cov = np.diag([1.0] * 3)
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(3))
    b = jnp.asarray(ndi.convolve(x_true, kern, mode="wrap")
                    .astype(DTYPE))
    alphas = jnp.linspace(0.005, 0.02, 16, dtype=DTYPE)
    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                     method="auto", dtype=DTYPE)
    nA = C.make_normal_blur_operator(cov, alpha_cut=3, shape=shape,
                                     dtype=DTYPE)
    nB = MM.matmul_gradient_normal_fn(shape, dtype=DTYPE)
    Bg, Bg_adj = G.make_gradient_operators()
    br = jnp.zeros((3,) + shape, DTYPE)
    rho = jnp.asarray(0.5, DTYPE)

    def one(alpha, x0):
        x, _ = _admm.admm_solve(
            A, A_adj, Bg, Bg_adj, b, br, x0, alpha, rho,
            iterations=50, iter_max=10, minimizer="cg",
            normal_A=nA, normal_B=nB)
        return x

    return _batched("shepp64_tvl2_admm_50it_batched16", one, b, alphas, 50)


def config4_man1024_alpha_sweep():
    """64-alpha vmapped L-curve sweep over Man 1024 TV-L2 denoising."""
    man = _read("2D_Man_1024.png")
    x_scale = float(man.max())
    b = jnp.asarray(man / x_scale)
    grad_op, grad_adj = G.make_gradient_operators()
    alphas = jnp.linspace(0.01, 1.5, 64, dtype=DTYPE)

    def solve_one(alpha, x0):
        def prox_f(x, tau):
            return prox_ops.prox_ell2_denoising(x, tau, b)

        def record(x):
            g = grad_op(x)
            return {"Reg": jnp.sum(jnp.sqrt(jnp.sum(g * g, axis=0))),
                    "Data": jnp.sum((x - b) ** 2)}

        x, recs = _pd.primal_dual_solve(
            prox_f, prox_ops.prox_tv_conj, grad_op, grad_adj,
            x0, alpha, jnp.asarray(8.0, DTYPE), iterations=50,
            record_fn=record)
        return x, recs

    def sweep(x0):
        return jax.vmap(solve_one, in_axes=(0, None))(alphas, x0)

    f = jit_closed(sweep, (b,))
    jax.block_until_ready(f(b))
    tag = "man1024_tvl2_64alpha_lcurve_vmap"
    per = _chain_time(lambda x: f(x)[0][0], b, n=3, tag=tag)
    return {"config": tag,
            "solves_per_sec": round(64 / per, 2),
            "s_per_sweep": round(per, 3),
            "iters_per_sec": round(64 * 50 / per, 1)}


def config3_sweep_shepp64_alpha_rho():
    """Deconvolution-study sweep on the north-star volume: an 8×8
    alpha×rho grid of Shepp-Logan 64³ TVL2 ADMM solves (20×10) with
    Reg/Data recording, through ADMMLinearSolver.run_sweep (one vmapped
    program; the host readback of all reconstructions is included)."""
    import scipy.ndimage as ndi

    from nsol_tpu.data import path as data_path
    from nsol_tpu.io import read_nifti
    from nsol_tpu.ops import kernels as K, losses as lf, priors
    from nsol_tpu.solvers.wrappers import ADMMLinearSolver

    img = read_nifti(data_path("3D_SheppLoganPhantom_64.nii.gz"))
    cov = np.diag([1.0] * 3)
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(3))
    observed = ndi.convolve(img.data, kern, mode="wrap")
    x_scale = float(observed.max())
    shape = observed.shape
    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                     method="auto", dtype=DTYPE)
    nA = C.make_normal_blur_operator(cov, alpha_cut=3, shape=shape,
                                     dtype=DTYPE)
    Bg, Bg_adj = G.make_gradient_operators()
    obs_j = jnp.asarray(observed, jnp.float32)

    def data_fn(x):
        r = (A(jnp.asarray(x, jnp.float32)) - obs_j).reshape(-1)
        return lf.cost_from_residual(r, "linear", 1.0)

    measures = {"Reg": lambda x: priors.total_variation(x, Bg),
                "Data": data_fn}
    grid = {"alpha": np.repeat(np.linspace(0.005, 0.05, 8), 8),
            "rho": np.tile(np.linspace(0.2, 1.6, 8), 8)}
    solver = ADMMLinearSolver(
        A=A, A_adj=A_adj, b=np.array(observed), B=Bg, B_adj=Bg_adj,
        x0=np.array(observed), iterations=20, iter_max=10,
        minimizer="cg", x_scale=x_scale, normal_A=nA,
        normal_B=G.gradient_normal)
    _, recs = solver.run_sweep(grid, measures=measures)  # compile
    tag = "shepp64_tvl2_admm_8x8_alpha_rho_sweep"
    per = _chain_time(
        lambda _: solver.run_sweep(grid, measures=measures)[0], None, n=3,
        tag=tag)
    return {"config": tag, "workflow_s": round(per, 3),
            "solves_per_sec": round(64 / per, 1),
            "final_data": round(float(recs["Data"][0][-1]), 1)}


def config_tk1_sweep_lena_alpha():
    """TK1L2 deconvolution alpha sweep (64 alphas, Lena 256², CG
    iter_max=10): vmapped tikhonov_solve."""
    from nsol_tpu.solvers.tikhonov import tikhonov_solve

    blurred = _read("2D_Lena_256_blur_noise.png")
    b = jnp.asarray(blurred / float(blurred.max()))
    shape = blurred.shape
    cov = np.diag([1.0, 1.0])
    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                     method="auto", dtype=DTYPE)
    nA = C.make_normal_blur_operator(cov, alpha_cut=3, shape=shape,
                                     dtype=DTYPE)
    Bg, Bg_adj = G.make_gradient_operators()
    alphas = jnp.linspace(0.005, 0.5, 64, dtype=DTYPE)
    br = jnp.zeros((2,) + shape, DTYPE)

    def sweep(a, x):
        return jax.vmap(lambda ai: tikhonov_solve(
            A, A_adj, Bg, Bg_adj, b, br, x, ai,
            minimizer="cg", iter_max=10, normal_A=nA,
            normal_B=G.gradient_normal))(a)

    f = jit_closed(sweep, (alphas, b))
    jax.block_until_ready(f(alphas, b))
    tag = "lena256_tk1l2_64alpha_sweep_cg10"
    per = _chain_time(lambda x: f(alphas, x)[0], b, n=5, tag=tag)
    return {"config": tag, "s_per_sweep": round(per, 4),
            "solves_per_sec": round(64 / per, 1)}


def _scale_problem(n, rng):
    """Synthetic n³ volume (30 % ones), blurred on the device."""
    shape = (n, n, n)
    x_true = (rng.rand(*shape) > 0.7).astype(DTYPE)
    cov = np.diag([1.0] * 3)
    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                     method="auto", dtype=DTYPE)
    xj = jnp.asarray(x_true)
    return shape, cov, A, A_adj, jit_closed(A, (xj,))(xj)


def _scale_linear(n, iterations, n_timed):
    """Synthetic n³ TV-L2 deconvolution, ADMM + normal-equation CG on the
    CLI's operators (matmul blur and Laplacian)."""
    from nsol_tpu.ops import matmul_ops as MM

    shape, cov, A, A_adj, b = _scale_problem(n, np.random.RandomState(0))
    nA = C.make_normal_blur_operator(cov, alpha_cut=3, shape=shape,
                                     dtype=DTYPE)
    nB = MM.matmul_gradient_normal_fn(shape, dtype=DTYPE)
    Bg, Bg_adj = G.make_gradient_operators()
    br = jnp.zeros((3,) + shape, DTYPE)
    al = jnp.asarray(0.01, DTYPE)
    rh = jnp.asarray(0.5, DTYPE)

    def solve(bi, x0):
        x, _ = _admm.admm_solve(A, A_adj, Bg, Bg_adj, bi, br, x0, al, rh,
                                iterations=iterations, iter_max=10,
                                minimizer="cg", normal_A=nA, normal_B=nB)
        return x

    f = jit_closed(solve, (b, b))
    jax.block_until_ready(f(b, b))
    tag = "synthetic_%dcubed_tv_admm_cg_%dit" % (n, iterations)
    per = _chain_time(lambda x: f(b, x), b, n=n_timed, tag=tag)
    return {"config": tag,
            "iters_per_sec": round(iterations / per, 2),
            "s_per_solve": round(per, 3)}


def config_scale_256cubed():
    return _scale_linear(256, 50, 3)


def config_scale_512cubed():
    """512³ (134M voxels, BASELINE config 5's volume) on ONE device."""
    return _scale_linear(512, 10, 2)


def config_scale_256cubed_robust():
    """256³ HUBER (robust) TV-deconvolution with sparse outliers, ADMM +
    IRLS inner (10 outer, 5 sweeps × 8 CG)."""
    from nsol_tpu.ops import losses as _lf
    from nsol_tpu.ops import matmul_ops as MM

    rng = np.random.RandomState(0)
    shape, cov, A, A_adj, b = _scale_problem(256, rng)
    nB = MM.matmul_gradient_normal_fn(shape, dtype=DTYPE)
    Bg, Bg_adj = G.make_gradient_operators()
    b = b + 0.5 * jnp.asarray(
        (rng.rand(*shape) < 0.01).astype(DTYPE)
        * rng.randn(*shape).astype(DTYPE))
    br = jnp.zeros((3,) + shape, DTYPE)
    al = jnp.asarray(0.01, DTYPE)
    rh = jnp.asarray(0.5, DTYPE)
    ITERS, SWEEPS, CGI = 10, 5, 8

    def objective(bi, x):
        r = A(x) - bi
        g = Bg(x)
        return 0.5 * jnp.sum(_lf.huber(r * r)) \
            + al * jnp.sum(jnp.sqrt(jnp.sum(g * g, axis=0)))

    def solve(bi, x0):
        x, _ = _admm.admm_solve(A, A_adj, Bg, Bg_adj, bi, br, x0, al, rh,
                                iterations=ITERS, iter_max=SWEEPS,
                                data_loss="huber", minimizer="irls",
                                irls_cg_iters=CGI, normal_B=nB)
        return x

    f = jit_closed(solve, (b, b))
    x = f(b, b)
    obj = float(np.asarray(jit_closed(objective, (b, b))(b, x)))
    tag = "synthetic_256cubed_huber_admm_irls_10it"
    per = _chain_time(lambda xi: f(b, xi), b, n=2, tag=tag)
    return {"config": tag, "iters_per_sec": round(ITERS / per, 2),
            "s_per_solve": round(per, 3), "objective": round(obj, 1)}


def main():
    global TRACE_DIR
    argv = sys.argv[1:]
    if "--trace" in argv:
        i = argv.index("--trace")
        TRACE_DIR = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    setup_compile_cache()
    all_configs = (config1_lena_pd_denoise,
                   config2_lena_robust_deconv,
                   config2_lena_robust_deconv_irls,
                   config3_sweep_shepp64_alpha_rho,
                   config_tk1_sweep_lena_alpha,
                   config1_batched,
                   config2_batched,
                   config3_batched,
                   config4_man1024_alpha_sweep,
                   config_scale_256cubed,
                   config_scale_256cubed_robust,
                   config_scale_512cubed)
    configs = all_configs
    if argv:
        configs = tuple(f for f in all_configs
                        if any(s in f.__name__ for s in argv))
        if not configs:
            raise SystemExit(
                "No benchmark config matches %r; valid names: %s"
                % (argv, ", ".join(f.__name__ for f in all_configs)))
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    results, failures = [], []
    for fn in configs:
        try:
            out = fn()
            out["device"] = device
            results.append(out)
            print(json.dumps(out), flush=True)
        except Exception as e:  # keep the suite going, fail at the end
            print(json.dumps({"config": fn.__name__, "error": str(e),
                              "device": device}), flush=True)
            failures.append("%s raised: %s" % (fn.__name__, e))

    # Parity GATE: the two config-2 inner engines must agree on the
    # converged objective, so a lowering regression in either FAILS the
    # run instead of printing a drifted number.
    huber_objs = {out["config"]: out["objective"] for out in results
                  if out["config"].startswith("lena256_huber_admm")
                  and "objective" in out}
    if len(huber_objs) > 1:
        vals = sorted(huber_objs.values())
        if vals[-1] - vals[0] > 5e-3 * abs(vals[0]):
            failures.append("huber ADMM inner engines disagree on the "
                            "converged objective past 0.5%%: %s"
                            % huber_objs)
    if failures:
        for msg in failures:
            print("FAILURE: " + msg, file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
