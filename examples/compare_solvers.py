"""Side-by-side comparison: Tikhonov vs ADMM vs primal-dual.

Counterpart of the reference's examples/compare_solver.py (308 LoC): solves
the same denoising/deconvolution problem on a bundled image with all three
solver families and reports converged objectives, runtimes, and similarity
to the clean reference image.

Run (CPU):  JAX_PLATFORMS=cpu python examples/compare_solvers.py
Run (GPU):  python examples/compare_solvers.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp  # noqa: E402

from nsol_tpu.io import DataReader  # noqa: E402
from nsol_tpu.ops import conv as C  # noqa: E402
from nsol_tpu.ops import grad as G  # noqa: E402
from nsol_tpu.ops import prox as prox_ops  # noqa: E402
from nsol_tpu.ops import measures as sim  # noqa: E402
from nsol_tpu.interface import DeconvolutionSolverStudyInterface  # noqa
from nsol_tpu.solvers.wrappers import PrimalDualSolver  # noqa: E402

from nsol_tpu.data import data_dir

DATA = data_dir()

# Suggested regularization weights (reference: examples/compare_solver.py:52-57)
ALPHA_DENOISE = 0.6
ALPHA_DEBLUR = 0.01


def read(name):
    r = DataReader(os.path.join(DATA, name))
    r.read_data()
    return r.get_data()


def report(name, solver, x_clean):
    t0 = time.perf_counter()
    solver.run()
    elapsed = time.perf_counter() - t0
    x = solver.get_x()
    psnr = float(sim.peak_signal_to_noise_ratio(jnp.asarray(x),
                                                jnp.asarray(x_clean)))
    line = "%-28s %8.3fs   PSNR=%6.2f dB" % (name, elapsed, psnr)
    try:
        line += "   total cost=%.4e" % solver.get_total_cost()
    except (NotImplementedError, AttributeError):
        pass
    print(line)
    return x


def main():
    clean = read("2D_Lena_256.png")
    noisy = read("2D_Lena_256_noise.png")
    blurred = read("2D_Lena_256_blur_noise.png")
    shape = clean.shape
    x_scale = noisy.max()

    print("== TV-L2 denoising of 2D_Lena_256_noise.png (alpha=%g) =="
          % ALPHA_DENOISE)
    grad_op, grad_adj = G.make_gradient_operators()
    bj = jnp.asarray(noisy / x_scale)
    for alg in ("ALG2", "ALG2_AHMOD", "ALG3"):
        solver = PrimalDualSolver(
            prox_f=lambda x, tau: prox_ops.prox_ell2_denoising(x, tau, bj),
            prox_g_conj=prox_ops.prox_tv_conj,
            B=grad_op, B_conj=grad_adj, L2=8, x0=np.array(noisy),
            alpha=ALPHA_DENOISE, iterations=50, x_scale=x_scale,
            alg_type=alg)
        report("PD %s denoise" % alg, solver, clean)

    print("\n== Deconvolution of 2D_Lena_256_blur_noise.png "
          "(sigma=1, alpha=%g) ==" % ALPHA_DEBLUR)
    cov = np.diag([1.0, 1.0])
    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                     method="auto")
    for rtype, tv_solver in [("TK0L2", "PD"), ("TK1L2", "PD"),
                             ("TVL2", "PD"), ("TVL2", "ADMM"),
                             ("HuberL2", "PD")]:
        iface = DeconvolutionSolverStudyInterface(
            A=A, A_adj=A_adj, D=grad_op, D_adj=grad_adj, b=blurred,
            x0=np.array(blurred), alpha=ALPHA_DEBLUR,
            x_scale=blurred.max(), iter_max=10, iterations=50,
            minimizer="lsmr", measures=[], reconstruction_type=rtype,
            dimension=2, tv_solver=tv_solver)
        iface.set_up_solver()
        report("%s (%s) deconv" % (rtype, tv_solver), iface.get_solver(),
               clean)


if __name__ == "__main__":
    main()
