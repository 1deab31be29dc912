"""Measure the reference-equivalent CPU baseline.

The reference package cannot run here (pysitk missing), so this script
reproduces its exact computational path with the reference's own backends —
scipy.ndimage.convolve operators, scipy.sparse.linalg.lsmr(atol=btol=0)
inner solves, float64 flattened arrays — for the north-star benchmark
config (BASELINE.json #3): 3-D TV-L2 deconvolution of the bundled Shepp-Logan
64³ phantom via ADMM (iterations=50, iter_max=10, alpha=0.01, rho=0.5,
Gaussian blur sigma=1.0 voxel). Algorithm parameters mirror
nsol/admm_linear_solver.py:202-253 and nsol/tikhonov_linear_solver.py:146-158.

Writes measured iterations/sec to stdout; the number is recorded in
bench.py as the vs_baseline denominator and the parity anchor.
"""

import json
import os
import time

import numpy as np
import scipy.ndimage as ndi
import scipy.sparse.linalg

import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from nsol_tpu.data import path as data_path          # noqa: E402
from nsol_tpu.io import read_nifti                       # noqa: E402
from nsol_tpu.ops import kernels as K                    # noqa: E402

ALPHA, RHO, ITERATIONS, ITER_MAX = 0.01, 0.5, 50, 10
SIGMA = 1.0


def main():
    img = read_nifti(data_path("3D_SheppLoganPhantom_64.nii.gz"))
    x_true = img.data.astype(np.float64)
    shape = x_true.shape
    n = x_true.size
    d = 3

    cov = np.diag([SIGMA ** 2] * 3)
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(3))

    def A(v):
        return ndi.convolve(v.reshape(shape), kern,
                            mode="wrap").reshape(-1)

    grad_kerns = [K.forward_difference_kernel(3 - 1 - i, 3) for i in range(3)]
    back_kerns = [K.backward_difference_kernel(3 - 1 - i, 3)
                  for i in range(3)]

    def B(v):
        x = v.reshape(shape)
        return np.concatenate([
            ndi.convolve(x, kf, mode="constant").reshape(-1)
            for kf in grad_kerns])

    def B_adj(g):
        out = np.zeros(shape)
        for i in range(3):
            out += ndi.convolve(g[i * n:(i + 1) * n].reshape(shape),
                                -back_kerns[i], mode="constant")
        return out.reshape(-1)

    rng = np.random.RandomState(1)
    b = A(x_true.reshape(-1)) + 0.0  # noiseless blur, matching bench.py
    x = b.copy()
    v = B(x)
    w = np.zeros_like(v)
    sqrt_rho = np.sqrt(RHO)

    def aug_mv(u):
        return np.concatenate([A(u), sqrt_rho * B(u)])

    def aug_rmv(u):
        return A(u[:n]) + sqrt_rho * B_adj(u[n:])

    Aop = scipy.sparse.linalg.LinearOperator((n + d * n, n), matvec=aug_mv,
                                             rmatvec=aug_rmv)

    t0 = time.perf_counter()
    for it in range(ITERATIONS):
        b_reg = v - w
        rhs = np.concatenate([b, sqrt_rho * b_reg])
        # NOTE: the reference does NOT warm-start lsmr (no x0 argument at
        # nsol/tikhonov_linear_solver.py:149-154) — reproduced faithfully.
        x = scipy.sparse.linalg.lsmr(Aop, rhs, maxiter=ITER_MAX,
                                     atol=0, btol=0)[0]
        x = np.clip(x, 0, np.inf)
        t = B(x) + w
        t_split = t.reshape(d, n)
        t_norm = np.sqrt(np.sum(t_split ** 2, axis=0))
        shrink = np.where(t_norm > ALPHA / RHO,
                          (t_norm - ALPHA / RHO)
                          / np.where(t_norm > 0, t_norm, 1), 0.0)
        v = (t_split * shrink).reshape(-1)
        w = t - v
        if it == 4:
            # report a mid-run estimate too (long full run)
            t5 = time.perf_counter() - t0
            print("  5 iters: %.2fs (%.3f iterations/s)" % (t5, 5 / t5))
    elapsed = time.perf_counter() - t0

    r = A(x) - b
    g = B(x).reshape(d, n)
    objective = 0.5 * np.sum(r ** 2) + ALPHA * np.sum(
        np.sqrt(np.sum(g ** 2, axis=0)))
    result = {
        "config": "shepp_logan_64_tv_admm",
        "iterations": ITERATIONS,
        "elapsed_s": elapsed,
        "iters_per_sec": ITERATIONS / elapsed,
        "objective": objective,
        "backend": "scipy-cpu-reference-equivalent",
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
