"""North-star benchmark: the headline metric on the accelerator.

Config (BASELINE.json #3, the north-star): 3-D TV-L2 deconvolution of the
bundled Shepp-Logan 64³ phantom via ADMM (50 outer iterations, 10-iteration
normal-equation CG inner solves, alpha=0.01, rho=0.5, Gaussian blur
sigma=1 voxel), on the operators and inner engine the deconvolution CLI
builds (``--minimizer auto`` → ``cg``).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"} where
value = ADMM outer iterations/sec on this device and vs_baseline is the
speedup over the measured reference-equivalent CPU implementation
(scipy ndimage + lsmr, float64; see benchmarks/reference_baseline.py —
the reference publishes no numbers of its own).
"""

import json
import sys
import time
from functools import partial

import numpy as np

#: Measured by benchmarks/reference_baseline.py on a CPU (2026-08-17): 50
#: ADMM iterations in 97.97 s, objective 212334.64.
BASELINE_ITERS_PER_SEC = 0.5104
BASELINE_OBJECTIVE = 212334.64
#: Same CPU reference-equivalent solve on the hash-frozen GENERATED
#: stand-in phantom (nsol_tpu/data.py content hashes; measured
#: 2026-08-21) — arms the parity gate on checkouts without the
#: reference's data.
BASELINE_OBJECTIVE_STANDIN = 219948.08
#: Parity band of the converged objective against the float64 reference:
#: f32 trajectories land within ~0.1 %; a lowering or precision regression
#: (e.g. single-pass bf16 operator matmuls) moves it by several percent.
PARITY_BAND = 0.002

ALPHA, RHO, ITERATIONS, ITER_MAX = 0.01, 0.5, 50, 10
SIGMA = 1.0


def build_problem():
    """The north-star observation: the 64³ phantom blurred host-side
    (scipy, wrap boundary). Returns ``(b, kernel, cov)`` in float64."""
    import scipy.ndimage as ndi

    from nsol_tpu.data import path as data_path
    from nsol_tpu.io import read_nifti
    from nsol_tpu.ops import kernels as K

    x_true = read_nifti(
        data_path("3D_SheppLoganPhantom_64.nii.gz")).data.astype(np.float64)
    cov = np.diag([SIGMA ** 2] * 3)
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(3))
    return ndi.convolve(x_true, kern, mode="wrap"), kern, cov


def make_solve(b, cov, dtype=np.float32):
    """Jitted ``x0 -> x`` north-star solve on the deconvolution CLI's
    operators: ``make_blur_operators(method="auto")``, the normal blur
    operator, the matmul Laplacian, and the inner engine that
    ``--minimizer auto`` resolves to."""
    import jax.numpy as jnp

    from nsol_tpu.jitutil import jit_closed
    from nsol_tpu.ops import conv as C
    from nsol_tpu.ops import grad as G
    from nsol_tpu.ops import matmul_ops as MM
    from nsol_tpu.solvers.admm import admm_solve
    from nsol_tpu.solvers.tikhonov import resolve_minimizer

    shape = b.shape
    minimizer = resolve_minimizer("auto", data_loss="linear", cov=cov)
    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                     method="auto", dtype=dtype)
    nA = C.make_normal_blur_operator(cov, alpha_cut=3, shape=shape,
                                     dtype=dtype)
    nB = MM.matmul_gradient_normal_fn(shape, dtype=dtype)
    Bg, Bg_adj = G.make_gradient_operators()
    bj = jnp.asarray(b, dtype)
    b_reg = jnp.zeros((3,) + shape, dtype)
    alpha = jnp.asarray(ALPHA, dtype)
    rho = jnp.asarray(RHO, dtype)
    solve = jit_closed(
        partial(admm_solve, A, A_adj, Bg, Bg_adj,
                iterations=ITERATIONS, iter_max=ITER_MAX,
                minimizer=minimizer, normal_A=nA, normal_B=nB),
        (bj, b_reg, bj, alpha, rho))
    return lambda xi: solve(bj, b_reg, xi, alpha, rho)[0]


def objective(x, b, kern):
    """``½‖k⊛x − b‖² + α·TV(x)`` in float64, host-side (scipy)."""
    import scipy.ndimage as ndi

    xv = np.asarray(x, dtype=np.float64)
    r = ndi.convolve(xv, kern, mode="wrap") - b
    gx = np.stack([np.diff(np.concatenate(
        [xv, np.zeros_like(xv[..., :1] if ax == 2 else
                           (xv[:, :1] if ax == 1 else xv[:1]))],
        axis=ax), axis=ax) for ax in (2, 1, 0)])
    return float(0.5 * np.sum(r ** 2)
                 + ALPHA * np.sum(np.sqrt(np.sum(gx ** 2, axis=0))))


def parity_anchor():
    """Recorded float64 CPU objective for the input source in use, or
    None for an unrecorded source. Each source has its own: the
    reference's bundled phantom and the hash-frozen generated stand-in
    (content-verified at generation time)."""
    from nsol_tpu import data

    src = data.data_dir()
    if src == data._REFERENCE_DATA:
        return BASELINE_OBJECTIVE
    if src.endswith(".generated_data"):
        return BASELINE_OBJECTIVE_STANDIN
    return None


def main():
    import jax

    from nsol_tpu.jitutil import setup_compile_cache

    setup_compile_cache()
    b_np, kern, cov = build_problem()
    step = make_solve(b_np, cov)
    b = jax.numpy.asarray(b_np, np.float32)
    jax.block_until_ready(step(b))  # compile + first execution

    # --trace DIR: capture a jax.profiler device trace of the timed
    # chain (profiling.py; view in TensorBoard/Perfetto)
    import contextlib

    trace_dir = None
    if "--trace" in sys.argv:
        trace_dir = sys.argv[sys.argv.index("--trace") + 1]
    from nsol_tpu import profiling

    tracer = (profiling.trace(trace_dir) if trace_dir
              else contextlib.nullcontext())

    # chained: each solve starts from the previous one's output
    n_chain = 10
    t0 = time.perf_counter()
    with tracer:
        xi = b
        for _ in range(n_chain):
            xi = step(xi)
        jax.block_until_ready(xi)
    elapsed = (time.perf_counter() - t0) / n_chain
    iters_per_sec = ITERATIONS / elapsed

    obj = objective(step(b), b_np, kern)
    anchor = parity_anchor()
    dev = jax.devices()[0]
    print("objective=%.2f (reference-equivalent CPU: %s), elapsed=%.3fs,"
          " device=%s %s x%d" % (obj, anchor, elapsed, dev.platform,
                                 dev.device_kind, len(jax.devices())),
          file=sys.stderr)

    print(json.dumps({
        "metric": "admm_tv_deconv_3d_64_iters_per_sec",
        "value": round(iters_per_sec, 3),
        "unit": "iterations/sec",
        "vs_baseline": round(iters_per_sec / BASELINE_ITERS_PER_SEC, 2),
    }))

    # Parity GATE (not just a printed number): a lowering or precision
    # regression that drifts the converged objective FAILS the run.
    if anchor is not None:
        rel = abs(obj - anchor) / anchor
        if rel > PARITY_BAND:
            print("PARITY FAILURE: objective %.2f deviates %.3f%% from the"
                  " reference-equivalent %.2f (band %.1f%%)"
                  % (obj, 100 * rel, anchor, 100 * PARITY_BAND),
                  file=sys.stderr)
            sys.exit(1)


if __name__ == "__main__":
    main()
