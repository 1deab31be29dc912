"""Smoke run of the main paths on one GPU, against float64 CPU references.

Usage::

    python chip_smoke.py               # every one-card phase
    python chip_smoke.py --four-cards  # only config 5, sharded over 4 cards

Phases (one line each on stdout, then the contract line):

* ``device``: the JAX device must be a GPU; prints the card's name and
  power limit (``nvidia-smi``), the JAX versions, ``XLA_FLAGS`` and the
  compile-cache directory.
* ``north_star``: bench.py's configuration (64³ phantom, TVL2 ADMM 50×10)
  on the operators and inner engine the deconvolution CLI builds; the
  converged objective must sit within bench.py's 0.2 % parity band of the
  recorded float64 reference.
* ``deconvolution_linear`` / ``deconvolution_huber``: the
  ``nsol_run_deconvolution`` CLI (called in-process) on a noisy, blurred
  256³ Shepp-Logan volume written as ``.nii.gz``: TVL2 ADMM with the
  linear loss (→ ``cg``, 10 outer x 10 CG) and the huber loss
  (→ ``irls``, 5 outer x 2 IRLS sweeps x 8 CG).
* ``denoising``: the ``nsol_run_denoising`` CLI, TVL2 PD 50 iterations on
  a noisy 256³ volume.
* ``study_pd`` / ``study_admm`` / ``study_tk1``: the wrappers' vmapped
  ``run_sweep`` at BASELINE shapes (PD 64-α over 1024², ADMM 8×8 α×ρ at
  64³, TK1L2 64-α at 256²) with Reg/Data recorded; two grid points are
  re-solved serially and must match the sweep.
* ``blur_methods``: the matmul, separable and FFT ``AᵀA`` applies at 64³,
  256³ and 512³ (times and their agreement).
* ``four_cards`` (only with ``--four-cards``): ``sharded_tv_admm_solve``
  over a 4-card ``("space",)`` mesh at 512³, against the one-card solve.

The deconvolution, denoising and study results are compared with the same
solves run in float64 with separable operators by two child processes that
are held to the CPU (``JAX_PLATFORMS=cpu``), so this process is the only
one on the card. Any failure exits non-zero before the contract line.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

#: rel. objective / rel. voxel-RMS bands of a float32 card solve against
#: the float64 CPU reference of the same algorithm
OBJ_TOL = 1e-4
RMS_TOL = 1e-3
#: sweep point vs the same point re-solved serially on the card
SWEEP_TOL = 1e-5
#: the whole script must end within this many seconds
BUDGET_S = 1100

#: the huber run is cut to 5 outer x 2 IRLS sweeps so that its float64 CPU
#: reference (about 4x the linear one per outer iteration) ends in time
DECONV = dict(n=256, iterations=10, iter_max=10, alpha=0.01, rho=0.5,
              huber_iterations=5, huber_iter_max=2, irls_cg_iters=8,
              noise=0.05)
DENOISE = dict(n=256, iterations=50, alpha=0.03, noise=0.08)
STUDY_PD = dict(n=1024, n_alpha=64, iterations=50, noise=0.08,
                points=(5, 50))
STUDY_ADMM = dict(n=64, grid=8, iterations=20, iter_max=10, points=(9, 54))
STUDY_TK1 = dict(n=256, n_alpha=64, iter_max=10, noise=0.05,
                 points=(3, 30))
BLUR_SIZES = (64, 256, 512)
FOUR_CARDS = dict(n=512, iterations=10, iter_max=10, alpha=0.01, rho=0.5)


class SmokeFailure(Exception):
    """A phase produced a wrong or missing result."""


# ---------------------------------------------------------------------------
# float64 host-side measures (numpy/scipy, independent of the solvers)
# ---------------------------------------------------------------------------

def _factors(ndim, sigma=1.0):
    """Per-axis 1-D factors of the separable Gaussian blur stencil."""
    from nsol_tpu.ops.conv import separable_factors
    from nsol_tpu.ops.kernels import gaussian_kernel

    cov = np.diag([sigma ** 2] * ndim)
    return separable_factors(gaussian_kernel(cov, alpha_cut=3,
                                             dtype=np.float64))


def blur_np(x, factors):
    """Wrap-boundary separable blur in float64 (scipy)."""
    import scipy.ndimage as ndi

    y = np.asarray(x, dtype=np.float64)
    for ax, f in enumerate(factors):
        y = ndi.convolve1d(y, f, axis=ax, mode="wrap")
    return y


def tv_np(x):
    """Isotropic TV with zero-padded forward differences."""
    x = np.asarray(x, dtype=np.float64)
    g2 = sum(np.diff(x, axis=ax, append=0) ** 2 for ax in range(x.ndim))
    return float(np.sum(np.sqrt(g2)))


def huber_np(f2, gamma=1.345):
    return np.where(f2 < gamma * gamma, f2,
                    2.0 * gamma * np.sqrt(f2) - gamma * gamma)


def deconv_objective(x, b, scale, alpha, data_loss="linear", reg="TV"):
    """``½Σρ(r²) + α·R(x)`` in the solver's scaled variables."""
    xs = np.asarray(x, np.float64) / scale
    r2 = (blur_np(xs, _factors(xs.ndim))
          - np.asarray(b, np.float64) / scale) ** 2
    data = 0.5 * float(np.sum(huber_np(r2) if data_loss == "huber"
                              else r2))
    if reg == "TK1":
        g2 = sum(np.diff(xs, axis=ax, append=0) ** 2
                 for ax in range(xs.ndim))
        return data + alpha * 0.5 * float(np.sum(g2))
    return data + alpha * tv_np(xs)


def denoise_objective(x, b, scale, alpha):
    """``½‖x − b‖² + α·TV(x)`` in scaled variables."""
    xs = np.asarray(x, np.float64) / scale
    return 0.5 * float(np.sum((xs - np.asarray(b, np.float64) / scale)
                              ** 2)) + alpha * tv_np(xs)


def rel_rms(x, ref):
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((x - ref) ** 2))
                 / max(np.sqrt(np.mean(ref ** 2)), 1e-30))


def rel_diff(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def parity(x, ref, obj):
    """Relative objective and voxel-RMS gaps of ``x`` against ``ref``;
    raises SmokeFailure outside OBJ_TOL / RMS_TOL."""
    out = {"rel_objective": rel_diff(obj(x), obj(ref)),
           "rel_rms": rel_rms(x, ref)}
    if not np.all(np.isfinite(x)):
        raise SmokeFailure("non-finite values in the card's result")
    if out["rel_objective"] > OBJ_TOL or out["rel_rms"] > RMS_TOL:
        raise SmokeFailure("card vs float64 CPU: %s (bands %g / %g)"
                           % (out, OBJ_TOL, RMS_TOL))
    return out


# ---------------------------------------------------------------------------
# float64 CPU reference solves (run in the child process)
# ---------------------------------------------------------------------------

def _load(path):
    if path.endswith(".npy"):
        return np.load(path)
    from nsol_tpu.io import DataReader

    reader = DataReader(path)
    reader.read_data()
    return reader.get_data()


def reference_solve(job):
    """Solve ``job`` (a dict, see the ``*_job`` builders) in the dtype of
    the running JAX (float64 in the child) with separable operators.
    Returns the solution in unscaled units."""
    import jax
    import jax.numpy as jnp

    from nsol_tpu.ops import conv as C, grad as G, prox as P
    from nsol_tpu.solvers.admm import admm_solve
    from nsol_tpu.solvers.primal_dual import primal_dual_solve
    from nsol_tpu.solvers.tikhonov import tikhonov_solve

    b = np.asarray(_load(job["input"]), np.float64)
    scale = float(np.max(b))
    bs = jnp.asarray(b / scale)
    Bg, Bg_adj = G.make_gradient_operators()
    cov = np.eye(b.ndim)
    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, method="separable",
                                     dtype=bs.dtype)
    nA = C.make_normal_blur_operator(cov, alpha_cut=3, dtype=bs.dtype)
    kind = job["kind"]

    def pd(bs):
        return primal_dual_solve(
            lambda x, tau: P.prox_ell2_denoising(x, tau, bs),
            P.prox_tv_conj, Bg, Bg_adj, bs, job["alpha"], 8.0,
            iterations=job["iterations"])[0]

    def admm(bs):
        cg = job["minimizer"] == "cg"
        return admm_solve(
            A, A_adj, Bg, Bg_adj, bs, 0.0, bs, job["alpha"], job["rho"],
            iterations=job["iterations"], iter_max=job["iter_max"],
            data_loss=job.get("data_loss", "linear"),
            minimizer=job["minimizer"], normal_A=nA if cg else None,
            normal_B=G.gradient_normal,
            irls_cg_iters=job.get("irls_cg_iters", 8))[0]

    def tikhonov(bs):
        return tikhonov_solve(A, A_adj, Bg, Bg_adj, bs, 0.0, bs,
                              job["alpha"], minimizer="cg",
                              iter_max=job["iter_max"], normal_A=nA,
                              normal_B=G.gradient_normal)

    solves = {"pd": pd, "admm": admm, "tikhonov": tikhonov}
    if kind not in solves:
        raise ValueError("unknown reference job kind %r" % kind)
    return np.asarray(jax.jit(solves[kind])(bs)) * scale


def run_reference_jobs(job_file):
    """Child entry: solve every job of ``job_file`` in float64 on the CPU
    and save ``<out>`` for each."""
    import jax

    jax.config.update("jax_enable_x64", True)
    if jax.devices()[0].platform != "cpu":
        raise SystemExit("the reference child must run with "
                         "JAX_PLATFORMS=cpu")
    with open(job_file) as f:
        jobs = json.load(f)
    for job in jobs:
        t0 = time.perf_counter()
        np.save(job["out"], reference_solve(job))
        print("reference %s: %.1f s" % (job["name"],
                                        time.perf_counter() - t0),
              file=sys.stderr, flush=True)


class ReferenceChild(object):
    """One CPU process that solves the queued reference jobs."""

    def __init__(self, workdir, name):
        self._dir = workdir
        self._name = name
        self._jobs = []
        self._proc = None

    def add(self, name, **job):
        job.update(name=name, out=os.path.join(self._dir, name + ".ref.npy"))
        self._jobs.append(job)
        return job["out"]

    def start(self):
        path = os.path.join(self._dir, "jobs_%s.json" % self._name)
        with open(path, "w") as f:
            json.dump(self._jobs, f)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        self._proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-reference",
             path], env=env, stdout=sys.stderr, stderr=sys.stderr)

    def wait(self, timeout):
        rc = self._proc.wait(timeout=timeout)
        if rc != 0:
            raise SmokeFailure("CPU reference child exited %d" % rc)

    def stop(self):
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

class CompileClock(object):
    """Seconds JAX spends tracing, lowering and compiling (from its own
    monitoring events), so a call's run time is wall minus this."""

    def __init__(self):
        import jax

        self.total = 0.0

        def listener(event, duration, **_):
            if event.startswith("/jax/core/compile/"):
                self.total += duration

        jax.monitoring.register_event_duration_secs_listener(listener)

    def call(self, fn):
        """``(result, wall_s, compile_s)`` of ``fn()`` (device-synced)."""
        import jax

        c0, t0 = self.total, time.perf_counter()
        out = jax.block_until_ready(fn())
        return out, time.perf_counter() - t0, self.total - c0


def timed_twice(clock, fn):
    """Call ``fn`` twice: the first call's compile seconds, the second
    call's seconds without compile (its steady run), both walls."""
    _, wall1, comp1 = clock.call(fn)
    out, wall2, comp2 = clock.call(fn)
    return out, {"compile_s": comp1, "first_call_s": wall1,
                 "steady_s": max(wall2 - comp2, 0.0),
                 "second_call_s": wall2}


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def make_volume_inputs(workdir, n, seed):
    """Noisy blurred and noisy 3-D Shepp-Logan volumes as ``.nii.gz``.
    Returns ``(deconvolution_path, denoising_path)``."""
    from nsol_tpu.data import shepp_logan_3d
    from nsol_tpu.io.nifti import write_nifti
    from nsol_tpu.noise import Noise

    clean = shepp_logan_3d(n)
    paths = []
    for name, blurred, level in (
            ("deconv", blur_np(clean, _factors(3)), DECONV["noise"]),
            ("denoise", clean, DENOISE["noise"])):
        noise = Noise(blurred, seed=seed)
        noise.add_gaussian_noise(noise_level=level)
        path = os.path.join(workdir, "%s_%d.nii.gz" % (name, n))
        write_nifti(noise.get_noisy_data().astype(np.float32), path,
                    spacing=np.ones(3))
        paths.append(path)
    return tuple(paths)


def _read_result(path):
    from nsol_tpu.io.nifti import read_nifti

    return np.asarray(read_nifti(path).data, np.float64)


def _run_cli(main, argv):
    """Run a CLI ``main(argv)`` in this process, its chatter on stderr."""
    with contextlib.redirect_stdout(sys.stderr):
        rc = main(argv)
    if rc not in (0, None):
        raise SmokeFailure("CLI exited %r" % rc)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_north_star(clock):
    import bench

    b, kern, cov = bench.build_problem()
    step = bench.make_solve(b, cov)
    x, t = timed_twice(clock, lambda: step(np.asarray(b, np.float32)))
    obj = bench.objective(x, b, kern)
    anchor = bench.parity_anchor()
    rec = dict(phase="north_star", shape=list(b.shape),
               iterations="%d outer x %d CG" % (bench.ITERATIONS,
                                               bench.ITER_MAX), **t,
               outer_it_per_s=bench.ITERATIONS / t["steady_s"],
               peak_bytes=peak_bytes(), objective=obj, anchor=anchor)
    if anchor is None:
        raise SmokeFailure("no recorded float64 objective for this input")
    rec["rel_objective"] = rel_diff(obj, anchor)
    if rec["rel_objective"] > bench.PARITY_BAND:
        raise SmokeFailure("north-star objective %.2f is %.3f %% off the "
                           "float64 reference %.2f" % (
                               obj, 100 * rec["rel_objective"], anchor))
    return rec


def deconvolution_jobs(workdir, path, cfg, children):
    """Both deconvolution CLI runs on ``path`` (linear → cg, huber →
    irls), each with its reference job queued on its own entry of
    ``children`` (a pair)."""
    runs = []
    for loss, iterations, iter_max, child in (
            ("linear", cfg["iterations"], cfg["iter_max"], children[0]),
            ("huber", cfg["huber_iterations"], cfg["huber_iter_max"],
             children[1])):
        out = os.path.join(workdir, "deconv_%s.nii" % loss)
        argv = ["--observation", path, "--result", out,
                "--reconstruction-type", "TVL2", "--solver", "ADMM",
                "--data-loss", loss, "--blur", "1",
                "--iterations", str(iterations),
                "--iter-max", str(iter_max),
                "--irls-cg-iters", str(cfg["irls_cg_iters"]),
                "--alpha", str(cfg["alpha"]), "--rho", str(cfg["rho"])]
        minimizer = "cg" if loss == "linear" else "irls"
        ref = child.add(
            "deconvolution_" + loss, kind="admm", input=path,
            alpha=cfg["alpha"], rho=cfg["rho"],
            iterations=iterations, iter_max=iter_max,
            data_loss=loss, irls_cg_iters=cfg["irls_cg_iters"],
            minimizer=minimizer)
        inner = ("%d CG" % iter_max if loss == "linear" else
                 "%d IRLS sweeps x %d CG" % (iter_max,
                                             cfg["irls_cg_iters"]))
        runs.append(dict(loss=loss, argv=argv, out=out, ref=ref,
                         outer=iterations,
                         iterations="%d outer x %s" % (iterations, inner)))
    return runs


def deconvolution_run(clock, run, cfg):
    from nsol_tpu.cli import run_deconvolution

    _, t = timed_twice(clock, lambda: _run_cli(run_deconvolution.main,
                                               run["argv"]))
    return dict(phase="deconvolution_" + run["loss"],
                shape=[cfg["n"]] * 3, iterations=run["iterations"], **t,
                outer_it_per_s=run["outer"] / t["steady_s"],
                peak_bytes=peak_bytes())


def denoising_job(workdir, path, cfg, child):
    out = os.path.join(workdir, "denoise.nii")
    argv = ["--observation", path, "--result", out,
            "--reconstruction-type", "TVL2", "--solver", "PD",
            "--iterations", str(cfg["iterations"]),
            "--alpha", str(cfg["alpha"])]
    ref = child.add("denoising", kind="pd", input=path, alpha=cfg["alpha"],
                    iterations=cfg["iterations"])
    return dict(argv=argv, out=out, ref=ref)


def denoising_run(clock, run, cfg):
    from nsol_tpu.cli import run_denoising

    _, t = timed_twice(clock, lambda: _run_cli(run_denoising.main,
                                               run["argv"]))
    return dict(phase="denoising", shape=[cfg["n"]] * 3,
                iterations="%d PD" % cfg["iterations"], **t,
                outer_it_per_s=cfg["iterations"] / t["steady_s"],
                peak_bytes=peak_bytes())


def study_problem(kind, cfg, seed):
    """Host-side observation and parameter grid of one study."""
    from nsol_tpu import data

    if kind == "pd":
        obs = data._corrupt(data._synthetic_photo(cfg["n"], seed),
                            noise_level=cfg["noise"], seed=seed)
        grid = {"alpha": np.linspace(0.01, 1.5, cfg["n_alpha"])}
    elif kind == "admm":
        obs = blur_np(data.shepp_logan_3d(cfg["n"]), _factors(3))
        k = cfg["grid"]
        grid = {"alpha": np.repeat(np.linspace(0.005, 0.05, k), k),
                "rho": np.tile(np.linspace(0.2, 1.6, k), k)}
    else:
        obs = data._corrupt(data._synthetic_photo(cfg["n"], seed),
                            blur_sigma=1.0, noise_level=cfg["noise"],
                            seed=seed)
        grid = {"alpha": np.linspace(0.005, 0.5, cfg["n_alpha"])}
    return obs, grid


def study_job(workdir, kind, cfg, obs, grid, child):
    """Queue the float64 reference of the study's first serial point;
    returns ``(ref_path, objective_fn)``."""
    i = cfg["points"][0]
    point = {key: float(vals[i]) for key, vals in grid.items()}
    inp = os.path.join(workdir, "study_%s.npy" % kind)
    np.save(inp, obs)
    scale = float(obs.max())
    if kind == "pd":
        ref = child.add("study_pd", kind="pd", input=inp,
                        iterations=cfg["iterations"], **point)
        return ref, lambda x: denoise_objective(x, obs, scale,
                                                point["alpha"])
    if kind == "admm":
        ref = child.add("study_admm", kind="admm", input=inp,
                        iterations=cfg["iterations"],
                        iter_max=cfg["iter_max"], minimizer="cg", **point)
    else:
        ref = child.add("study_tk1", kind="tikhonov", input=inp,
                        iter_max=cfg["iter_max"], **point)
    return ref, lambda x: deconv_objective(
        x, obs, scale, point["alpha"], reg="TK1" if kind == "tk1" else "TV")


def study_solver(kind, cfg, obs):
    """The wrapper solver and Reg/Data measures a study CLI would build."""
    import jax.numpy as jnp

    from nsol_tpu.ops import conv as C, grad as G, losses as lf
    from nsol_tpu.ops import measures as sim, priors, prox as P
    from nsol_tpu.solvers.wrappers import (
        ADMMLinearSolver, PrimalDualSolver, TikhonovLinearSolver)

    Bg, Bg_adj = G.make_gradient_operators()
    scale = float(obs.max())
    if kind == "pd":
        bj = jnp.asarray(obs / scale)
        b_full = jnp.asarray(obs)
        solver = PrimalDualSolver(
            prox_f=lambda x, tau: P.prox_ell2_denoising(x, tau, bj),
            prox_g_conj=P.prox_tv_conj, B=Bg, B_conj=Bg_adj, L2=8,
            x0=np.array(obs), iterations=cfg["iterations"], x_scale=scale)
        return solver, {
            "Reg": lambda x: priors.total_variation(x, Bg),
            "Data": lambda x: sim.sum_of_squared_differences(x, b_full)}

    cov = np.eye(obs.ndim)
    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, shape=obs.shape,
                                     method="auto", dtype=np.float32)
    b_j = jnp.asarray(obs, jnp.float32)

    def data_cost(x):
        return lf.cost_from_residual(A(x) - b_j, "linear", 1.0)

    if kind == "admm":
        solver = ADMMLinearSolver(
            A=A, A_adj=A_adj, b=np.array(obs), B=Bg, B_adj=Bg_adj,
            x0=np.array(obs), iterations=cfg["iterations"],
            iter_max=cfg["iter_max"], minimizer="auto", x_scale=scale,
            blur_cov=cov)
        return solver, {"Reg": lambda x: priors.total_variation(x, Bg),
                        "Data": data_cost}
    solver = TikhonovLinearSolver(
        A=A, A_adj=A_adj, b=np.array(obs), B=Bg, B_adj=Bg_adj,
        x0=np.array(obs), iter_max=cfg["iter_max"], minimizer="auto",
        x_scale=scale, blur_cov=cov, reg_kind="TK1")
    return solver, {"Reg": lambda x: priors.first_order_tikhonov(x, Bg),
                    "Data": data_cost}


def study_run(clock, kind, cfg, obs, grid):
    """One study: the vmapped sweep (twice, for compile and steady
    times) and two serial re-solves that must match it. Returns the
    record and the first serial point's solution."""
    import jax.numpy as jnp

    solver, measures = study_solver(kind, cfg, obs)
    (x_all, recs), t = timed_twice(
        clock, lambda: solver.run_sweep(grid, measures=measures))
    n = len(next(iter(grid.values())))
    if x_all.shape != (n,) + obs.shape:
        raise SmokeFailure("sweep returned shape %s" % (x_all.shape,))
    for name in ("Reg", "Data"):
        if recs[name].shape[0] != n or not np.all(np.isfinite(recs[name])):
            raise SmokeFailure("bad %s records" % name)

    dev_x, dev_rec, x_point = [], [], None
    for i in cfg["points"]:
        for key, vals in grid.items():
            getattr(solver, "set_" + key)(vals[i])
        solver.run()
        x_serial = solver.get_x()
        dev_x.append(rel_rms(x_all[i], x_serial))
        for name, fn in measures.items():
            want = float(fn(jnp.asarray(x_serial, jnp.float32)))
            dev_rec.append(rel_diff(recs[name][i][-1], want))
        if x_point is None:
            x_point = x_serial
    rec = dict(phase="study_" + kind, shape=list(obs.shape), grid=n, **t,
               solves_per_s=n / t["steady_s"],
               sweep_vs_serial_rel=max(dev_x),
               records_vs_serial_rel=max(dev_rec), peak_bytes=peak_bytes())
    if rec["sweep_vs_serial_rel"] > SWEEP_TOL:
        raise SmokeFailure("%s sweep vs serial %g > %g" % (
            kind, rec["sweep_vs_serial_rel"], SWEEP_TOL))
    if rec["records_vs_serial_rel"] > 10 * SWEEP_TOL:
        raise SmokeFailure("%s records vs serial %g > %g" % (
            kind, rec["records_vs_serial_rel"], 10 * SWEEP_TOL))
    return rec, x_point


def phase_blur_methods(clock, sizes):
    """``AᵀA`` apply time of the matmul, separable and FFT forms."""
    import jax
    import jax.numpy as jnp

    from nsol_tpu.jitutil import jit_closed
    from nsol_tpu.ops import conv as C
    from nsol_tpu.ops import matmul_ops as MM

    cov = np.eye(3)
    auto = [np.convolve(f, f[::-1]) for f in _factors(3)]
    rec = {"phase": "blur_methods", "unit": "ms per AtA apply"}
    for n in sizes:
        shape = (n, n, n)
        k3 = auto[0][:, None, None] * auto[1][None, :, None] \
            * auto[2][None, None, :]
        ops = {
            "matmul": MM.make_matmul_normal_blur_operator(
                cov, alpha_cut=3, shape=shape, dtype=np.float32),
            "separable": C.separable_convolve_fn(
                [a.astype(np.float32) for a in auto]),
            "fft": C.fft_convolve_fn(k3, shape, dtype=np.float32),
        }
        x = jax.random.uniform(jax.random.PRNGKey(n), shape, jnp.float32)
        outs = {}
        for name, op in ops.items():
            f = jit_closed(op, (x,))
            outs[name], _, _ = clock.call(lambda: f(x))
            reps = 5
            _, wall, comp = clock.call(lambda: _repeat(f, x, reps))
            rec["%s_%d" % (name, n)] = 1e3 * (wall - comp) / reps
        ref = np.asarray(outs["separable"], np.float64)
        rec["max_rel_dev_%d" % n] = max(
            rel_rms(outs[k], ref) for k in ("matmul", "fft"))
        if rec["max_rel_dev_%d" % n] > 1e-5:
            raise SmokeFailure("AtA forms disagree at %d³: %g" % (
                n, rec["max_rel_dev_%d" % n]))
        del outs, x
    rec["peak_bytes"] = peak_bytes()
    return rec


def _repeat(f, x, reps):
    for _ in range(reps):
        x = f(x)
    return x


def phase_four_cards(clock, cfg, seed):
    """Config 5: the sharded solve over 4 cards vs the one-card solve."""
    import jax

    from nsol_tpu.parallel import make_mesh, sharded_tv_admm_solve

    devices = jax.devices()[:4]
    if len(devices) != 4:
        raise SmokeFailure("--four-cards needs 4 devices, JAX sees %d"
                           % len(devices))
    n = cfg["n"]
    rng = np.random.RandomState(seed)
    x_true = (rng.rand(n, n, n) > 0.7).astype(np.float32)
    b = blur_np(x_true, _factors(3)).astype(np.float32)
    del x_true
    cov = np.eye(3)
    mesh = make_mesh((4,), ("space",), devices=devices)

    def sharded():
        return sharded_tv_admm_solve(
            mesh, cov, b, b, cfg["alpha"], cfg["rho"],
            iterations=cfg["iterations"], iter_max=cfg["iter_max"],
            minimizer="auto")

    x4, t = timed_twice(clock, sharded)
    span = sorted(d.id for d in x4.sharding.device_set)
    shard_rows = sorted(s.data.shape[0] for s in x4.addressable_shards)
    if len(span) != 4 or shard_rows != [n // 4] * 4:
        raise SmokeFailure("result spans devices %s with rows %s"
                           % (span, shard_rows))
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in devices]

    step = _one_card_solve(b, cfg)
    x1, t1 = timed_twice(clock, lambda: step(jax.device_put(b, devices[0])))
    x4h, x1h = np.asarray(x4), np.asarray(x1)
    obj = lambda x: deconv_objective(x, b, 1.0, cfg["alpha"])
    par = {"rel_objective": rel_diff(obj(x4h), obj(x1h)),
           "rel_rms": rel_rms(x4h, x1h)}
    rec = dict(phase="four_cards", shape=[n] * 3, mesh={"space": 4},
               iterations="%d outer x %d CG" % (cfg["iterations"],
                                                cfg["iter_max"]),
               **t, outer_it_per_s=cfg["iterations"] / t["steady_s"],
               one_card_steady_s=t1["steady_s"],
               one_card_compile_s=t1["compile_s"],
               speedup_vs_one_card=t1["steady_s"] / t["steady_s"],
               result_devices=span, peak_bytes_per_card=peaks, **par)
    if par["rel_objective"] > OBJ_TOL or par["rel_rms"] > RMS_TOL:
        raise SmokeFailure("4-card vs 1-card: %s" % par)
    return rec


def _one_card_solve(b, cfg):
    """The single-device solve of config 5 on the CLI's operators."""
    from functools import partial

    import jax.numpy as jnp

    from nsol_tpu.jitutil import jit_closed
    from nsol_tpu.ops import conv as C, grad as G, matmul_ops as MM
    from nsol_tpu.solvers.admm import admm_solve

    cov = np.eye(3)
    shape = b.shape
    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                     method="auto", dtype=np.float32)
    nA = C.make_normal_blur_operator(cov, alpha_cut=3, shape=shape,
                                     dtype=np.float32)
    nB = MM.matmul_gradient_normal_fn(shape, dtype=np.float32)
    Bg, Bg_adj = G.make_gradient_operators()
    alpha = jnp.asarray(cfg["alpha"], jnp.float32)
    rho = jnp.asarray(cfg["rho"], jnp.float32)
    solve = jit_closed(
        partial(admm_solve, A, A_adj, Bg, Bg_adj,
                iterations=cfg["iterations"], iter_max=cfg["iter_max"],
                minimizer="cg", normal_A=nA, normal_B=nB),
        (b, 0.0, b, alpha, rho))
    return lambda bj: solve(bj, 0.0, bj, alpha, rho)[0]


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def describe_device():
    """Fail unless JAX's first device is a GPU; print what was found."""
    import jax
    import jaxlib

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit("chip_smoke: no GPU: JAX's device is %r (%s); "
                         "this check runs only on a GPU"
                         % (dev.platform, dev.device_kind))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise SystemExit("chip_smoke: nvidia-smi failed: %s" % smi.stderr)
    for line in smi.stdout.strip().splitlines():
        print("card: %s" % line.strip())
    from nsol_tpu.jitutil import DEFAULT_COMPILE_CACHE

    print("jax %s, jaxlib %s, XLA_FLAGS=%r, compile cache %s" % (
        jax.__version__, jaxlib.__version__, os.environ.get("XLA_FLAGS"),
        os.environ.get("JAX_COMPILATION_CACHE_DIR")
        or DEFAULT_COMPILE_CACHE), flush=True)
    return dev


def _emit(rec):
    print(json.dumps(rec, default=float), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only config 5 over a 4-card mesh")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu-reference", metavar="JOBS",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.cpu_reference:
        run_reference_jobs(args.cpu_reference)
        return 0

    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    dev = describe_device()
    import jax

    from nsol_tpu.jitutil import setup_compile_cache

    setup_compile_cache()
    clock = CompileClock()
    if args.four_cards:
        _emit(phase_four_cards(clock, FOUR_CARDS, args.seed))
    else:
        with tempfile.TemporaryDirectory() as workdir:
            # two CPU children, so the huber reference (the longest)
            # runs beside all the others
            children = (ReferenceChild(workdir, "main"),
                        ReferenceChild(workdir, "huber"))
            try:
                _one_card_phases(clock, workdir, children, args.seed,
                                 t_start)
            finally:
                for child in children:
                    child.stop()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


STUDIES = (("pd", STUDY_PD), ("admm", STUDY_ADMM), ("tk1", STUDY_TK1))


def _one_card_phases(clock, workdir, children, seed, t_start):
    # host-side inputs and every float64 reference job first, so the CPU
    # children solve while the card runs the phases below
    child = children[0]
    deconv_path, denoise_path = make_volume_inputs(workdir, DECONV["n"],
                                                   seed)
    b_dc, b_dn = _load(deconv_path), _load(denoise_path)
    deconv = deconvolution_jobs(workdir, deconv_path, DECONV, children)
    denoise = denoising_job(workdir, denoise_path, DENOISE, child)
    problems = [study_problem(kind, cfg, seed) for kind, cfg in STUDIES]
    study_refs = [study_job(workdir, kind, cfg, obs, grid, child)
                  for (kind, cfg), (obs, grid) in zip(STUDIES, problems)]
    for c in children:
        c.start()

    _emit(phase_north_star(clock))
    pending = []
    for run in deconv:
        obj = (lambda x, loss=run["loss"]: deconv_objective(
            x, b_dc, float(b_dc.max()), DECONV["alpha"], data_loss=loss))
        pending.append((deconvolution_run(clock, run, DECONV), run, obj))
    pending.append((denoising_run(clock, denoise, DENOISE), denoise,
                    lambda x: denoise_objective(x, b_dn, float(b_dn.max()),
                                                DENOISE["alpha"])))
    studies = [study_run(clock, kind, cfg, obs, grid)
               for (kind, cfg), (obs, grid) in zip(STUDIES, problems)]
    blur = phase_blur_methods(clock, BLUR_SIZES)

    for c in children:
        c.wait(timeout=max(BUDGET_S - (time.perf_counter() - t_start), 1))
    for rec, run, obj in pending:
        rec.update(parity(_read_result(run["out"]), np.load(run["ref"]),
                          obj))
        _emit(rec)
    for (rec, x), (ref, obj) in zip(studies, study_refs):
        rec.update({"point_" + k: v for k, v in
                    parity(x, np.load(ref), obj).items()})
        _emit(rec)
    _emit(blur)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
        sys.exit(1)
