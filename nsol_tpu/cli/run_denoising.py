"""Run TVL1/TVL2/HuberL1/HuberL2 denoising.

CLI-parity port of the reference app (nsol/application/run_denoising.py:33-250)
on shaped arrays (no flattening closures), the scanned
primal-dual solver, and in-graph similarity measures. The reference's
hardcoded ``L2=8`` (even for 3-D volumes — a preserved quirk, see
nsol/application/run_denoising.py:147) is kept as the default.
"""

import os

import numpy as np
import jax.numpy as jnp

from nsol_tpu import timer as ph
from nsol_tpu.cli.argparser import InputArgparser
from nsol_tpu.io import DataReader, DataWriter
from nsol_tpu.observer import Observer
from nsol_tpu.ops import grad as G
from nsol_tpu.ops import prox as prox_ops
from nsol_tpu.ops import measures as sim
from nsol_tpu.solvers.wrappers import PrimalDualSolver, ADMMLinearSolver


def main(argv=None):
    """Run the CLI on ``argv`` (default: ``sys.argv[1:]``)."""
    from nsol_tpu.jitutil import setup_compile_cache

    setup_compile_cache()
    input_parser = InputArgparser(
        description="Run TVL1/TVL2/HuberL1/HuberL2 denoising")
    input_parser.add_observation(required=True)
    input_parser.add_result(required=False)
    input_parser.add_reference(required=False)
    input_parser.add_reconstruction_type(default="TVL2")
    input_parser.add_measures(default=["PSNR", "RMSE", "SSIM", "NCC", "NMI"])
    input_parser.add_iterations(default=50)
    input_parser.add_solver(default="PD")
    input_parser.add_rho(default=0.1)
    input_parser.add_alpha(default=[0.03])
    input_parser.add_dir_output_figures(default=None)
    input_parser.add_verbose(default=0)
    input_parser.add_trace(default=None)
    args = input_parser.parse_args(argv)
    input_parser.print_arguments(args)

    alphas = np.atleast_1d(args.alpha)
    if len(alphas) > 1 and args.result is not None:
        print("WARNING: Multiple alphas overwrite result")
    elif len(alphas) == 1 and args.result is None:
        raise IOError("'--result' must be specified")

    # ------------------------------ Read data ------------------------------
    data_reader = DataReader(args.observation)
    data_reader.read_data()
    observed_nda = data_reader.get_data()
    dimension = observed_nda.ndim

    x_ref = None
    if args.reference is not None:
        ref_reader = DataReader(args.reference)
        ref_reader.read_data()
        x_ref = jnp.asarray(ref_reader.get_data())

    # ---------------------------- Set up solver ----------------------------
    b = observed_nda
    x_scale = np.max(observed_nda)
    bj = jnp.asarray(b / x_scale)
    grad_op, grad_adj = G.make_gradient_operators()

    rtype = args.reconstruction_type
    if rtype in ("TVL1", "HuberL1"):
        prox_f = lambda x, tau: prox_ops.prox_ell1_denoising(x, tau, bj)
    elif rtype in ("TVL2", "HuberL2"):
        prox_f = lambda x, tau: prox_ops.prox_ell2_denoising(x, tau, bj)
    else:
        raise ValueError("Denoising type '%s' not known" % rtype)
    prox_g_conj = (prox_ops.prox_tv_conj if rtype.startswith("TV")
                   else prox_ops.prox_huber_conj)

    # --trace DIR: capture a jax.profiler device trace of the whole
    # reconstruction loop (SURVEY §5 tracing/profiling; profiling.py)
    import contextlib

    from nsol_tpu import profiling

    tracer = (profiling.trace(args.trace) if args.trace
              else contextlib.nullcontext())

    recons = []
    observers = []
    with tracer:
        for alpha in alphas:
            if args.solver == "PD":
                solver = PrimalDualSolver(
                    prox_f=prox_f, prox_g_conj=prox_g_conj,
                    B=grad_op, B_conj=grad_adj,
                    L2=8,  # reference quirk: 8 even in 3-D (run_denoising.py:147)
                    x0=np.array(observed_nda), alpha=alpha,
                    iterations=args.iterations, x_scale=x_scale,
                    verbose=args.verbose)
            elif args.solver == "ADMM":
                if rtype != "TVL2":
                    raise ValueError("ADMM denoising supports TVL2 only")
                ident = lambda z: z
                solver = ADMMLinearSolver(
                    A=ident, A_adj=ident, b=np.array(observed_nda),
                    B=grad_op, B_adj=grad_adj, x0=np.array(observed_nda),
                    dimension=dimension, alpha=alpha, rho=args.rho,
                    iterations=args.iterations, x_scale=x_scale,
                    verbose=args.verbose)
            else:
                raise ValueError("Solver '%s' not known" % args.solver)

            observer = None
            if x_ref is not None and args.measures:
                measures_dic = {
                    m: (lambda x, m=m: sim.SIMILARITY_MEASURES[m](x, x_ref))
                    for m in args.measures}
                observer = Observer()
                observer.set_measures(measures_dic)
                solver.set_observer(observer)
            observers.append(observer)

            solver.run()
            recon = solver.get_x()
            recons.append(recon)
            if args.verbose:
                ph.print_info("Required computational time: %s"
                              % solver.get_computational_time())

            if args.result is not None:
                DataWriter(recon, args.result,
                           data_reader.get_image_nifti()).write_data()

    # --------------------------- Visualization -----------------------------
    if args.verbose and args.dir_output_figures is not None:
        _save_figures(args, observed_nda, recons, alphas, observers)
    if args.verbose and observed_nda.ndim == 3:
        # reference contract: 3-D denoising results open in ITK-Snap
        # when available (run_denoising.py:197-248); best-effort here
        # (itksnap executable or napari), silently headless otherwise
        from nsol_tpu.viewer import try_interactive_3d

        spacing = None
        if data_reader.get_image_nifti() is not None:
            spacing = np.array(data_reader.get_image_nifti().get_spacing())
        try_interactive_3d(
            [observed_nda] + recons,
            ["observed"] + ["alpha=%g" % a for a in alphas],
            spacing=spacing)

    return 0


def _save_figures(args, observed, recons, alphas, observers):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(args.dir_output_figures, exist_ok=True)
    if observed.ndim == 2:
        n = 1 + len(recons)
        fig, axes = plt.subplots(1, n, figsize=(4 * n, 4))
        axes = np.atleast_1d(axes)
        axes[0].imshow(observed, cmap="jet")
        axes[0].set_title("observed")
        for i, (r, a) in enumerate(zip(recons, alphas)):
            axes[i + 1].imshow(r, cmap="jet")
            axes[i + 1].set_title(r"$\alpha=%g$" % a)
        fig.savefig(os.path.join(
            args.dir_output_figures,
            args.reconstruction_type + "_comparison.pdf"))
        plt.close(fig)

    if observers[0] is not None:
        for m in args.measures:
            fig, ax = plt.subplots()
            for obs, a in zip(observers, alphas):
                res = obs.get_measures_results()[m]
                ax.plot(range(len(res)), res, label=r"$\alpha=%g$" % a)
            ax.set_xlabel("iteration")
            ax.set_title("%s: %s" % (args.reconstruction_type, m))
            ax.legend()
            fig.savefig(os.path.join(
                args.dir_output_figures,
                args.reconstruction_type + "_" + m + ".pdf"))
            plt.close(fig)


if __name__ == "__main__":
    main()
