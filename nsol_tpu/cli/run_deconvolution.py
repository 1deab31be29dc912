"""Run TK0L2/TK1L2/TVL2/HuberL2 deconvolution.

CLI-parity port of the reference app
(nsol/application/run_deconvolution.py:28-248) on shaped arrays: Gaussian
blur A from ``--blur`` (cov = diag(σ²)), voxel spacing from the nii header
when present, solver selection via the deconvolution interface, alpha loop
via ``set_alpha`` (no retrace — alpha is a traced argument).
"""

import os

import numpy as np

from nsol_tpu import timer as ph
from nsol_tpu.cli.argparser import InputArgparser
from nsol_tpu.interface import DeconvolutionSolverStudyInterface
from nsol_tpu.io import DataReader, DataWriter
from nsol_tpu.observer import Observer
from nsol_tpu.ops import conv as C
from nsol_tpu.ops import grad as G


def main(argv=None):
    """Run the CLI on ``argv`` (default: ``sys.argv[1:]``)."""
    from nsol_tpu.jitutil import setup_compile_cache

    setup_compile_cache()
    input_parser = InputArgparser(
        description="Run TK0L2/TK1L2/TVL2/HuberL2 deconvolution")
    input_parser.add_observation(required=True)
    input_parser.add_result(required=False)
    input_parser.add_reference(required=False)
    input_parser.add_blur(default=1)
    input_parser.add_reconstruction_type(default="TVL2")
    input_parser.add_measures(default=["PSNR", "RMSE", "SSIM", "NCC", "NMI"])
    input_parser.add_iterations(default=50)
    input_parser.add_solver(default="PD")
    input_parser.add_rho(default=0.5)
    input_parser.add_alpha(default=[0.01])
    input_parser.add_data_loss(default="linear")
    input_parser.add_data_loss_scale(default=1.0)
    input_parser.add_minimizer(default="auto")
    input_parser.add_iter_max(default=10)
    input_parser.add_irls_cg_iters(default=8)
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
        x_ref = ref_reader.get_data()

    sigma = np.atleast_1d(args.blur).astype(np.float64)
    if sigma.size == 1:
        cov = np.diag(np.ones(dimension)) * sigma ** 2
    elif sigma.size == dimension:
        cov = np.diag(sigma ** 2)
    else:
        raise IOError("Blur information must be either 1- or d-dimensional")

    # ---------------------------- Set up solver ----------------------------
    b = observed_nda
    x0 = np.array(observed_nda)
    x_scale = np.max(observed_nda)

    if data_reader.get_image_nifti() is None:
        spacing = np.ones(dimension)
    else:
        spacing = np.array(data_reader.get_image_nifti().get_spacing())

    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, spacing=spacing,
                                     shape=observed_nda.shape, method="auto")
    grad_op, grad_adj = G.make_gradient_operators(spacing)
    # The default --minimizer auto resolves to the fastest valid inner
    # engine (linear+separable → cg, robust+separable → irls, else the
    # reference's lsmr / L-BFGS-B); data_loss is fixed per CLI run, so
    # resolving here is safe. Explicit --minimizer lsmr keeps the
    # reference path.
    from nsol_tpu.solvers.tikhonov import resolve_minimizer

    args.minimizer = resolve_minimizer(
        args.minimizer, data_loss=args.data_loss, cov=cov,
        spacing=spacing)
    # Fused normal operators for the minimizer="cg"/"irls" fast paths
    normal_A = normal_B = None
    if args.minimizer in ("cg", "irls"):
        from nsol_tpu.ops import matmul_ops as MM

        if args.minimizer == "cg":
            normal_A = C.make_normal_blur_operator(
                cov, alpha_cut=3, spacing=spacing, shape=observed_nda.shape)
        try:
            normal_B = MM.matmul_gradient_normal_fn(
                observed_nda.shape, spacing)
        except Exception:
            normal_B = lambda x: G.gradient_normal(x, spacing)

    # --trace DIR: capture a jax.profiler device trace of the whole
    # reconstruction loop (SURVEY §5 tracing/profiling; profiling.py)
    import contextlib

    from nsol_tpu import profiling

    tracer = (profiling.trace(args.trace) if args.trace
              else contextlib.nullcontext())

    solver_interface = DeconvolutionSolverStudyInterface(
        A=A, A_adj=A_adj, D=grad_op, D_adj=grad_adj, b=b, x0=x0,
        alpha=alphas[0], x_scale=x_scale, data_loss=args.data_loss,
        data_loss_scale=args.data_loss_scale, iter_max=args.iter_max,
        iterations=args.iterations, minimizer=args.minimizer,
        measures=args.measures, dimension=dimension,
        reconstruction_type=args.reconstruction_type, rho=args.rho,
        x_ref=x_ref, tv_solver=args.solver, verbose=args.verbose,
        normal_A=normal_A, normal_B=normal_B,
        irls_cg_iters=args.irls_cg_iters)
    solver_interface.set_up_solver()
    solver_interface.set_up_measures()
    solver = solver_interface.get_solver()
    measures_dic = solver_interface.get_measures()

    # -------------------------- Run reconstruction -------------------------
    recons = []
    observers = []
    with tracer:
        for i, alpha in enumerate(alphas):
            ph.print_subtitle("Iteration %d/%d" % (i + 1, len(alphas)))
            solver.set_alpha(alpha)

            observer = Observer()
            observer.set_measures(measures_dic)
            solver.set_observer(observer)
            observers.append(observer)

            solver.run()
            recon = solver.get_x()
            recons.append(recon)
            print("\nComputational time %s: %s"
                  % (args.reconstruction_type,
                     solver.get_computational_time()))

            if args.result is not None:
                DataWriter(recon, args.result,
                           data_reader.get_image_nifti()).write_data()

    if args.verbose and args.dir_output_figures is not None:
        _save_figures(args, observed_nda, recons, alphas, observers,
                      measures_dic)

    return 0


def _save_figures(args, observed, recons, alphas, observers, measures_dic):
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

    for m in measures_dic:
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
