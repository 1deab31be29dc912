"""Run deconvolution algorithm study (grid sweep via the interface).

Parity port of nsol/application/run_deconvolution_study.py:36-175.
"""

import numpy as np

from nsol_tpu.cli.argparser import InputArgparser
from nsol_tpu.interface import DeconvolutionParameterStudyInterface
from nsol_tpu.io import DataReader
from nsol_tpu.ops import conv as C
from nsol_tpu.ops import grad as G


def main():
    from nsol_tpu.jitutil import setup_compile_cache

    setup_compile_cache()
    input_parser = InputArgparser(
        description="Run deconvolution algorithm study")
    input_parser.add_observation(required=True)
    input_parser.add_reference(required=False)
    input_parser.add_dir_output(required=True)
    input_parser.add_study_name()
    input_parser.add_reconstruction_type(default="TVL2")
    input_parser.add_measures(default=["PSNR", "RMSE", "SSIM", "NCC", "NMI"])
    input_parser.add_blur(default=1)
    input_parser.add_solver(default="PD")
    input_parser.add_iterations(default=50)
    input_parser.add_rho(default=0.1)
    input_parser.add_iter_max(default=10)
    input_parser.add_minimizer(default="auto")
    input_parser.add_irls_cg_iters(default=8)
    input_parser.add_alpha(default=[0.01])
    input_parser.add_data_loss(default="linear")
    input_parser.add_data_loss_scale(default=1)
    input_parser.add_verbose(default=0)
    input_parser.add_alpha_range(default=[0.0001, 0.05, 10])
    input_parser.add_data_losses(default=None)
    input_parser.add_data_loss_scale_range(default=None)
    args = input_parser.parse_args()
    input_parser.print_arguments(args)

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

    parameters = {"alpha": np.linspace(
        args.alpha_range[0], args.alpha_range[1], int(args.alpha_range[2]))}
    if args.data_losses is not None:
        parameters["data_loss"] = args.data_losses
    if args.data_loss_scale_range is not None:
        parameters["data_loss_scale"] = np.linspace(
            args.data_loss_scale_range[0], args.data_loss_scale_range[1],
            int(args.data_loss_scale_range[2]))

    x_scale = np.max(observed_nda)
    if data_reader.get_image_nifti() is None:
        spacing = np.ones(dimension)
    else:
        spacing = np.array(data_reader.get_image_nifti().get_spacing())

    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, spacing=spacing,
                                     shape=observed_nda.shape, method="auto")
    grad_op, grad_adj = G.make_gradient_operators(spacing)
    # The default --minimizer auto stays "auto" through the interface so
    # the solver wrappers re-resolve it per swept data_loss (the
    # wrappers also build the normal-operator hints themselves from the
    # blur_cov hint). For an unambiguous resolution (no data_loss sweep)
    # the hints are built eagerly here as before.
    resolved = args.minimizer
    if args.data_losses is None:
        from nsol_tpu.solvers.tikhonov import resolve_minimizer

        resolved = resolve_minimizer(args.minimizer,
                                     data_loss=args.data_loss,
                                     cov=cov, spacing=spacing)
    # Fused normal operators for the minimizer="cg"/"irls" fast paths
    normal_A = normal_B = None
    if resolved in ("cg", "irls"):
        from nsol_tpu.ops import matmul_ops as MM

        if resolved == "cg":
            normal_A = C.make_normal_blur_operator(
                cov, alpha_cut=3, spacing=spacing, shape=observed_nda.shape)
        try:
            normal_B = MM.matmul_gradient_normal_fn(
                observed_nda.shape, spacing)
        except Exception:
            normal_B = lambda x: G.gradient_normal(x, spacing)

    name = (args.study_name if args.study_name is not None
            else args.reconstruction_type)

    interface = DeconvolutionParameterStudyInterface(
        A=A, A_adj=A_adj, D=grad_op, D_adj=grad_adj, b=observed_nda,
        x0=np.array(observed_nda), alpha=args.alpha[0], x_scale=x_scale,
        data_loss=args.data_loss, data_loss_scale=args.data_loss_scale,
        iter_max=args.iter_max, iterations=args.iterations,
        minimizer=resolved, measures=args.measures,
        dimension=dimension,
        reconstruction_type=args.reconstruction_type, rho=args.rho,
        dir_output=args.dir_output, parameters=parameters, name=name,
        reconstruction_info=data_reader.get_reconstruction_info(),
        x_ref=x_ref, tv_solver=args.solver, verbose=args.verbose,
        normal_A=normal_A, normal_B=normal_B,
        irls_cg_iters=args.irls_cg_iters,
        blur_cov=cov, spacing=spacing)
    interface.set_up_parameter_study()
    parameter_study = interface.get_parameter_study()
    parameter_study.run()

    print("\nComputational time for Deconvolution Parameter Study %s: %s"
          % (name, parameter_study.get_computational_time()))
    return 0


if __name__ == "__main__":
    main()
