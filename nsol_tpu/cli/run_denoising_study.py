"""Run denoising algorithm study (grid sweep over alpha / data-loss scales).

Parity port of nsol/application/run_denoising_study.py:36-205. The alpha
grid executes on the vmapped fast path: all configurations batch into one
compiled program (the reference runs them serially).

Reference quirk preserved: the ``Data`` measure here is SSD/SAD *without*
the ½ factor (run_denoising_study.py:140-162), unlike the deconvolution
interface's ½‖·‖² Data cost.
"""

import numpy as np
import jax.numpy as jnp

from nsol_tpu.cli.argparser import InputArgparser
from nsol_tpu.io import DataReader
from nsol_tpu.observer import Observer
from nsol_tpu.ops import grad as G
from nsol_tpu.ops import prox as prox_ops
from nsol_tpu.ops import priors
from nsol_tpu.ops import measures as sim
from nsol_tpu.solvers.wrappers import PrimalDualSolver
from nsol_tpu.study import PrimalDualSolverParameterStudy


def main():
    from nsol_tpu.jitutil import setup_compile_cache

    setup_compile_cache()
    input_parser = InputArgparser(description="Run denoising algorithm study")
    input_parser.add_observation(required=True)
    input_parser.add_reference(required=False)
    input_parser.add_dir_output(required=True)
    input_parser.add_study_name()
    input_parser.add_reconstruction_type(default="TVL2")
    input_parser.add_measures(default=["PSNR", "RMSE", "SSIM", "NCC", "NMI"])
    input_parser.add_iterations(default=200)
    input_parser.add_rho(default=0.1)
    input_parser.add_verbose(default=0)
    input_parser.add_alpha_range(default=[0.01, 1.5, 10])
    input_parser.add_data_losses(default=None)
    input_parser.add_data_loss_scale_range(default=None)
    args = input_parser.parse_args()
    input_parser.print_arguments(args)

    data_reader = DataReader(args.observation)
    data_reader.read_data()
    observed_nda = data_reader.get_data()

    x_ref = None
    if args.reference is not None:
        ref_reader = DataReader(args.reference)
        ref_reader.read_data()
        x_ref = jnp.asarray(ref_reader.get_data())

    # ---------------------------- Set up solver ----------------------------
    b = observed_nda
    x_scale = np.max(observed_nda)
    bj = jnp.asarray(b / x_scale)
    bj_full = jnp.asarray(b)
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

    solver = PrimalDualSolver(
        prox_f=prox_f, prox_g_conj=prox_g_conj, B=grad_op,
        B_conj=grad_adj, L2=8, x0=np.array(observed_nda),
        iterations=args.iterations, x_scale=x_scale, verbose=args.verbose)

    # --------------------------- Measures dict -----------------------------
    measures_dic = {}
    if x_ref is not None and args.measures:
        measures_dic = {
            m: (lambda x, m=m: sim.SIMILARITY_MEASURES[m](x, x_ref))
            for m in args.measures}

    if rtype.startswith("TV"):
        measures_dic["Reg"] = lambda x: priors.total_variation(x, grad_op)
    else:
        measures_dic["Reg"] = lambda x: priors.huber(x, grad_op)
    if rtype.endswith("L1"):
        measures_dic["Data"] = lambda x: sim.sum_of_absolute_differences(
            x, bj_full)
    else:
        measures_dic["Data"] = lambda x: sim.sum_of_squared_differences(
            x, bj_full)

    observer = Observer()
    observer.set_measures(measures_dic)
    solver.set_observer(observer)

    # ---------------------------- Parameters -------------------------------
    parameters = {"alpha": np.linspace(
        args.alpha_range[0], args.alpha_range[1], int(args.alpha_range[2]))}
    if args.data_losses is not None:
        parameters["data_loss"] = args.data_losses
    if args.data_loss_scale_range is not None:
        parameters["data_loss_scale"] = np.linspace(
            args.data_loss_scale_range[0], args.data_loss_scale_range[1],
            int(args.data_loss_scale_range[2]))

    name = args.study_name if args.study_name is not None else rtype
    parameter_study = PrimalDualSolverParameterStudy(
        solver, observer, dir_output=args.dir_output,
        parameters=parameters, name=name,
        reconstruction_info=data_reader.get_reconstruction_info())
    parameter_study.run()

    print("\nComputational time for Denoising Parameter Study %s: %s"
          % (name, parameter_study.get_computational_time()))
    return 0


if __name__ == "__main__":
    main()
