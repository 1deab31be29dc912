"""Operator layer: stencils, convolutions, losses, proxes, priors,
similarity measures. Replaces the reference layers L0–L2
(nsol/kernels.py, nsol/linear_operators.py, nsol/loss_functions.py,
nsol/proximal_operators.py, nsol/prior_measures.py,
nsol/similarity_measures.py) with shaped-array jittable functions."""

from nsol_tpu.ops import kernels, grad, conv, losses, prox, priors, measures

from nsol_tpu.ops.kernels import gaussian_kernel
from nsol_tpu.ops.grad import (
    gradient, gradient_adjoint, make_gradient_operators,
)
from nsol_tpu.ops.conv import convolve, make_blur_operators

__all__ = [
    "kernels", "grad", "conv", "losses", "prox", "priors", "measures",
    "gaussian_kernel", "gradient", "gradient_adjoint",
    "make_gradient_operators", "convolve", "make_blur_operators",
]
