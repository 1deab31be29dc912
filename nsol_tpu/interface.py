"""Problem-setup façade: reconstruction-type → configured solver + measures.

Parity port of the reference's
``DeconvolutionSolverStudyInterface``/``DeconvolutionParameterStudyInterface``
(nsol/deconvolution_solver_parameter_study_interface.py:101-552), consumed
by the deconvolution CLIs and downstream projects (NiftyMIC):

* TK0L2/TK1L2 → Tikhonov with B=I / B=D (:217-253)
* TVL2 → primal-dual with ``prox_f = prox_linear_least_squares`` (inner
  CGLS) or ADMM, per ``tv_solver`` (:255-301)
* HuberL2 → primal-dual with ``prox_huber_conj`` (:303-325)

plus the measures dict: optional (masked) similarity vs ``x_ref`` and the
always-appended ``Reg``/``Data`` cost trackers feeding the L-curve
(:327-361). All measures are jittable and evaluated in-graph by the
scanned solvers.

Deviation (improvement): the inner CGLS of ``prox_linear_least_squares``
warm-starts from the current PD iterate; the reference's lsmr always
cold-starts (nsol/tikhonov_linear_solver.py:149-154 passes no x0).
"""

import numpy as np
import jax.numpy as jnp

from nsol_tpu.observer import Observer
from nsol_tpu.ops import losses as lf
from nsol_tpu.ops import prox as prox_ops
from nsol_tpu.ops import priors
from nsol_tpu.ops.measures import SIMILARITY_MEASURES
from nsol_tpu.solvers import tikhonov as _tik
from nsol_tpu.solvers.wrappers import (
    TikhonovLinearSolver, ADMMLinearSolver, PrimalDualSolver,
)
from nsol_tpu.study.engine import (
    TikhonovLinearSolverParameterStudy, ADMMLinearSolverParameterStudy,
    PrimalDualSolverParameterStudy,
)

__all__ = ["DeconvolutionSolverStudyInterface",
           "DeconvolutionParameterStudyInterface"]


class DeconvolutionSolverStudyInterface(object):

    def __init__(self, A, A_adj, D, D_adj, b, x0, alpha, x_scale,
                 iter_max, iterations, minimizer, measures,
                 reconstruction_type, dimension, L2=8, rho=0.5,
                 x_ref=None, x_ref_mask=None, data_loss="linear",
                 data_loss_scale=1, tv_solver="PD", verbose=0, append=0,
                 normal_A=None, normal_B=None, irls_cg_iters=8,
                 blur_cov=None, spacing=None):
        self._A = A
        self._A_adj = A_adj
        # optional separable-blur hint (covariance + voxel spacing):
        # lets the ADMM solver build its fused normal operators itself
        self._blur_cov = blur_cov
        self._spacing = spacing
        # Fused normal operators (A^T A, B^T B) enabling the
        # minimizer="cg" fast path of the inner quadratic solver
        self._normal_A = normal_A
        self._normal_B = normal_B
        self._D = D
        self._D_adj = D_adj
        self._b = b
        self._x0 = x0
        self._alpha = alpha
        self._data_loss = data_loss
        self._data_loss_scale = data_loss_scale
        self._x_scale = x_scale
        self._iter_max = iter_max
        self._iterations = iterations
        self._minimizer = minimizer
        self._measures = measures
        self._reconstruction_type = reconstruction_type
        self._x_ref = x_ref
        self._x_ref_mask = x_ref_mask
        self._dimension = dimension
        self._tv_solver = tv_solver
        self._L2 = L2
        self._rho = rho
        self._verbose = verbose
        self._append = append
        self._irls_cg_iters = irls_cg_iters

        self._solver = None
        self._measures_dic = None

        self._set_up_solver_map = {
            "TK0L2": self._set_up_solver_TK0L2,
            "TK1L2": self._set_up_solver_TK1L2,
            "TVL2": self._set_up_solver_TVL2,
            "HuberL2": self._set_up_solver_HuberL2,
        }
        self._append_costs_map = {
            "TK0L2": self._append_reg_and_data_costs_TK0L2,
            "TK1L2": self._append_reg_and_data_costs_TK1L2,
            "TVL2": self._append_reg_and_data_costs_TVL2,
            "HuberL2": self._append_reg_and_data_costs_HuberL2,
        }
        if reconstruction_type not in self._set_up_solver_map:
            raise ValueError("reconstruction type '%s' not known; allowed: %s"
                             % (reconstruction_type,
                                sorted(self._set_up_solver_map)))

    def set_up_solver(self):
        self._solver = self._set_up_solver_map[self._reconstruction_type]()

    def set_up_measures(self):
        if self._x_ref is not None:
            x_ref = np.asarray(self._x_ref)
            if x_ref.shape != np.asarray(self._x0).shape:
                raise ValueError("Initial value x0 and reference x_ref "
                                 "arrays must be of same shape")
            if self._x_ref_mask is not None:
                mask = np.asarray(self._x_ref_mask) > 0
                if x_ref.shape != mask.shape:
                    raise ValueError("Reference x_ref and mask arrays must "
                                     "be of same shape")
                indices = np.where(mask)
            else:
                indices = np.where(x_ref != np.inf)
            x_ref_j = jnp.asarray(x_ref[indices])
            idx_j = tuple(jnp.asarray(ix) for ix in indices)
            measures_dic = {
                m: (lambda x, m=m:
                    SIMILARITY_MEASURES[m](x[idx_j], x_ref_j))
                for m in self._measures}
        else:
            measures_dic = {}
        self._append_costs_map[self._reconstruction_type](measures_dic)
        self._measures_dic = measures_dic

    def get_solver(self):
        if self._solver is None:
            raise RuntimeError("Run 'set_up_solver' first")
        return self._solver

    def get_measures(self):
        if self._measures_dic is None:
            raise RuntimeError("Run 'set_up_measures' first")
        return self._measures_dic

    # -- solver factories --------------------------------------------------

    def _set_up_solver_TK0L2(self):
        ident = lambda x: x
        return TikhonovLinearSolver(
            A=self._A, A_adj=self._A_adj, B=ident, B_adj=ident,
            b=self._b, alpha=self._alpha, x0=self._x0,
            x_scale=self._x_scale, data_loss=self._data_loss,
            data_loss_scale=self._data_loss_scale,
            iter_max=self._iter_max, minimizer=self._minimizer,
            verbose=self._verbose, normal_A=self._normal_A,
            normal_B=ident, irls_cg_iters=self._irls_cg_iters,
            blur_cov=self._blur_cov, spacing=self._spacing,
            reg_kind="TK0")

    def _set_up_solver_TK1L2(self):
        return TikhonovLinearSolver(
            A=self._A, A_adj=self._A_adj, B=self._D, B_adj=self._D_adj,
            b=self._b, alpha=self._alpha, x0=self._x0,
            x_scale=self._x_scale, data_loss=self._data_loss,
            data_loss_scale=self._data_loss_scale,
            iter_max=self._iter_max, minimizer=self._minimizer,
            verbose=self._verbose, normal_A=self._normal_A,
            normal_B=self._normal_B, irls_cg_iters=self._irls_cg_iters,
            blur_cov=self._blur_cov, spacing=self._spacing,
            reg_kind="TK1")

    def _make_prox_lls(self):
        """prox of f(x)=½‖Ax−b‖² in scaled variables via inner CGLS
        (reference: nsol/proximal_operators.py:43-78)."""
        b_scaled = jnp.asarray(np.asarray(self._b, dtype=np.float64)
                               / self._x_scale)
        A, A_adj = self._A, self._A_adj
        iter_max = self._iter_max
        data_loss = self._data_loss
        data_loss_scale = self._data_loss_scale
        # the prox closure has no reflective surface — "auto" resolves
        # here against the blur hint (wrapper classes resolve lazily)
        minimizer = _tik.resolve_minimizer(
            self._minimizer, data_loss=data_loss, cov=self._blur_cov,
            spacing=self._spacing)
        normal_A = self._normal_A

        def prox_f(x, tau):
            return _tik.prox_linear_least_squares(
                x, tau, A, A_adj, b_scaled, x0=x, iter_max=iter_max,
                data_loss=data_loss, data_loss_scale=data_loss_scale,
                minimizer=minimizer, normal_A=normal_A)

        return prox_f

    def _set_up_solver_TVL2(self):
        if self._tv_solver == "PD":
            return PrimalDualSolver(
                prox_f=self._make_prox_lls(),
                prox_g_conj=prox_ops.prox_tv_conj,
                B=self._D, B_conj=self._D_adj, L2=self._L2,
                alpha=self._alpha, x0=self._x0,
                iterations=self._iterations, x_scale=self._x_scale,
                verbose=self._verbose)
        elif self._tv_solver == "ADMM":
            return ADMMLinearSolver(
                A=self._A, A_adj=self._A_adj, b=self._b,
                B=self._D, B_adj=self._D_adj, alpha=self._alpha,
                x0=self._x0, x_scale=self._x_scale,
                data_loss=self._data_loss,
                data_loss_scale=self._data_loss_scale, rho=self._rho,
                iterations=self._iterations, dimension=self._dimension,
                iter_max=self._iter_max, minimizer=self._minimizer,
                verbose=self._verbose, normal_A=self._normal_A,
                normal_B=self._normal_B,
                irls_cg_iters=self._irls_cg_iters,
                blur_cov=self._blur_cov, spacing=self._spacing)
        raise ValueError("tv_solver must be 'PD' or 'ADMM'")

    def _set_up_solver_HuberL2(self):
        # NOTE the reference drops data_loss for the HuberL2 prox
        # (…interface.py:303-311 passes no data_loss) — preserved.
        b_scaled = jnp.asarray(np.asarray(self._b, dtype=np.float64)
                               / self._x_scale)
        A, A_adj = self._A, self._A_adj
        iter_max = self._iter_max

        def prox_f(x, tau):
            return _tik.prox_linear_least_squares(
                x, tau, A, A_adj, b_scaled, x0=x, iter_max=iter_max)

        return PrimalDualSolver(
            prox_f=prox_f, prox_g_conj=prox_ops.prox_huber_conj,
            B=self._D, B_conj=self._D_adj, L2=self._L2,
            alpha=self._alpha, x0=self._x0,
            iterations=self._iterations, x_scale=self._x_scale,
            verbose=self._verbose)

    # -- Reg/Data cost measures (feed the L-curve) -------------------------

    def _data_cost(self, x):
        return lf.cost_from_residual(
            self._A(x) - jnp.asarray(self._b), self._data_loss,
            self._data_loss_scale)

    def _append_reg_and_data_costs_TK0L2(self, measures_dic):
        measures_dic["Reg"] = priors.zeroth_order_tikhonov
        measures_dic["Data"] = self._data_cost

    def _append_reg_and_data_costs_TK1L2(self, measures_dic):
        measures_dic["Reg"] = lambda x: priors.first_order_tikhonov(
            x, self._D)
        measures_dic["Data"] = self._data_cost

    def _append_reg_and_data_costs_TVL2(self, measures_dic):
        measures_dic["Reg"] = lambda x: priors.total_variation(x, self._D)
        measures_dic["Data"] = self._data_cost

    def _append_reg_and_data_costs_HuberL2(self, measures_dic):
        measures_dic["Reg"] = lambda x: priors.huber(x, self._D)
        measures_dic["Data"] = self._data_cost


class DeconvolutionParameterStudyInterface(DeconvolutionSolverStudyInterface):
    """Study factory on top of the solver factory
    (reference: …interface.py:484-552)."""

    def __init__(self, A, A_adj, D, D_adj, b, x0, alpha, x_scale, iter_max,
                 iterations, minimizer, measures, dimension,
                 reconstruction_type, dir_output, parameters, name,
                 reconstruction_info, L2=8, rho=0.5, x_ref=None,
                 x_ref_mask=None, data_loss="linear", data_loss_scale=1,
                 tv_solver="PD", verbose=0, append=False, use_vmap=True,
                 normal_A=None, normal_B=None, irls_cg_iters=8,
                 blur_cov=None, spacing=None):
        DeconvolutionSolverStudyInterface.__init__(
            self, A=A, A_adj=A_adj, D=D, D_adj=D_adj, b=b, x0=x0,
            alpha=alpha, data_loss=data_loss,
            data_loss_scale=data_loss_scale, x_scale=x_scale,
            iter_max=iter_max, iterations=iterations, minimizer=minimizer,
            measures=measures, reconstruction_type=reconstruction_type,
            L2=L2, rho=rho, x_ref=x_ref, x_ref_mask=x_ref_mask,
            dimension=dimension, tv_solver=tv_solver, verbose=verbose,
            append=append, normal_A=normal_A, normal_B=normal_B,
            irls_cg_iters=irls_cg_iters, blur_cov=blur_cov,
            spacing=spacing)
        self._name = name
        self._parameters = parameters
        self._reconstruction_info = reconstruction_info
        self._dir_output = dir_output
        self._use_vmap = use_vmap
        self._parameter_study = None

    def set_up_parameter_study(self):
        self.set_up_solver()
        self.set_up_measures()
        observer = Observer()
        observer.set_measures(self._measures_dic)

        rtype = self._reconstruction_type
        common = dict(dir_output=self._dir_output,
                      parameters=self._parameters, name=self._name,
                      reconstruction_info=self._reconstruction_info,
                      append=self._append, use_vmap=self._use_vmap)
        if rtype in ("TK0L2", "TK1L2"):
            self._parameter_study = TikhonovLinearSolverParameterStudy(
                self._solver, observer, **common)
        elif rtype == "TVL2" and self._tv_solver == "ADMM":
            self._parameter_study = ADMMLinearSolverParameterStudy(
                self._solver, observer, **common)
        else:
            self._parameter_study = PrimalDualSolverParameterStudy(
                self._solver, observer, **common)

    def get_parameter_study(self):
        if self._parameter_study is None:
            raise RuntimeError("Run 'set_up_parameter_study' first")
        return self._parameter_study
