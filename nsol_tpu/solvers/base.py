"""Object layer over the functional solver cores.

Mirrors the reference's class surface (``Solver`` at nsol/solver.py:21-174,
``LinearSolver`` at nsol/linear_solver.py:30-344) so the parameter-study
engine's reflective ``set_<param>``/``get_<param>`` reconfiguration
(nsol/solver_parameter_study.py:175-182) and downstream consumers keep
working — while every ``run()`` dispatches to a jitted, scanned functional
core on shaped arrays instead of a host loop on flattened vectors.

``x_scale`` semantics follow the reference exactly: the problem is solved in
scaled variables ``xs = x/x_scale`` (x0 and b divided on entry,
nsol/solver.py:35-41, nsol/linear_solver.py:84), and ``get_x()`` rescales.
"""

import numpy as np
import jax.numpy as jnp

from nsol_tpu import timer as ph
from nsol_tpu.defaults import default_dtype
from nsol_tpu.ops import losses as lf

__all__ = ["Solver", "LinearSolver"]


class Solver(object):
    """Abstract numerical solver holding x0, x_scale, observer, timing."""

    def __init__(self, x0, x_scale=1.0, verbose=0):
        self._x_scale = float(x_scale)
        # Library compute dtype: float64 under x64 (CPU tests), float32 on
        # the accelerator — the reference is float64-only (nsol/solver.py:37).
        self._dtype = default_dtype()
        self._x0 = np.asarray(x0, dtype=self._dtype) / self._x_scale
        self._x = np.array(self._x0)
        self._verbose = verbose
        self._computational_time = None
        self._observer = None
        self._record_trajectory = False

    def set_x_scale(self, x_scale):
        # Reference quirk preserved: changing x_scale does NOT rescale the
        # stored x0/b (nsol/solver.py:52-53); call set_x0 afterwards, as the
        # study engine does.
        self._x_scale = float(x_scale)

    def get_x_scale(self):
        return self._x_scale

    def set_verbose(self, verbose):
        self._verbose = verbose

    def get_verbose(self):
        return self._verbose

    def set_x0(self, x0):
        self._x0 = np.asarray(x0, dtype=self._dtype) / self._x_scale
        self._x = np.array(self._x0)

    def get_x0(self):
        return np.array(self._x0) * self._x_scale

    def get_x(self):
        return np.array(self._x) * self._x_scale

    def get_computational_time(self):
        return self._computational_time

    def set_observer(self, observer):
        self._observer = observer

    def set_record_trajectory(self, flag):
        """Opt into materializing the full iterate trajectory in the
        observer (memory-hostile on the accelerator; off by default)."""
        self._record_trajectory = bool(flag)

    def run(self):
        time_start = ph.start_timing()
        self._run()
        self._computational_time = ph.stop_timing(time_start)
        if self._verbose:
            ph.print_info("Required computational time: %s"
                          % self._computational_time)
        if self._observer is not None:
            self._observer.set_computational_time(self._computational_time)

    def _run(self):
        raise NotImplementedError

    def print_statistics(self, fmt="%.3e"):
        raise NotImplementedError

    # -- helpers for subclasses -------------------------------------------

    def _observer_measures(self):
        """Jittable measure dict from the attached observer (or None)."""
        if self._observer is None:
            return None
        measures = self._observer.get_measures()
        return measures if measures else None

    def _push_records(self, records):
        if self._observer is None or records is None:
            return
        if "measures" in records:
            self._observer.set_precomputed_measures(
                {k: np.asarray(v) for k, v in records["measures"].items()})
        if "x" in records:
            for xi in np.asarray(records["x"]):
                self._observer.add_x(xi * self._x_scale)


class LinearSolver(Solver):
    """Base for solvers of ``min_x ½‖ρ((Ax−b)²)‖ + α g(x)``
    (reference: nsol/linear_solver.py:30-344)."""

    def __init__(self, A, A_adj, b, x0, alpha, x_scale=1.0,
                 data_loss="linear", data_loss_scale=1.0,
                 minimizer="lsmr", iter_max=10, verbose=0):
        Solver.__init__(self, x0=x0, x_scale=x_scale, verbose=verbose)
        self._A = A
        self._A_adj = A_adj
        self._b = np.asarray(b, dtype=self._dtype) / self._x_scale
        self._alpha = float(alpha)
        self._data_loss = data_loss
        self._data_loss_scale = float(data_loss_scale)
        self._minimizer = minimizer
        self._iter_max = iter_max

    def get_A(self):
        return self._A

    def get_A_adj(self):
        return self._A_adj

    def get_b(self):
        return np.array(self._b) * self._x_scale

    def set_alpha(self, alpha):
        self._alpha = float(alpha)

    def get_alpha(self):
        return self._alpha

    def set_data_loss(self, data_loss):
        if data_loss not in lf.LOSSES:
            raise ValueError("data_loss must be in %s" % list(lf.LOSSES))
        self._data_loss = data_loss

    def get_data_loss(self):
        return self._data_loss

    def set_data_loss_scale(self, data_loss_scale):
        self._data_loss_scale = float(data_loss_scale)

    def get_data_loss_scale(self):
        return self._data_loss_scale

    def set_minimizer(self, minimizer):
        self._minimizer = minimizer

    def get_minimizer(self):
        return self._minimizer

    def _resolved_minimizer(self):
        """``"auto"`` resolves per the current data loss and the
        separable-blur hint (``blur_cov``) at each use — reflective
        ``set_data_loss`` updates re-resolve. Explicit minimizers pass
        through."""
        from nsol_tpu.solvers.tikhonov import resolve_minimizer

        return resolve_minimizer(
            self._minimizer, data_loss=self._data_loss,
            cov=getattr(self, "_blur_cov", None),
            spacing=getattr(self, "_spacing", None))

    def set_iter_max(self, iter_max):
        self._iter_max = int(iter_max)

    def get_iter_max(self):
        return self._iter_max

    # -- cost interface (reference: nsol/linear_solver.py:250-340) ---------

    def get_total_cost(self):
        return (self.get_cost_data_term()
                + self._alpha * self.get_cost_regularization_term())

    def get_cost_data_term(self):
        return float(self._cost_data(jnp.asarray(self._x)))

    def get_ell2_cost_data_term(self):
        r = self._A(jnp.asarray(self._x)) - jnp.asarray(self._b)
        return float(0.5 * jnp.sum(r * r))

    def get_cost_regularization_term(self):
        return float(self._cost_regularization(jnp.asarray(self._x)))

    def _cost_data(self, x):
        r = self._A(x) - jnp.asarray(self._b)
        return lf.cost_from_residual(r, self._data_loss,
                                     self._data_loss_scale)

    def _cost_regularization(self, x):
        raise NotImplementedError

    def print_statistics(self, fmt="%.3e"):
        cost_data = self.get_cost_data_term()
        cost_data_ell2 = self.get_ell2_cost_data_term()
        cost_reg = self.get_cost_regularization_term()
        ph.print_subtitle("Summary Optimization")
        ph.print_info("Computational time: %s" % self.get_computational_time())
        ph.print_info(
            "Cost data term (f, loss=%s, scale=%g): " %
            (self._data_loss, self._data_loss_scale) + fmt % cost_data +
            " (ell2-cost: " + fmt % cost_data_ell2 + ")")
        ph.print_info("Cost regularization term (g): " + fmt % cost_reg)
        ph.print_info(
            "Total cost (f + alpha g; alpha = %g): " % self._alpha +
            fmt % (cost_data + self._alpha * cost_reg))
