"""Concrete solver classes: Tikhonov, ADMM, primal-dual.

Reference-parity class surface over the functional cores. Each ``run()``
compiles (once per static configuration) a single jitted program covering
the full iteration loop including per-iteration measures; changing traced
parameters like ``alpha``/``rho``/``data_loss_scale`` or the data does NOT
retrace — which is what makes serial parameter sweeps cheap even before the
vmapped fast path.

Operators (``A``, ``B``, proxes) act on *shaped* arrays — the reference's
flattening closures (nsol/application/run_deconvolution.py:120-129)
disappear. ``B`` for TV solvers is the stacked ``(d, *shape)`` gradient.
"""

import numpy as np
import jax
import jax.numpy as jnp

from nsol_tpu.solvers.base import Solver, LinearSolver
from nsol_tpu.solvers import tikhonov as _tik
from nsol_tpu.solvers import admm as _admm
from nsol_tpu.solvers import primal_dual as _pd
from nsol_tpu.jitutil import jit_closed

__all__ = ["TikhonovLinearSolver", "ADMMLinearSolver", "PrimalDualSolver"]

def _sharded_vmap_run(solve_one, arg_arrays, mesh):
    """vmap ``solve_one`` over equal-length config arrays, optionally
    sharding the batch across a 1-axis mesh (zero-padding to a multiple of
    the mesh size). Returns (outputs, n_original)."""
    n = len(arg_arrays[0])
    arrs = [np.asarray(a, dtype=np.float64) for a in arg_arrays]
    if mesh is not None:
        size = int(np.prod(list(mesh.shape.values())))
        pad = (-n) % size
        if pad:
            arrs = [np.concatenate([a, np.repeat(a[-1:], pad)])
                    for a in arrs]
    args = tuple(jnp.asarray(a) for a in arrs)

    if mesh is None:
        fn = jit_closed(jax.vmap(solve_one), args)
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = NamedSharding(mesh, P(mesh.axis_names[0]))
        args = tuple(jax.device_put(a, sh) for a in args)
        fn = jit_closed(jax.vmap(solve_one), args,
                        in_shardings=(sh,) * len(args), out_shardings=sh)
    return fn(*args), n


def _make_record_fn(measures, x_scale):
    """Build a jittable ``x -> {name: scalar}`` evaluating observer measures
    on the *rescaled* iterate (observers see ``get_x()`` units;
    nsol/solver.py:117-118)."""
    if not measures:
        return None

    def record(x):
        xs = x * x_scale
        return {name: fn(xs) for name, fn in measures.items()}

    return record


class TikhonovLinearSolver(LinearSolver):
    """``min_x ½‖ρ((Ax−b)²)‖ + α/2‖Bx−b_reg‖²``
    (reference: nsol/tikhonov_linear_solver.py:25-280)."""

    def __init__(self, A, A_adj, b, B, B_adj, x0, alpha=0.01, b_reg=0,
                 data_loss="linear", data_loss_scale=1, minimizer="lsmr",
                 iter_max=10, x_scale=1, verbose=0, bounds=(0, np.inf),
                 normal_A=None, normal_B=None, irls_cg_iters=8,
                 blur_cov=None, spacing=None, reg_kind=None):
        LinearSolver.__init__(
            self, A=A, A_adj=A_adj, b=b, x0=x0, alpha=alpha,
            x_scale=x_scale, data_loss=data_loss,
            data_loss_scale=data_loss_scale, minimizer=minimizer,
            iter_max=iter_max, verbose=verbose)
        self._B = B
        self._B_adj = B_adj
        self._b_reg = np.asarray(b_reg, dtype=self._dtype) / self._x_scale
        self._bounds = bounds
        # Fused normal operators for the minimizer="cg" fast path
        self._normal_A = normal_A
        self._normal_B = normal_B
        self._irls_cg_iters = int(irls_cg_iters)
        #: optional problem hints: set ``blur_cov`` (+``spacing``) and
        #: ``reg_kind`` ("TK0": B = I, "TK1": B = stacked gradient) ONLY
        #: when A/B are exactly those operators — then a cg/irls
        #: minimizer gets the fused normal operators built automatically.
        self._blur_cov = blur_cov
        self._spacing = spacing
        self._reg_kind = reg_kind
        self._solve_cache = {}

    def set_irls_cg_iters(self, irls_cg_iters):
        self._irls_cg_iters = int(irls_cg_iters)

    def get_irls_cg_iters(self):
        return self._irls_cg_iters

    def get_B(self):
        return self._B

    def get_B_adj(self):
        return self._B_adj

    def get_b_reg(self):
        return np.array(self._b_reg) * self._x_scale

    def _ensure_normal_ops(self, minimizer):
        """Build the fused normal-operator hints from ``blur_cov`` when
        the (resolved) minimizer can exploit them and the caller didn't
        supply them — a default-flag run gets the fast path."""
        if minimizer not in ("cg", "irls") or self._blur_cov is None:
            return
        if self._normal_A is None:
            from nsol_tpu.ops.conv import make_normal_blur_operator

            try:
                self._normal_A = make_normal_blur_operator(
                    self._blur_cov, alpha_cut=3, spacing=self._spacing,
                    shape=np.asarray(self._x0).shape)
            except ValueError:
                return
        if self._normal_B is None and self._reg_kind == "TK1":
            from nsol_tpu.ops import grad as _G

            spacing = self._spacing
            self._normal_B = lambda x: _G.gradient_normal(x, spacing)
        if self._normal_B is None and self._reg_kind == "TK0":
            self._normal_B = lambda x: x

    def _run(self):
        if self._observer is not None:
            self._observer.add_x(self.get_x())

        minimizer = self._resolved_minimizer()
        self._ensure_normal_ops(minimizer)
        args = (jnp.asarray(self._b), jnp.asarray(self._b_reg),
                jnp.asarray(self._x0),
                jnp.asarray(self._alpha, self._x0.dtype),
                jnp.asarray(self._data_loss_scale, self._x0.dtype))
        key = (minimizer, self._iter_max, self._data_loss,
               self._bounds, self._irls_cg_iters, id(self._A), id(self._B))
        if key not in self._solve_cache:
            def fn(b, b_reg, x0, alpha, dls):
                return _tik.tikhonov_solve(
                    self._A, self._A_adj, self._B, self._B_adj,
                    b, b_reg, x0, alpha,
                    data_loss=self._data_loss, data_loss_scale=dls,
                    minimizer=minimizer, iter_max=self._iter_max,
                    bounds=self._bounds, normal_A=self._normal_A,
                    normal_B=self._normal_B,
                    irls_cg_iters=self._irls_cg_iters)

            self._solve_cache[key] = jit_closed(fn, args)
        x = self._solve_cache[key](*args)
        self._x = np.asarray(x)

        if self._observer is not None:
            self._observer.add_x(self.get_x())

    def _cost_regularization(self, x):
        """``½‖Bx‖²`` — b_reg deliberately ignored (reference quirk at
        nsol/tikhonov_linear_solver.py:276-280)."""
        Bx = self._B(x)
        return 0.5 * jnp.sum(Bx * Bx)

    def run_sweep(self, param_values, measures=None, mesh=None):
        """Vmapped parameter sweep (fast path of the study engine).

        ``param_values``: dict of per-configuration value arrays (cartesian
        product already expanded), keys ⊆ {"alpha", "data_loss_scale"}.
        Returns ``(x_all, records)`` with x_all unscaled, records a dict
        name -> (n_configs, 2) array (measures at x0 and the solution,
        mirroring the reference observer's two add_x calls).
        """
        record_fn = _make_record_fn(measures, self._x_scale)
        n = len(next(iter(param_values.values())))
        alphas = param_values.get("alpha", np.full(n, self._alpha))
        dls = param_values.get("data_loss_scale",
                               np.full(n, self._data_loss_scale))

        minimizer = self._resolved_minimizer()
        self._ensure_normal_ops(minimizer)

        def solve_one(alpha, data_loss_scale):
            x = _tik.tikhonov_solve(
                self._A, self._A_adj, self._B, self._B_adj,
                jnp.asarray(self._b), jnp.asarray(self._b_reg),
                jnp.asarray(self._x0), alpha,
                data_loss=self._data_loss,
                data_loss_scale=data_loss_scale,
                minimizer=minimizer, iter_max=self._iter_max,
                bounds=self._bounds, normal_A=self._normal_A,
                normal_B=self._normal_B,
                irls_cg_iters=self._irls_cg_iters)
            if record_fn is None:
                return x, None
            recs = jax.tree_util.tree_map(
                lambda a, b: jnp.stack([a, b]),
                record_fn(jnp.asarray(self._x0)), record_fn(x))
            return x, recs

        (x_all, records), n = _sharded_vmap_run(
            solve_one, (alphas, dls), mesh)
        x_np = np.asarray(x_all)[:n] * self._x_scale
        rec_np = (None if records is None else
                  {k: np.asarray(v)[:n] for k, v in records.items()})
        return x_np, rec_np


class ADMMLinearSolver(LinearSolver):
    """TV-regularized (robust) least squares via ADMM
    (reference: nsol/admm_linear_solver.py:28-312)."""

    def __init__(self, A, A_adj, b, B, B_adj, x0, dimension=None, b_reg=0,
                 alpha=0.01, iter_max=10, minimizer="lsmr",
                 data_loss="linear", data_loss_scale=1, rho=0.5,
                 iterations=10, x_scale=1, verbose=0,
                 normal_A=None, normal_B=None, irls_cg_iters=8,
                 blur_cov=None, spacing=None):
        LinearSolver.__init__(
            self, A=A, A_adj=A_adj, b=b, x0=x0, alpha=alpha,
            x_scale=x_scale, data_loss=data_loss,
            data_loss_scale=data_loss_scale, minimizer=minimizer,
            iter_max=iter_max, verbose=verbose)
        self._B = B
        self._B_adj = B_adj
        self._b_reg = np.asarray(b_reg, dtype=self._dtype) / self._x_scale
        self._dimension = dimension  # retained for API parity; shapes carry d
        self._rho = float(rho)
        self._iterations = int(iterations)
        # Fused normal operators for the minimizer="cg" fast path
        self._normal_A = normal_A
        self._normal_B = normal_B
        self._irls_cg_iters = int(irls_cg_iters)
        #: optional problem hints: set ``blur_cov`` (+``spacing``) ONLY
        #: when ``A`` is the Gaussian blur of that covariance and ``B``
        #: the stacked gradient — then a cg/irls minimizer gets the
        #: fused normal operators built automatically.
        self._blur_cov = blur_cov
        self._spacing = spacing
        self._solve_cache = {}

    def set_rho(self, rho):
        self._rho = float(rho)

    def get_rho(self):
        return self._rho

    def set_irls_cg_iters(self, irls_cg_iters):
        self._irls_cg_iters = int(irls_cg_iters)

    def get_irls_cg_iters(self):
        return self._irls_cg_iters

    def get_dimension(self):
        return self._dimension

    def set_iterations(self, iterations):
        self._iterations = int(iterations)

    def get_iterations(self):
        return self._iterations

    def _ensure_normal_ops(self, minimizer):
        """As TikhonovLinearSolver._ensure_normal_ops: with the
        separable-blur hint set (A = Gaussian blur, B = stacked
        gradient), a resolved cg/irls minimizer gets the fused normal
        operators built automatically."""
        if minimizer not in ("cg", "irls") or self._blur_cov is None:
            return
        if self._normal_A is None:
            from nsol_tpu.ops.conv import make_normal_blur_operator

            try:
                self._normal_A = make_normal_blur_operator(
                    self._blur_cov, alpha_cut=3, spacing=self._spacing,
                    shape=np.asarray(self._x0).shape)
            except ValueError:
                return
        if self._normal_B is None:
            from nsol_tpu.ops import grad as _G

            spacing = self._spacing
            self._normal_B = lambda x: _G.gradient_normal(x, spacing)

    def _run(self):
        measures = self._observer_measures()
        record_fn = _make_record_fn(measures, self._x_scale)

        minimizer = self._resolved_minimizer()
        self._ensure_normal_ops(minimizer)
        args = (jnp.asarray(self._b), jnp.asarray(self._b_reg),
                jnp.asarray(self._x0),
                jnp.asarray(self._alpha, self._x0.dtype),
                jnp.asarray(self._rho, self._x0.dtype),
                jnp.asarray(self._data_loss_scale, self._x0.dtype))
        key = (minimizer, self._iter_max, self._iterations,
               self._data_loss, bool(record_fn), self._record_trajectory,
               tuple(sorted(measures)) if measures else None,
               self._irls_cg_iters, id(self._A), id(self._B))
        if key not in self._solve_cache:
            def fn(b, b_reg, x0, alpha, rho, dls):
                return _admm.admm_solve(
                    self._A, self._A_adj, self._B, self._B_adj,
                    b, b_reg, x0, alpha, rho,
                    iterations=self._iterations, iter_max=self._iter_max,
                    data_loss=self._data_loss, data_loss_scale=dls,
                    minimizer=minimizer, record_fn=record_fn,
                    record_trajectory=self._record_trajectory,
                    normal_A=self._normal_A, normal_B=self._normal_B,
                    irls_cg_iters=self._irls_cg_iters)

            self._solve_cache[key] = jit_closed(fn, args)
        x, records = self._solve_cache[key](*args)
        self._x = np.asarray(x)
        self._push_records(records)

    def _cost_regularization(self, x):
        """TV of ``Bx`` (reference: nsol/admm_linear_solver.py:311-312)."""
        Bx = self._B(x)
        return jnp.sum(jnp.sqrt(jnp.sum(Bx * Bx, axis=0)))

    def run_sweep(self, param_values, measures=None, mesh=None):
        """Vmapped ``alpha×rho`` sweep — ONE compiled program for the whole
        grid (the reference loops it serially with reflective setters,
        nsol/solver_parameter_study.py:170-221)."""
        record_fn = _make_record_fn(measures, self._x_scale)
        n = len(next(iter(param_values.values())))
        alphas = param_values.get("alpha", np.full(n, self._alpha))
        rhos = param_values.get("rho", np.full(n, self._rho))
        dls = param_values.get("data_loss_scale",
                               np.full(n, self._data_loss_scale))

        minimizer = self._resolved_minimizer()
        self._ensure_normal_ops(minimizer)

        def solve_one(alpha, rho, data_loss_scale):
            return _admm.admm_solve(
                self._A, self._A_adj, self._B, self._B_adj,
                jnp.asarray(self._b), jnp.asarray(self._b_reg),
                jnp.asarray(self._x0), alpha, rho,
                iterations=self._iterations, iter_max=self._iter_max,
                data_loss=self._data_loss,
                data_loss_scale=data_loss_scale,
                minimizer=minimizer, record_fn=record_fn,
                normal_A=self._normal_A, normal_B=self._normal_B,
                irls_cg_iters=self._irls_cg_iters)

        (x_all, records), n = _sharded_vmap_run(
            solve_one, (alphas, rhos, dls), mesh)
        x_np = np.asarray(x_all)[:n] * self._x_scale
        rec_np = None
        if records is not None and "measures" in records:
            rec_np = {k: np.asarray(v)[:n]
                      for k, v in records["measures"].items()}
        return x_np, rec_np


class PrimalDualSolver(Solver):
    """Chambolle–Pock primal-dual solver
    (reference: nsol/primal_dual_solver.py:26-403)."""

    def __init__(self, prox_f, prox_g_conj, B, B_conj, L2, x0, alpha=0.01,
                 iterations=10, x_scale=1., verbose=0, alg_type="ALG2"):
        Solver.__init__(self, x0=x0, x_scale=x_scale, verbose=verbose)
        self._prox_f = prox_f
        self._prox_g_conj = prox_g_conj
        self._B = B
        self._B_conj = B_conj
        self._L2 = float(L2)
        self._alpha = float(alpha)
        self._iterations = int(iterations)
        self._alg_type = alg_type
        self._solve_cache = {}

    def set_alpha(self, alpha):
        self._alpha = float(alpha)

    def get_alpha(self):
        return self._alpha

    def set_L2(self, L2):
        self._L2 = float(L2)

    def get_L2(self):
        return self._L2

    def set_alg_type(self, alg_type):
        self._alg_type = alg_type

    def get_alg_type(self):
        return self._alg_type

    def set_iterations(self, iterations):
        self._iterations = int(iterations)

    def get_iterations(self):
        return self._iterations

    def print_statistics(self, fmt="%.3e"):
        pass

    def _run(self):
        measures = self._observer_measures()
        record_fn = _make_record_fn(measures, self._x_scale)

        args = (jnp.asarray(self._x0),
                jnp.asarray(self._alpha, self._x0.dtype),
                jnp.asarray(self._L2, self._x0.dtype))
        key = (self._alg_type, self._iterations, bool(record_fn),
               self._record_trajectory,
               tuple(sorted(measures)) if measures else None,
               id(self._B), id(self._prox_f), id(self._prox_g_conj))
        if key not in self._solve_cache:
            def fn(x0, alpha, L2):
                return _pd.primal_dual_solve(
                    self._prox_f, self._prox_g_conj,
                    self._B, self._B_conj, x0, alpha, L2,
                    iterations=self._iterations, alg_type=self._alg_type,
                    record_fn=record_fn,
                    record_trajectory=self._record_trajectory)

            self._solve_cache[key] = jit_closed(fn, args)
        x, records = self._solve_cache[key](*args)
        self._x = np.asarray(x)
        self._push_records(records)

    def run_sweep(self, param_values, measures=None, mesh=None):
        """Vmapped alpha sweep — the 64-alpha L-curve study runs as one
        compiled batched program (BASELINE config 4).

        ``mesh``: optional 1-axis ``jax.sharding.Mesh``; when given, the
        configuration batch is sharded across its devices (data-parallel
        sweep over the ``"batch"`` axis, SURVEY.md §2 DP equivalent). The
        batch is zero-padded to a multiple of the mesh size.
        """
        record_fn = _make_record_fn(measures, self._x_scale)
        n = len(next(iter(param_values.values())))
        alphas = param_values.get("alpha", np.full(n, self._alpha))

        def solve_one(alpha):
            return _pd.primal_dual_solve(
                self._prox_f, self._prox_g_conj, self._B, self._B_conj,
                jnp.asarray(self._x0), alpha, self._L2,
                iterations=self._iterations, alg_type=self._alg_type,
                record_fn=record_fn)

        (x_all, records), n = _sharded_vmap_run(solve_one, (alphas,), mesh)
        x_np = np.asarray(x_all)[:n] * self._x_scale
        rec_np = None
        if records is not None and "measures" in records:
            rec_np = {k: np.asarray(v)[:n]
                      for k, v in records["measures"].items()}
        return x_np, rec_np
