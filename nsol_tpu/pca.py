"""Principal component analysis and robust-PCA variants.

JAX re-expression of the reference module
(nsol/principal_component_analysis.py:28-426):

* :class:`PrincipalComponentAnalysis` — eigendecomposition of the point
  covariance, eigenpairs sorted descending, right-handed 3-D frame (:28-111)
* :class:`AlmRobustPrincipalComponentAnalysis` — inexact augmented-Lagrange
  RPCA ``D = L + S`` with singular-value shrinkage (:125-213; Candes 2011
  Algorithm 1), the iteration body jitted as one XLA program under
  ``lax.while_loop``
* :class:`AdmmRobustPrincipalComponentAnalysis` — 3-way ADMM split
  (Frobenius + entrywise-L1 + nuclear; :225-426). The reference parallelizes
  its three prox updates with a ``ThreadPool(3)`` — the only concurrency in
  the whole reference package; here the three updates are independent ops in
  one jitted program and XLA schedules them, so the thread pool disappears.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "PrincipalComponentAnalysis",
    "AlmRobustPrincipalComponentAnalysis",
    "AdmmRobustPrincipalComponentAnalysis",
]


class PrincipalComponentAnalysis(object):
    """PCA on (n_points, dim) point clouds, dim in {2, 3}."""

    def __init__(self, points):
        points = np.array(points)
        if points.ndim != 2 or points.shape[1] not in (2, 3):
            raise IOError("Numpy array must be of shape N x dim, "
                          "with dim either 2 or 3.")
        self._points = points
        self._mean = None
        self._cov = None
        self._eigval = None
        self._eigvec = None

    def run(self):
        self._mean = np.mean(self._points, axis=0)
        self._cov = np.cov(self._points - self._mean, rowvar=False)
        eigval, eigvec = np.linalg.eigh(self._cov)
        idx = eigval.argsort()[::-1]
        self._eigval = eigval[idx]
        self._eigvec = eigvec[:, idx]
        if self._points.shape[1] == 3:
            # right-handed frame (reference: pca.py:69)
            self._eigvec[:, 2] = np.cross(self._eigvec[:, 0],
                                          self._eigvec[:, 1])

    def get_mean(self):
        return self._mean

    def get_cov(self):
        return self._cov

    def get_eigvec(self):
        return self._eigvec

    def get_eigval(self):
        return self._eigval

    def show(self, title="PCA", ax=None, step=1, path=None):
        """Principal-axes plot (reference surface:
        nsol/principal_component_analysis.py:76-111): point cloud plus one
        arrow per eigenvector, anchored at the mean and scaled by its
        eigenvalue. Handles 2-D and 3-D clouds; headless-safe (Agg) —
        pass ``path`` to save the figure. Returns the axes.
        """
        import matplotlib
        if path is not None:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        if self._eigvec is None:
            raise RuntimeError("Run 'run' first")
        dim = self._points.shape[1]
        pts = self._points[::step]

        fig = None
        if ax is None:
            fig = plt.figure(title)
            fig.clf()
            ax = (fig.add_subplot(111, projection="3d") if dim == 3
                  else fig.add_subplot(111))
        axis_colors = ["g", "b", "k"]
        if dim == 3:
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], color="red",
                       marker="x")
            for i in range(3):
                arrow = self._eigval[i] * self._eigvec[:, i]
                ax.quiver(*self._mean, *arrow, color=axis_colors[i],
                          label="eigvec%d" % (i + 1))
        else:
            ax.scatter(pts[:, 0], pts[:, 1], color="red", marker="x")
            for i in range(2):
                arrow = self._eigval[i] * self._eigvec[:, i]
                ax.quiver(self._mean[0], self._mean[1], arrow[0], arrow[1],
                          angles="xy", scale_units="xy", scale=1,
                          color=axis_colors[i], label="eigvec%d" % (i + 1))
            ax.set_aspect("equal")
        ax.set_title(title)
        ax.legend()
        if path is not None and fig is not None:
            fig.savefig(path)
            plt.close(fig)
        return ax


def _soft_shrink(M, tau):
    return jnp.sign(M) * jnp.maximum(jnp.abs(M) - tau, 0.0)


def _svd_shrink(M, tau):
    U, S, Vt = jnp.linalg.svd(M, full_matrices=False)
    return jnp.matmul(U * _soft_shrink(S, tau)[jnp.newaxis, :], Vt,
                      precision=lax.Precision.HIGHEST)


class AlmRobustPrincipalComponentAnalysis(object):
    """RPCA ``D = L + S`` via inexact ALM."""

    def __init__(self, D, mu=None, lmbda=None):
        self.D = np.asarray(D, dtype=np.float64)
        self.S = np.zeros(self.D.shape)
        self.Y = np.zeros(self.D.shape)
        if mu:
            self.mu = mu
        else:
            self.mu = np.prod(self.D.shape) / (4 * np.sum(self.D ** 2))
        self.mu_inv = 1.0 / self.mu
        self.lmbda = (lmbda if lmbda
                      else 1.0 / np.sqrt(np.max(self.D.shape)))
        self.L = None

    def fit(self, tol=None, max_iter=1000, iter_print=100):
        D = jnp.asarray(self.D)
        _tol = tol if tol else 1e-7 * float(np.sum(self.D ** 2))
        mu, mu_inv, lmbda = self.mu, self.mu_inv, self.lmbda

        def cond(state):
            _, _, _, err, it = state
            return jnp.logical_and(err > _tol, it < max_iter)

        def body(state):
            Lk, Sk, Yk, _, it = state
            Lk = _svd_shrink(D - Sk + mu_inv * Yk, mu_inv)
            Sk = _soft_shrink(D - Lk + mu_inv * Yk, mu_inv * lmbda)
            Yk = Yk + mu * (D - Lk - Sk)
            err = jnp.sum(jnp.abs(D - Lk - Sk) ** 2)
            return (Lk, Sk, Yk, err, it + 1)

        init = (jnp.zeros_like(D), jnp.asarray(self.S), jnp.asarray(self.Y),
                jnp.asarray(np.inf), jnp.asarray(0))
        Lk, Sk, Yk, err, it = jax.jit(
            lambda s: lax.while_loop(cond, body, s))(init)
        print("iteration: {0}, error: {1}".format(int(it), float(err)))

        self.L = np.asarray(Lk)
        self.S = np.asarray(Sk)
        return self.L, self.S


class AdmmRobustPrincipalComponentAnalysis(object):
    """RPCA via a 3-way ADMM split: ``A = X1 + X2 + X3`` with Frobenius
    (noise), entrywise-L1 (foreground), nuclear (low-rank background)
    penalties."""

    MAX_ITER = 100
    ABSTOL = 1e-4
    RELTOL = 1e-2

    def __init__(self, D):
        self._data = np.asarray(D, dtype=np.float64)

    def run(self):
        A = jnp.asarray(self._data)
        m, n = A.shape
        N = 3

        # g2_max = ||Aᵀ||_inf (max column abs sum), g3_max = spectral norm
        # (reference: pca.py:311-314)
        g2 = 0.15 * float(np.linalg.norm(self._data.T, np.inf))
        g3 = 0.15 * float(np.linalg.norm(self._data, 2))
        lambdap = 1.0
        rho = 1.0 / lambdap

        def objective(X1, X2, X3):
            sv = jnp.linalg.svd(X3, compute_uv=False)
            return (jnp.sum(X1 * X1) + g2 * jnp.sum(jnp.abs(X2))
                    + g3 * jnp.sum(jnp.abs(sv)))

        def step(carry, _):
            X1, X2, X3, z, U, done = carry
            B = (X1 + X2 + X3) / N - A / N + U

            # Three independent prox updates — XLA schedules them in one
            # program (replaces the reference's ThreadPool(3), pca.py:305).
            X1n = (1.0 / (1.0 + lambdap)) * (X1 - B)
            X2n = _soft_shrink(X2 - B, lambdap * g2)
            X3n = _svd_shrink(X3 - B, lambdap * g3)

            X1 = jnp.where(done, X1, X1n)
            X2 = jnp.where(done, X2, X2n)
            X3 = jnp.where(done, X3, X3n)

            x = jnp.hstack([X1, X2, X3])
            zold = z
            znew = x + jnp.tile(-(X1 + X2 + X3) / N + A / N, (1, N))
            z = jnp.where(done, z, znew)
            U = jnp.where(done, U, B)

            r_norm = jnp.linalg.norm(x - z)
            s_norm = jnp.linalg.norm(-rho * (z - zold))
            eps_pri = (np.sqrt(m * n * N) * self.ABSTOL
                       + self.RELTOL * jnp.maximum(jnp.linalg.norm(x),
                                                   jnp.linalg.norm(z)))
            eps_dual = (np.sqrt(m * n * N) * self.ABSTOL
                        + self.RELTOL * np.sqrt(N) * jnp.linalg.norm(rho * U))
            conv = jnp.logical_and(r_norm < eps_pri, s_norm < eps_dual)
            out = {
                "objval": objective(X1, X2, X3),
                "r_norm": r_norm, "s_norm": s_norm,
                "eps_pri": eps_pri, "eps_dual": eps_dual,
                "active": jnp.logical_not(done),
            }
            return (X1, X2, X3, z, U, jnp.logical_or(done, conv)), out

        Z0 = jnp.zeros((m, n))
        init = (Z0, Z0, Z0, jnp.zeros((m, N * n)), Z0,
                jnp.asarray(False))
        (X1, X2, X3, _, _, _), hist = jax.jit(
            lambda s: lax.scan(step, s, None, length=self.MAX_ITER))(init)

        n_iter = int(np.sum(np.asarray(hist["active"])))
        h = {k: np.asarray(v) for k, v in hist.items() if k != "active"}
        h["admm_iter"] = max(0, n_iter - 1)
        h["X1_admm"] = np.asarray(X1)   # sparse
        h["X2_admm"] = np.asarray(X2)   # error/noise
        h["X3_admm"] = np.asarray(X3)   # low-rank
        return h
