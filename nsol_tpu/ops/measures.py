"""Similarity / dissimilarity measures, jittable on device.

jnp re-expression of the reference's ``SimilarityMeasures``
(nsol/similarity_measures.py:25-290). Every measure is a pure function of
shaped arrays so the parameter-study engine can evaluate whole trajectories
batched in-graph instead of host-looping over iterates
(reference loops on host: nsol/observer.py:111-119).

SSIM is self-implemented (the reference defers to
``skimage.measure.compare_ssim``, nsol/similarity_measures.py:134-136):
7×7 uniform window, sample covariance normalization (ddof=1), K1=0.01,
K2=0.03 — the Wang et al. 2004 constants used by skimage's defaults. The
``data_range`` defaults to the reference image's value range.
"""

import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = [
    "sum_of_absolute_differences", "mean_absolute_error",
    "sum_of_squared_differences", "mean_squared_error",
    "root_mean_square_error", "peak_signal_to_noise_ratio",
    "normalized_cross_correlation", "structural_similarity",
    "shannon_entropy", "joint_entropy", "mutual_information",
    "normalized_mutual_information", "dice_score",
    "SIMILARITY_MEASURES", "UNDEF", "get_measure",
]


def sum_of_absolute_differences(x, x_ref):
    """SSD_1 (reference: nsol/similarity_measures.py:25-29)."""
    return jnp.sum(jnp.abs(x - x_ref))


def mean_absolute_error(x, x_ref):
    return sum_of_absolute_differences(x, x_ref) / x.size


def sum_of_squared_differences(x, x_ref):
    return jnp.sum(jnp.square(x - x_ref))


def mean_squared_error(x, x_ref):
    return sum_of_squared_differences(x, x_ref) / x.size


def root_mean_square_error(x, x_ref):
    return jnp.sqrt(mean_squared_error(x, x_ref))


def peak_signal_to_noise_ratio(x, x_ref):
    """``10·log10(max(x_ref)² / MSE)`` (reference: :98-101; +∞ for x==x_ref)."""
    mse = mean_squared_error(x, x_ref)
    return 10.0 * jnp.log10(jnp.max(x_ref) ** 2 / mse)


def normalized_cross_correlation(x, x_ref):
    """NCC with ddof=1 std normalization (reference: :112-120)."""
    xc = x - jnp.mean(x)
    rc = x_ref - jnp.mean(x_ref)
    n = x.size
    std_x = jnp.sqrt(jnp.sum(xc * xc) / (n - 1))
    std_r = jnp.sqrt(jnp.sum(rc * rc) / (n - 1))
    return jnp.sum(xc * rc) / (n * std_x * std_r)


def _uniform_filter(x, win):
    """Mean filter with a ``win``-sized window per axis, valid region only."""
    k = jnp.ones((win,) * x.ndim, dtype=x.dtype) / (win ** x.ndim)
    lhs = x[jnp.newaxis, jnp.newaxis]
    rhs = k[jnp.newaxis, jnp.newaxis]
    sp = "0123456789"[: x.ndim]
    dn = lax.conv_dimension_numbers(
        lhs.shape, rhs.shape, ("NC" + sp, "OI" + sp, "NC" + sp))
    out = lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,) * x.ndim, padding="VALID",
        dimension_numbers=dn, precision=lax.Precision.HIGHEST,
        preferred_element_type=x.dtype)
    return out[0, 0]


def structural_similarity(x, x_ref, data_range=None, win_size=7,
                          K1=0.01, K2=0.03):
    """Mean SSIM over a uniform 7×7 window (Wang et al. 2004).

    Replaces the reference's skimage call
    (nsol/similarity_measures.py:134-136) with an in-graph implementation;
    uses skimage's default uniform window and sample (ddof=1) covariance
    normalization ``cov_norm = NP/(NP-1)``.
    """
    if data_range is None:
        data_range = jnp.max(x_ref) - jnp.min(x_ref)
    NP = win_size ** x.ndim
    cov_norm = NP / (NP - 1.0)
    ux = _uniform_filter(x, win_size)
    uy = _uniform_filter(x_ref, win_size)
    uxx = _uniform_filter(x * x, win_size)
    uyy = _uniform_filter(x_ref * x_ref, win_size)
    uxy = _uniform_filter(x * x_ref, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    num = (2.0 * ux * uy + C1) * (2.0 * vxy + C2)
    den = (ux * ux + uy * uy + C1) * (vx + vy + C2)
    return jnp.mean(num / den)


def _entropy_from_prob(prob):
    p = jnp.where(prob > 0, prob, 1.0)
    return -jnp.sum(jnp.where(prob > 0, prob * jnp.log(p), 0.0))


def shannon_entropy(x, bins=100):
    """H(X) from a ``bins``-bin histogram (reference: :153-164)."""
    hist, _ = jnp.histogram(x.reshape(-1), bins=bins)
    prob = hist / jnp.sum(hist)
    return _entropy_from_prob(prob)


def joint_entropy(x, x_ref, bins=100):
    """H(X,Y) from a 2-D histogram (reference: :181-191)."""
    hist, _, _ = jnp.histogram2d(x.reshape(-1), x_ref.reshape(-1), bins=bins)
    prob = hist / jnp.sum(hist)
    return _entropy_from_prob(prob)


def mutual_information(x, x_ref, bins=100):
    """MI = H(X)+H(Y)−H(X,Y) (reference: :212-217)."""
    return (shannon_entropy(x, bins) + shannon_entropy(x_ref, bins)
            - joint_entropy(x, x_ref, bins))


def normalized_mutual_information(x, x_ref, bins=100):
    """NMI = (H(X)+H(Y))/H(X,Y) (reference: :234-239)."""
    return ((shannon_entropy(x, bins) + shannon_entropy(x_ref, bins))
            / joint_entropy(x, x_ref, bins))


def dice_score(x, x_ref):
    """Dice coefficient for boolean masks (reference: :254-264)."""
    x = x.astype(jnp.float32)
    x_ref = x_ref.astype(jnp.float32)
    return 2.0 * jnp.sum(x * x_ref) / (jnp.sum(x) + jnp.sum(x_ref))


#: Registry mirroring ``SimilarityMeasures.similarity_measures``
#: (reference: nsol/similarity_measures.py:267-277).
SIMILARITY_MEASURES = {
    "SSD": sum_of_squared_differences,
    "MAE": mean_absolute_error,
    "MSE": mean_squared_error,
    "RMSE": root_mean_square_error,
    "PSNR": peak_signal_to_noise_ratio,
    "SSIM": structural_similarity,
    "NCC": normalized_cross_correlation,
    "MI": mutual_information,
    "NMI": normalized_mutual_information,
}

#: NaN map for undefined states (reference: nsol/similarity_measures.py:280-290).
UNDEF = {k: np.nan for k in SIMILARITY_MEASURES}


def get_measure(name):
    return SIMILARITY_MEASURES[name]
