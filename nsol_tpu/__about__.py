__title__ = "nsol_tpu"
__version__ = "0.1.0"
__summary__ = (
    "Proximal-splitting solver library for L1/L2 denoising and robust L2 "
    "deconvolution of 1D/2D/3D image data (JAX/XLA)."
)
__license__ = "BSD-3-Clause"
