"""nsol_tpu — proximal-splitting solver library in JAX.

A from-scratch JAX/XLA framework covering the problem class of the NSoL
reference (L1/L2 denoising and robust L2 deconvolution of 1D/2D/3D image
data with TK0/TK1/TV/Huber regularizers and robust data losses, solved by
Chambolle–Pock primal-dual, ADMM, and Tikhonov/CG), re-architected for an
accelerator: shaped arrays, scan-based solver loops, vmapped parameter
sweeps, and mesh-sharded volumes with halo exchange.
"""

from nsol_tpu.__about__ import __version__  # noqa: F401
