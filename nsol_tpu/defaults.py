"""Global constants and dtype policy.

Mirrors the role of the reference's ``nsol/definitions.py`` (EPS=1e-10, study
file extension, allowed I/O extensions, noise types) while adding the
accelerator dtype policy: the library computes in the dtype of its inputs,
defaulting to float32 on the accelerator; tests run on CPU with ``jax_enable_x64`` for the 1e-10
adjointness tolerances of the reference test-suite
(reference: nsol/definitions.py:6-17, tests/kernels_test.py:22).
"""

import numpy as np

EPS = 1e-10

#: File extension used for parameter-study text artifacts
#: (reference: nsol/definitions.py:14).
STUDY_FILE_EXTENSION = "txt"

#: Allowed input data extensions (reference: nsol/definitions.py:15).
ALLOWED_INPUT_EXTENSIONS = ("mat", "png", "nii", "nii.gz")

#: Supported noise corruption types (reference: nsol/definitions.py:16).
ALLOWED_NOISE_TYPES = ("gaussian", "poisson", "uniform", "salt_and_pepper")


def default_dtype():
    """Return the library default floating dtype.

    float64 when JAX x64 mode is enabled (CPU test configuration), float32
    otherwise (accelerator production configuration).
    """
    import jax

    return np.float64 if jax.config.jax_enable_x64 else np.float32
