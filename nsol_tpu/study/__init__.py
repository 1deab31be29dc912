"""Parameter-study engine (reference layer L5: grid sweeps, persisted
artifacts, append/resume, study reader — nsol/solver_parameter_study.py,
nsol/reader_parameter_study.py) with a vmapped fast path."""

from nsol_tpu.study.paths import ParameterStudy
from nsol_tpu.study.reader import ReaderParameterStudy
from nsol_tpu.study.engine import (
    SolverParameterStudy, TikhonovLinearSolverParameterStudy,
    ADMMLinearSolverParameterStudy, PrimalDualSolverParameterStudy,
)

__all__ = [
    "ParameterStudy", "ReaderParameterStudy", "SolverParameterStudy",
    "TikhonovLinearSolverParameterStudy", "ADMMLinearSolverParameterStudy",
    "PrimalDualSolverParameterStudy",
]
