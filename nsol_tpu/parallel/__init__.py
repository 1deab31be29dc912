"""Distribution layer: device meshes, halo-exchange stencils, psum-reduced
solvers (the reference has no parallelism — SURVEY.md §2; this layer is the
scale-out designed in SURVEY.md §5)."""

from nsol_tpu.parallel.halo import (
    exchange_plane_up, exchange_plane_down, exchange_halo_wrap,
    make_sharded_gradient_operators, make_sharded_blur_operators,
)
from nsol_tpu.parallel.matmul_halo import (
    band_matrix, make_sharded_matmul_blur_operators,
    make_sharded_matmul_normal_blur_operator,
    make_sharded_matmul_gradient_normal,
)
from nsol_tpu.parallel.mesh import (
    make_mesh, make_space_mesh, sharded_tv_admm_solve,
    sharded_tv_denoise_solve,
)
from nsol_tpu.parallel import distributed

__all__ = [
    "distributed",
    "exchange_plane_up", "exchange_plane_down", "exchange_halo_wrap",
    "make_sharded_gradient_operators", "make_sharded_blur_operators",
    "band_matrix", "make_sharded_matmul_blur_operators",
    "make_sharded_matmul_normal_blur_operator",
    "make_sharded_matmul_gradient_normal",
    "make_mesh", "make_space_mesh", "sharded_tv_admm_solve",
    "sharded_tv_denoise_solve",
]
