from copula_var.parallel.mesh import make_mesh
from copula_var.parallel.quadrature import (
    sharded_msm_step,
    sharded_garch_step,
    sharded_cached_step,
    sharded_bisection_solve,
    sharded_bisection_solve_levels,
    grid_sharded_garch_integrals,
    grid_sharded_msm_integrals,
    pad_days,
)

__all__ = [
    "make_mesh",
    "sharded_msm_step",
    "sharded_garch_step",
    "sharded_cached_step",
    "sharded_bisection_solve",
    "sharded_bisection_solve_levels",
    "grid_sharded_garch_integrals",
    "grid_sharded_msm_integrals",
    "pad_days",
]
