from copula_var.ops.special import (
    norm_pdf,
    norm_cdf,
    norm_ppf,
    t_pdf,
    t_cdf,
    t_sf,
    t_ppf,
)
from copula_var.ops.grids import (
    nonuniform_grid,
    msm_grid,
    garch_grid,
    GridSpecKind,
)

__all__ = [
    "norm_pdf",
    "norm_cdf",
    "norm_ppf",
    "t_pdf",
    "t_cdf",
    "t_sf",
    "t_ppf",
    "nonuniform_grid",
    "msm_grid",
    "garch_grid",
    "GridSpecKind",
]
