from copula_var.copulas import gaussian, plackett, student
from copula_var.copulas.common import (
    corr_matrix_from_params,
    params_from_corr_matrix,
    is_positive_definite,
)

__all__ = [
    "gaussian",
    "student",
    "plackett",
    "corr_matrix_from_params",
    "params_from_corr_matrix",
    "is_positive_definite",
]
