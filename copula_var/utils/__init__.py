from copula_var.utils.artifacts import load_artifacts, save_artifacts
from copula_var.utils.profiling import StageTimer, trace_to

__all__ = ["save_artifacts", "load_artifacts", "StageTimer", "trace_to"]
