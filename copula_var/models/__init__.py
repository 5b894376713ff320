from copula_var.models import garch, msm, ukf

__all__ = ["garch", "msm", "ukf"]
