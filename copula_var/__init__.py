"""copula_var — accelerator-native portfolio-risk kernel library.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference out-of-sample VaR backtester (copula-MSM / copula-GARCH /
copula-UKF): per-asset stochastic-volatility models, copula coupling via
inference-for-margins, joint-density grid quadrature, and a batched
bisection VaR solver — all expressed as fixed-shape tensor programs that
jit/vmap/shard over device meshes (one GPU or several).

Layer map (mirrors the reference's capability surface, re-architected):

  ops/       special functions (normal & Student-t pdf/cdf/ppf), non-uniform
             quadrature grids, the separable masked quadrature engine, and
             batched bisection solvers.
  models/    MSM (Hamilton filter as lax.scan over Kronecker-structured
             transitions), GARCH(p,q) (variance recursion scan), UKF
             mean-reverting log-vol (sigma-point scan) — plus their
             simulators and optimizers.
  copulas/   Gaussian / Student-t / Plackett densities and IFM fitting.
  parallel/  mesh construction and shard_map'd quadrature with psum
             reductions across the mesh.
  data/      returns ingestion (CSV / synthetic / optional yfinance) and
             rolling-window tensor construction.

Top-level: adapters (model -> integration params), backtest orchestrator,
and the 3x3 model-by-copula factory.
"""

from copula_var.version import __version__

__all__ = ["__version__"]
