"""Typed configuration covering the reference's complete knob surface.

The reference has no config system — constants live in `main.py:25-50`,
constructor defaults (`utils/calc_var_class.py:9-20,95,111-112,201-202`),
and optimizer hyperparameters (`markov_switching_multifractal/opti.py:9-23`,
`garch/opti.py:8-18`, `kalman_mean_reverting/optimize.py:7-26`,
`copulas/student/opti.py:9`). This module collects exactly those knobs
into dataclasses with the reference's defaults, plus `run_backtest` — the
config-driven equivalent of the reference's `main.py` pipeline.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclass
class MsmConfig:
    """`opti.py:9-23,113` + `main.py:69` (k=4)."""

    k: int = 4
    basin_iter: int = 100
    step_size: float = 0.2
    b_grid: Tuple[float, float, int] = (1.0, 50.0, 10)
    m0_bounds: Tuple[float, float] = (0.2, 0.8)
    b_bounds: Tuple[float, float] = (1.0, 50.0)
    gamma_bounds: Tuple[float, float] = (0.05, 0.95)
    gamma_weight: float = 0.0
    b_weight: float = 0.0
    seed: int = 0
    # reproduce the reference's min-LL start-selection defect
    reference_quirks: bool = False


@dataclass
class GarchConfig:
    """`garch/opti.py:8-18`."""

    p_max: int = 3
    q_max: int = 3
    newton_tol: float = 1e-10
    newton_max_iter: int = 1000
    fd_epsilon: float = 1e-5  # also the positivity floor base
    # reproduce the reference's FD-Newton optimizer trajectory
    reference_quirks: bool = False


@dataclass
class MeanRevertingConfig:
    """`kalman_mean_reverting/optimize.py:7-26` + the fixed init
    (`mean_reverting_estimation.py:41-47`)."""

    a0: float = 0.99
    l0: float = 0.5
    q0: float = 0.1
    em_max_iter: int = 1000
    em_tol: float = 1e-6
    perturb_scale: float = 0.05
    restart_attempts: int = 5
    seed: int = 0
    # reproduce the reference's frozen-a EM M-step defect
    reference_quirks: bool = False


@dataclass
class CopulaConfig:
    """`student/opti.py:9`, `plackett/opti.py:66`, shared tol/maxiter."""

    nu_grid: Tuple[float, float, int] = (2.1, 30.0, 10)
    nu_bounds: Tuple[float, float] = (2.01, 50.0)
    theta_grid: Tuple[float, float, int] = (0.5, 50.0, 10)
    tol: float = 1e-9
    max_iter: int = 5000


@dataclass
class SolverConfig:
    """`calc_var_class.py:95,111-112,201-202` + tol at `:256`."""

    obj_var: float = 0.05
    # when set, solve the whole confidence ladder in one batched program
    # (`VaRBacktest.calc_var_levels`) instead of the single obj_var
    obj_levels: Optional[Tuple[float, ...]] = None
    first_guess: float = -3.0
    second_guess: Tuple[float, float] = (-3.5, -2.0)
    min_var_value: float = -7.5
    max_var_value: float = 0.0
    box: Tuple[float, float] = (-5.0, 5.0)
    tolerance: float = 1e-6


@dataclass
class BacktestConfig:
    """Top-level run config (`main.py:25-50` + `calc_var_class.py:9-20`)."""

    estimation_type: str = "garch"  # 'msm' | 'garch' | 'mean_reverting'
    copula_type: str = "student"  # 'gaussian' | 'student' | 'plackett'
    n_insample: int = 1135
    num_points: int = 100
    # 'xla' (f64-capable) | 'pallas' (fused f32 GPU kernel, dim 2) |
    # 'sharded' (day-sharded SPMD over the device mesh, any dim) |
    # 'sharded_pallas' (shard_map of the fused kernel over the mesh) |
    # 'grid_sharded' (outer grid dim sharded, psum partials across the
    # mesh — scales ONE huge integral across devices)
    engine: str = "xla"
    # engine='sharded'/'sharded_pallas'/'grid_sharded': mesh size
    # (None = all devices)
    n_mesh_devices: Optional[int] = None
    weights: Optional[Sequence[float]] = None  # default equal weights
    msm: MsmConfig = field(default_factory=MsmConfig)
    garch: GarchConfig = field(default_factory=GarchConfig)
    mean_reverting: MeanRevertingConfig = field(default_factory=MeanRevertingConfig)
    copula: CopulaConfig = field(default_factory=CopulaConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "BacktestConfig":
        d = dict(d)
        for name, sub in (
            ("msm", MsmConfig),
            ("garch", GarchConfig),
            ("mean_reverting", MeanRevertingConfig),
            ("copula", CopulaConfig),
            ("solver", SolverConfig),
        ):
            if name in d and isinstance(d[name], dict):
                d[name] = sub(**d[name])
        return cls(**d)


def adapter_kwargs(cfg: BacktestConfig) -> dict:
    """Map the config onto the factory's adapter kwargs (every knob)."""
    if cfg.estimation_type == "msm":
        m = cfg.msm
        return dict(
            k=m.k, basin_iter=m.basin_iter, seed=m.seed,
            step_size=m.step_size,
            b_values=np.linspace(*m.b_grid[:2], int(m.b_grid[2])),
            gamma_weight=m.gamma_weight, b_weight=m.b_weight,
            bounds=np.array([m.m0_bounds, m.b_bounds, m.gamma_bounds]),
            reference_quirks=m.reference_quirks,
        )
    if cfg.estimation_type == "garch":
        g = cfg.garch
        return dict(
            p_max=g.p_max, q_max=g.q_max,
            newton_max_iter=g.newton_max_iter, newton_tol=g.newton_tol,
            eps=g.fd_epsilon, reference_quirks=g.reference_quirks,
        )
    if cfg.estimation_type == "mean_reverting":
        m = cfg.mean_reverting
        return dict(
            em_max_iter=m.em_max_iter, seed=m.seed, a0=m.a0, l0=m.l0,
            q0=m.q0, em_tol=m.em_tol, perturb_scale=m.perturb_scale,
            restart_attempts=m.restart_attempts,
            reference_quirks=m.reference_quirks,
        )
    raise ValueError(f"Unsupported estimation type: {cfg.estimation_type}")


def copula_fit_kwargs(cfg: BacktestConfig) -> dict:
    """Map CopulaConfig onto the IFM fitter kwargs."""
    c = cfg.copula
    if cfg.copula_type == "student":
        return dict(
            nu_values=np.linspace(*c.nu_grid[:2], int(c.nu_grid[2])),
            nu_bounds=c.nu_bounds, tol=c.tol, max_iter=c.max_iter,
        )
    if cfg.copula_type == "plackett":
        return dict(
            theta_range=np.linspace(*c.theta_grid[:2], int(c.theta_grid[2])),
            tol=c.tol, max_iter=c.max_iter,
        )
    return dict(tol=c.tol, max_iter=c.max_iter)


def run_backtest(data, cfg: BacktestConfig):
    """Config-driven pipeline (the reference `main.py` equivalent):
    builds the backtest via the factory and solves for the VaR series.
    Returns (VaRBacktest, var_series)."""
    from copula_var.backtest import create_var_backtest

    bt = create_var_backtest(
        data,
        cfg.estimation_type,
        cfg.copula_type,
        num_points=cfg.num_points,
        box=cfg.solver.box,
        copula_fit_kwargs=copula_fit_kwargs(cfg),
        engine=cfg.engine,
        **adapter_kwargs(cfg),
    )
    if cfg.n_mesh_devices is not None:
        if cfg.engine == "grid_sharded":
            from copula_var.parallel import make_mesh

            bt.mesh = make_mesh(n_devices=cfg.n_mesh_devices,
                                axis_names=("days", "grid"),
                                shape=(1, cfg.n_mesh_devices))
        elif cfg.engine in ("sharded", "sharded_pallas"):
            from copula_var.parallel import make_mesh

            bt.mesh = make_mesh(n_devices=cfg.n_mesh_devices)
    common = dict(
        first_guess=cfg.solver.first_guess,
        second_guess=cfg.solver.second_guess,
        tolerance=cfg.solver.tolerance,
        min_var_value=cfg.solver.min_var_value,
        max_var_value=cfg.solver.max_var_value,
    )
    if cfg.solver.obj_levels is not None:
        var = bt.calc_var_levels(tuple(cfg.solver.obj_levels), **common)
    else:
        var = bt.calc_var(obj_var=cfg.solver.obj_var, **common)
    return bt, var
