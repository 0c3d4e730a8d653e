"""``repro_torch.api`` — the port's public front door.

The paper's pipeline is three pluggable stages: a center sampler, an
estimator (regression or one-vs-rest classification), and exact k-fold
model selection over the regularization grid:

    from repro_torch.api import BlessSampler, FalkonRegressor, FitConfig, KFoldSweep

    est = FalkonRegressor(kernel="gaussian", sigma=4.0,
                          sampler=BlessSampler(lam=1e-4, m_cap=10_000),
                          config=FitConfig(lam=1e-6, iters=20))
    est.fit(x, y)                  # on the card; FitConfig(device="cpu") for the CPU
    yhat = est.predict(x_test)

    res = KFoldSweep(kernel="gaussian", sigma=4.0, lams=(1e-5, 1e-6, 1e-7),
                     folds=5).run(x, y)    # one masked multi-RHS solve per lambda
    best = res.best_lam
"""
from ..core.gram import Kernel, make_kernel
from ..core.leverage import CenterSet
from ..families import KernelFamily, kernel_family_names, register_kernel_family
from .estimators import ExactKrr, FalkonClassifier, FalkonRegressor, FitConfig, NystromRegressor
from .samplers import (
    BlessRSampler,
    BlessSampler,
    ChenYangSampler,
    ExactRlsSampler,
    RecursiveRlsSampler,
    Sampler,
    SqueakSampler,
    TwoPassSampler,
    UniformSampler,
    as_generator,
)
from .sweep import KFoldResult, KFoldSweep

__all__ = [
    "Sampler", "as_generator", "BlessSampler", "BlessRSampler", "UniformSampler",
    "ExactRlsSampler", "RecursiveRlsSampler", "SqueakSampler", "TwoPassSampler",
    "ChenYangSampler",
    "FitConfig", "FalkonRegressor", "FalkonClassifier", "NystromRegressor", "ExactKrr",
    "KFoldSweep", "KFoldResult",
    "Kernel", "make_kernel", "KernelFamily", "register_kernel_family",
    "kernel_family_names", "CenterSet",
]
