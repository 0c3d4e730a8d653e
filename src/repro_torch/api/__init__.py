"""``repro_torch.api`` — the port's public front door.

The paper's pipeline is two pluggable stages, a center sampler and an
estimator; this package re-exports what the port has of each so far:

    from repro_torch.api import BlessSampler, FalkonRegressor, FitConfig

    est = FalkonRegressor(kernel="gaussian", sigma=4.0,
                          sampler=BlessSampler(lam=1e-4, m_cap=10_000),
                          config=FitConfig(lam=1e-6, iters=20))
    est.fit(x, y)                  # on the card; FitConfig(device="cpu") for the CPU
    yhat = est.predict(x_test)
"""
from ..core.gram import Kernel, make_kernel
from ..core.leverage import CenterSet
from ..families import KernelFamily, kernel_family_names, register_kernel_family
from .estimators import ExactKrr, FalkonRegressor, FitConfig, NystromRegressor
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

__all__ = [
    "Sampler", "as_generator", "BlessSampler", "BlessRSampler", "UniformSampler",
    "ExactRlsSampler", "RecursiveRlsSampler", "SqueakSampler", "TwoPassSampler",
    "ChenYangSampler",
    "FitConfig", "FalkonRegressor", "NystromRegressor", "ExactKrr",
    "Kernel", "make_kernel", "KernelFamily", "register_kernel_family",
    "kernel_family_names", "CenterSet",
]
