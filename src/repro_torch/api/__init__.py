"""``repro_torch.api`` — the port's public front door.

The paper's pipeline is two pluggable stages, a center sampler and an
estimator; this package re-exports what the port has of each so far:

    from repro_torch.api import FalkonRegressor, FitConfig, UniformSampler

    est = FalkonRegressor(kernel="gaussian", sigma=4.0,
                          sampler=UniformSampler(m=10_000, weights="identity",
                                                 replace=False),
                          config=FitConfig(lam=1e-6, iters=20))
    est.fit(x, y)                  # on the card; FitConfig(device="cpu") for the CPU
    yhat = est.predict(x_test)
"""
from ..core.gram import Kernel, make_kernel
from ..core.leverage import CenterSet
from ..families import KernelFamily, kernel_family_names, register_kernel_family
from .estimators import ExactKrr, FalkonRegressor, FitConfig, NystromRegressor
from .samplers import Sampler, UniformSampler, as_generator

__all__ = [
    "Sampler", "as_generator", "UniformSampler",
    "FitConfig", "FalkonRegressor", "NystromRegressor", "ExactKrr",
    "Kernel", "make_kernel", "KernelFamily", "register_kernel_family",
    "kernel_family_names", "CenterSet",
]
