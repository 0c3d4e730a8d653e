"""Carry the JAX side's state across, as numpy arrays.

``center_set_from_numpy`` turns a center set of the JAX package (its
``CenterSet`` fields) into the port's, so a JAX-sampled set can be fitted by
the port; ``model_from_numpy`` turns a fitted JAX ``FalkonModel`` (its
centers, coefficients, kernel parameters and fit metadata) into the port's,
so a JAX fit can be predicted by the port. Neither imports anything of JAX:
the caller converts with ``numpy.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.backend import backend_for_device
from .core.falkon import FalkonModel
from .core.gram import make_kernel
from .core.leverage import CenterSet


def center_set_from_numpy(idx, weight, mask, count) -> CenterSet:
    """A ``CenterSet`` (on the CPU) from the reference's idx / weight / mask /
    count arrays; the estimators move it to the data's device."""
    return CenterSet(
        idx=torch.tensor(np.asarray(idx), dtype=torch.int64),
        weight=torch.tensor(np.asarray(weight), dtype=torch.float32),
        mask=torch.tensor(np.asarray(mask), dtype=torch.bool),
        count=torch.as_tensor(int(np.asarray(count)), dtype=torch.int64),
    )


def model_from_numpy(centers, alpha, kernel_name: str, sigma: float, kappa_sq: float = 1.0,
                     lam: float | None = None, n_train: int | None = None, a_diag=None, *,
                     device: str = "cuda") -> FalkonModel:
    """A ``FalkonModel`` on ``device`` from a reference model's arrays.

    ``device`` defaults to the card (raising if none is present); "cpu"
    gives a model that predicts through ``TorchBackend``.
    """
    backend = backend_for_device(device)

    def t(a):
        return None if a is None else torch.tensor(np.asarray(a), dtype=torch.float32,
                                                      device=device)

    return FalkonModel(centers=t(centers), alpha=t(alpha),
                       kernel=make_kernel(kernel_name, sigma=float(sigma),
                                          kappa_sq=float(kappa_sq)),
                       backend=backend, lam=None if lam is None else float(lam),
                       n_train=None if n_train is None else int(n_train), a_diag=t(a_diag))
