"""Carry the JAX side's state across, as numpy arrays.

``center_set_from_numpy`` turns a center set of the JAX package (its
``CenterSet`` fields) into the port's, so a JAX-sampled set can be fitted by
the port; ``bless_result_from_numpy`` does the same for every level of a
BLESS ladder, so both packages can score identical center sets;
``model_from_numpy`` turns a fitted JAX ``FalkonModel`` (its
centers, coefficients, kernel parameters and fit metadata) into the port's,
so a JAX fit can be predicted by the port; ``lm_params_from_numpy`` turns
the reference LM's parameter pytree into the ``state_dict`` of the port's
``LM``. None imports anything of JAX: the caller converts with
``numpy.asarray`` (``jax.tree.map(np.asarray, params)`` for a pytree).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.backend import backend_for_device
from .core.bless import BlessLevel, BlessResult
from .core.falkon import FalkonModel
from .core.gram import make_kernel
from .core.leverage import CenterSet
from .models.config import ArchConfig


def center_set_from_numpy(idx, weight, mask, count) -> CenterSet:
    """A ``CenterSet`` (on the CPU) from the reference's idx / weight / mask /
    count arrays; the estimators move it to the data's device."""
    return CenterSet(
        idx=torch.tensor(np.asarray(idx), dtype=torch.int64),
        weight=torch.tensor(np.asarray(weight), dtype=torch.float32),
        mask=torch.tensor(np.asarray(mask), dtype=torch.bool),
        count=torch.as_tensor(int(np.asarray(count)), dtype=torch.int64),
    )


def bless_result_from_numpy(levels, lam_path) -> BlessResult:
    """A ``BlessResult`` (center sets on the CPU) from the reference's levels,
    each given as (lam, idx, weight, mask, count, d_h, m_h, r_h) with the
    four ``CenterSet`` fields as numpy arrays."""
    return BlessResult(
        levels=[BlessLevel(lam=float(lam), centers=center_set_from_numpy(idx, weight, mask, count),
                           d_h=float(d_h), m_h=int(m_h), r_h=int(r_h))
                for lam, idx, weight, mask, count, d_h, m_h, r_h in levels],
        lam_path=[float(v) for v in lam_path])


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


def _tensor(a) -> torch.Tensor:
    """A CPU tensor of numpy array ``a``, dtype kept (ml_dtypes bfloat16 too)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def lm_params_from_numpy(cfg: ArchConfig, params: dict) -> dict[str, torch.Tensor]:
    """The port's ``LM(cfg).state_dict()`` (CPU tensors, dtypes kept) from the
    reference's ``init_params(cfg, key)`` pytree given as numpy arrays.

    The reference stacks each period position j over groups
    (``blocks/blk{j}``, leading axis g); layer ``g * period + j`` of the port
    gets slice g. Every other leaf comes across one to one: the port builds
    attention with the reference's padded heads (``models.model``), so the
    padded ``wq`` / ``wk`` / ``wv`` columns and ``wo`` rows are its own,
    for every configuration (ROADMAP C.2c).
    """
    out: dict[str, torch.Tensor] = {}

    def put(path: tuple[str, ...], tree) -> None:
        if isinstance(tree, dict):
            for key, val in tree.items():
                put(path + (key,), val)
            return
        for g, name in enumerate(lm_param_names(cfg, path)):
            out[name] = _tensor(np.asarray(tree)[g] if path[0] == "blocks" else tree)

    for name in ("final_norm", "embed", "out_head", "blocks"):
        if name in params:
            put((name,), params[name])
    return out


def lm_param_names(cfg: ArchConfig, path: tuple[str, ...]) -> list[str]:
    """The port's ``LM(cfg).state_dict()`` names of the reference's leaf at
    ``path`` (its keys in ``init_params``' pytree): for a stacked
    ``blocks/blk{j}/...`` leaf one per group g, layer ``g * period + j``;
    else the path joined by dots."""
    if path[0] != "blocks":
        return [".".join(path)]
    j = int(path[1].removeprefix("blk"))
    rest = ".".join(path[2:])
    return [f"layers.{g * cfg.layer_period + j}.{rest}" for g in range(cfg.n_groups)]
