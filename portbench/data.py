"""Synthetic tabular rows of a configuration's shape, made on the device from
the run's seed.

The distribution is ``chip_smoke.make_data``'s, copied: x ~ N(0, I_d) and
y = sign(tanh(x . w + 0.7 sin(2 x_0) x_1) + 0.3 noise) in {-1, +1}. The last
``held_out`` rows are held out for predictions.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Rows:
    x: torch.Tensor  # (n_train, d) fp32
    y: torch.Tensor  # (n_train,) fp32 in {-1, +1}
    x_test: torch.Tensor  # (held_out, d)
    y_test: torch.Tensor  # (held_out,)


def make_rows(rows: int, d: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(x, y) for ``rows`` rows of width ``d`` from one generator on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((rows, d), generator=g, device=device)
    w = torch.randn((d,), generator=g, device=device)
    noise = torch.randn((rows,), generator=g, device=device)
    margin = torch.tanh(x @ w + 0.7 * torch.sin(2 * x[:, 0]) * x[:, 1])
    y = torch.sign(margin + 0.3 * noise)
    return x, torch.where(y == 0, torch.ones_like(y), y)


def make_split(config: dict, seed: int, device) -> Rows:
    """The configuration's rows, the last ``held_out`` of them held out."""
    x, y = make_rows(config["rows"], config["d"], seed, device)
    n = config["rows"] - config["held_out"]
    return Rows(x[:n], y[:n], x[n:], y[n:])
