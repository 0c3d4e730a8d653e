"""Roofline terms on the H100, and a meter of the bytes a run's collectives move.

The port of ``repro.launch.hlo_analysis``. The reference parses a compiled
XLA program: ``_shape_bytes`` and ``collective_bytes`` read each
collective's shape from the post-SPMD HLO text and multiply by while-loop
trip counts. PyTorch runs eagerly and compiles no such program, so they have
no counterpart here. ``CollectiveMeter`` counts instead what a run really
sends: inside its ``with`` block every ``torch.distributed`` collective and
point-to-point the port issues adds its bytes, under the reference's names.

``Roofline`` keeps the reference's fields, properties and ``row()``, with
the card's peaks: NVIDIA's H100 SXM data sheet at the 700 W limit, dense
bf16 on the tensor cores, HBM3, and NVLink to the other cards of a host
(450 GB/s each way; across hosts a collective runs at the network's rate,
which no run here measured). ``PEAK_FP32_FLOPS`` (fp32 outside the tensor
cores) is the rate ``chip_smoke.bound`` holds the fp32 kernels to. Collective
bytes that were not measured are None: their time and the collective term
of the bottleneck are then None too, never 0.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

PEAK_FLOPS = 989e12  # bf16 dense, tensor cores
PEAK_FP32_FLOPS = 67e12  # fp32, outside the tensor cores
HBM_BW = 3.35e12  # B/s
NVLINK_BW = 450e9  # B/s each way

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sum_bytes(ts) -> int:
    return sum(_bytes(t) for t in ts)


class CollectiveMeter:
    """Per-rank bytes of the collectives issued inside the ``with`` block.

    Counted as the reference counts an HLO collective, by its result on
    this rank: all-reduce the tensor, all-gather the gathered output,
    reduce-scatter the rank's shard, all-to-all the output, and
    collective-permute (``send`` and the sends of ``batch_isend_irecv``,
    the pipeline's shift) what the rank hands on. ``broadcast`` is kept
    under its own name. The meter wraps the functions of the
    ``torch.distributed`` namespace for the block's duration (the whole
    process sees them, and one meter is active at a time); ``isend`` and
    ``irecv`` stay unwrapped, as ``P2POp`` checks that it holds them, and
    are counted through ``batch_isend_irecv``.
    """

    _active: Optional["CollectiveMeter"] = None

    def __init__(self):
        self.bytes: dict[str, int] = {k: 0 for k in COLLECTIVES + ("broadcast",)}
        self.calls: dict[str, int] = dict.fromkeys(self.bytes, 0)
        self._saved: dict[str, Any] = {}

    def _add(self, kind: str, n: int) -> None:
        self.bytes[kind] += n
        self.calls[kind] += 1

    @property
    def total(self) -> int:
        return sum(self.bytes.values())

    def _wrappers(self) -> dict:
        def wrap(name, kind, count):
            real = getattr(dist, name)

            def fn(*args, **kwargs):
                self._add(kind, count(*args, **kwargs))
                return real(*args, **kwargs)

            fn.__name__ = name
            return fn

        def sends(ops, *_, **__):
            return sum(_bytes(op.tensor) for op in ops if op.op.__name__ == "isend")

        return {
            "all_reduce": wrap("all_reduce", "all-reduce", lambda t, *a, **k: _bytes(t)),
            "all_gather": wrap("all_gather", "all-gather", lambda out, t, *a, **k: _sum_bytes(out)),
            "all_gather_into_tensor": wrap("all_gather_into_tensor", "all-gather",
                                           lambda out, t, *a, **k: _bytes(out)),
            "reduce_scatter": wrap("reduce_scatter", "reduce-scatter",
                                   lambda out, ts, *a, **k: _bytes(out)),
            "reduce_scatter_tensor": wrap("reduce_scatter_tensor", "reduce-scatter",
                                          lambda out, t, *a, **k: _bytes(out)),
            "all_to_all": wrap("all_to_all", "all-to-all",
                               lambda outs, ins, *a, **k: _sum_bytes(outs)),
            "all_to_all_single": wrap("all_to_all_single", "all-to-all",
                                      lambda out, t, *a, **k: _bytes(out)),
            "send": wrap("send", "collective-permute", lambda t, *a, **k: _bytes(t)),
            "batch_isend_irecv": wrap("batch_isend_irecv", "collective-permute", sends),
            "broadcast": wrap("broadcast", "broadcast", lambda t, *a, **k: _bytes(t)),
        }

    def __enter__(self) -> "CollectiveMeter":
        if CollectiveMeter._active is not None:
            raise RuntimeError("a CollectiveMeter is already active")
        for name, fn in self._wrappers().items():
            self._saved[name] = getattr(dist, name)
            setattr(dist, name, fn)
        CollectiveMeter._active = self
        return self

    def __exit__(self, *exc) -> None:
        for name, fn in self._saved.items():
            setattr(dist, name, fn)
        self._saved.clear()
        CollectiveMeter._active = None


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float  # analytic (cost_model)
    bytes_per_device: float  # analytic HBM traffic
    coll_bytes_per_device: Optional[float]  # CollectiveMeter; None = not measured
    coll_breakdown: Optional[dict[str, int]]
    peak_memory_per_device: float
    model_flops: float  # 6*N*D (dense) / 6*N_active*D (MoE); 2*N*D serve

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> Optional[float]:
        if self.coll_bytes_per_device is None:
            return None
        return self.coll_bytes_per_device / NVLINK_BW

    def _terms(self) -> dict[str, float]:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        t_useful = (self.model_flops / self.chips) / PEAK_FLOPS
        t_bound = max(self._terms().values())
        return t_useful / t_bound if t_bound else 0.0

    def row(self) -> dict[str, Any]:
        coll = self.coll_breakdown
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "hlo_flops_per_dev": self.flops_per_device,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_mem_gb": self.peak_memory_per_device / 2**30,
            "coll_gb": (None if coll is None else
                        {k: round(v / 2**30, 4) for k, v in coll.items() if v}),
        }
