"""The port's fused whole fit (``falkon_fit(fused=)``) against its host loop
and against the reference's fused ``jnp`` fit, on the CPU.

The counterpart of tests/test_fused_fit.py. On the card the fused fit is one
captured CUDA graph per shape bucket (rows padded to a multiple of
``TorchBackend.block``, k >= 2 to a power-of-two column bucket); torch has no
CPU graphs, so on the CPU ``falkon_fit`` takes the host loop and builds no
plan. These tests drive the card's plan directly (``_fused_fit``, its body
run eagerly on the CPU, with 1 024-row buckets): one plan per bucket, new n, lam and bandwidth in a
bucket reusing the plan and taking effect, the padded body against the host
loop and the reference, and the reference's flag rules. The capture itself
is tested in tests/test_torch_cuda.py. The same numpy inputs go through both
packages. Tolerances: 1e-3 relative (prediction or alpha norm), as the
reference's fused-fit tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro_torch.core import (CudaBackend, FalkonModel, TorchBackend, falkon_fit, make_kernel,
                              nystrom_krr)
from repro_torch.core import falkon as falkon_mod
from repro_torch.stream import StreamBackend

KERN = make_kernel("gaussian", sigma=1.5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # one intra-op thread: these small shapes gain nothing from more, and
    # the suite runs several workers side by side on the machine's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(n=500, m=64, seed=0, k=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    y = np.sin(2 * x[:, 0]) + 0.3 * x[:, 1] ** 2
    if k is not None:
        y = np.stack([y * (j + 1) + np.cos(x[:, j]) for j in range(k)], axis=1)
    return torch.from_numpy(x), torch.from_numpy(y.astype(np.float32)), torch.from_numpy(x[:m])


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


#: the plans' backend: 1 024-row blocks, so the tests' few hundred rows pad
#: to one 1 024-row bucket (the card's default block is 8 192)
PLAN_BACKEND = TorchBackend(block=1024)


def _planned(kern, x, y, z, lam, iters, a_diag=None, row_mask=None):
    """The card's fused fit through its bucket's plan, the body run eagerly
    on the CPU: a model with the plan's alpha."""
    a = torch.ones(z.shape[0]) if a_diag is None else a_diag
    alpha, _ = falkon_mod._fused_fit(PLAN_BACKEND, kern, x, y, z, a, lam, row_mask, iters)
    return FalkonModel(centers=z, alpha=alpha, kernel=kern, backend=TorchBackend())


def test_fused_fit_builds_one_plan_per_bucket():
    # m = 48 / iters = 19 are this test's own, so no other test's plan can
    # stand in for the first build
    x, y, z = _problem(m=48)
    t0 = falkon_mod._FUSED_FIT_TRACES
    falkon_fit(KERN, x, y, z, 1e-3, iters=19, backend="torch")  # the CPU builds no plan
    assert falkon_mod._FUSED_FIT_TRACES == t0
    m1 = _planned(KERN, x, y, z, 1e-3, 19)
    assert falkon_mod._FUSED_FIT_TRACES == t0 + 1
    _planned(KERN, x, y, z, 1e-3, 19)
    # another n in the same 1 024-row bucket, another lam, another bandwidth
    fits = {"n": (KERN, x[:400], y[:400], 1e-3), "lam": (KERN, x, y, 1e-4),
            "sigma": (make_kernel("gaussian", sigma=2.5), x, y, 1e-3)}
    for kern, xs, ys, lam in fits.values():
        fused = _planned(kern, xs, ys, z, lam, 19)
        host = falkon_fit(kern, xs, ys, z, lam, iters=19, backend="torch", fused=False)
        assert _rel(fused.predict(x), host.predict(x)) < 1e-3  # the new value took effect
    assert falkon_mod._FUSED_FIT_TRACES == t0 + 1
    _planned(KERN, x, y, z, 1e-3, 18)  # iters is in the key
    assert falkon_mod._FUSED_FIT_TRACES == t0 + 2
    assert m1.alpha.shape == (z.shape[0],)


def test_fused_plan_cache_is_bounded_and_releasable():
    x, y, z = _problem(n=200, m=16)
    falkon_mod.release_fused_plans()
    for iters in range(2, 3 + falkon_mod.MAX_FUSED_PLANS):
        _planned(KERN, x, y, z, 1e-3, iters)
    assert len(falkon_mod._FUSED_PLANS) == falkon_mod.MAX_FUSED_PLANS
    assert 2 not in {key[4] for key in falkon_mod._FUSED_PLANS}  # the least recently used went
    assert falkon_mod.release_fused_plans() == falkon_mod.MAX_FUSED_PLANS
    assert not falkon_mod._FUSED_PLANS


def test_fused_matches_host_path():
    x, y, z = _problem()
    fused = falkon_fit(KERN, x, y, z, 1e-3, iters=25, backend="torch")
    host = falkon_fit(KERN, x, y, z, 1e-3, iters=25, backend="torch", fused=False)
    assert torch.equal(fused.alpha, host.alpha)  # on the CPU the fused fit is the host loop
    assert _rel(_planned(KERN, x, y, z, 1e-3, 25).predict(x), host.predict(x)) < 1e-3


def test_fused_matches_nystrom_solution():
    x, y, z = _problem(n=400)
    ny = nystrom_krr(KERN, x, y, z, 1e-3, backend="torch")
    for fk in (falkon_fit(KERN, x, y, z, 1e-3, iters=40, backend="torch"),
               _planned(KERN, x, y, z, 1e-3, 40)):
        assert _rel(fk.predict(x), ny.predict(x)) < 1e-3


def test_fused_respects_weighted_preconditioner():
    x, y, z = _problem(n=300, m=32)
    a = torch.from_numpy(np.random.default_rng(3).uniform(0.5, 2.0, 32).astype(np.float32))
    fused = _planned(KERN, x, y, z, 1e-3, 25, a_diag=a)
    host = falkon_fit(KERN, x, y, z, 1e-3, a_diag=a, iters=25, backend="torch", fused=False)
    assert _rel(fused.alpha, host.alpha) < 1e-3


def test_fused_flag_validation():
    x, y, z = _problem(n=200, m=16)
    for backend in (CudaBackend(), StreamBackend(inner=TorchBackend()), "sharded", "guarded"):
        with pytest.raises(ValueError, match="graph-safe"):
            falkon_fit(KERN, x, y, z, 1e-3, backend=backend, fused=True)
    with pytest.raises(ValueError, match="callback"):
        falkon_fit(KERN, x, y, z, 1e-3, backend="torch", fused=True,
                   callback=lambda i, m: None)
    # a callback quietly takes the host loop when fused is unset
    seen = []
    falkon_fit(KERN, x, y, z, 1e-3, iters=3, backend="torch",
               callback=lambda i, m: seen.append(i))
    assert seen == [0, 1, 2]


def test_fused_fit_returns_its_own_alpha():
    # a later fit in the bucket must not write into an earlier model
    x, y, z = _problem(n=300, m=32)
    first = _planned(KERN, x, y, z, 1e-3, 10)
    kept = first.alpha.clone()
    _planned(KERN, x, -y, z, 1e-3, 10)
    assert torch.equal(first.alpha, kept)


@pytest.mark.parametrize("k,masked", [(None, True), (3, False), (3, True)],
                         ids=["row_mask", "k3", "k3_row_mask"])
def test_fused_fit_matches_reference_fused_fit(k, masked):
    x, y, z = _problem(n=700, m=80, seed=1, k=k)
    rng = np.random.default_rng(2)
    mask = (rng.random(tuple(y.shape)) > 0.25).astype(np.float32) if masked else None
    ref = jcore.falkon_fit(jcore.make_kernel("gaussian", sigma=1.5), jnp.asarray(x.numpy()),
                           jnp.asarray(y.numpy()), jnp.asarray(z.numpy()), 1e-3, iters=25,
                           backend="jnp", row_mask=None if mask is None else jnp.asarray(mask))
    tmask = None if mask is None else torch.from_numpy(mask)
    t0 = falkon_mod._FUSED_FIT_TRACES
    got = falkon_fit(KERN, x, y, z, 1e-3, iters=25, backend="torch", row_mask=tmask)
    planned = _planned(KERN, x, y, z, 1e-3, 25, row_mask=tmask)
    plan = [p for key, p in falkon_mod._FUSED_PLANS.items()
            if key[:6] == (1024, None if k is None else 4, 80, 6, 25, PLAN_BACKEND)
            and key[7] == masked]
    assert len(plan) == 1 and falkon_mod._FUSED_FIT_TRACES <= t0 + 1
    want = torch.from_numpy(np.array(ref.alpha))
    for alpha in (got.alpha, planned.alpha):
        assert alpha.shape == want.shape and _rel(alpha, want) < 1e-3
    assert got.diagnostics.residuals.shape == np.asarray(ref.diagnostics.residuals).shape
