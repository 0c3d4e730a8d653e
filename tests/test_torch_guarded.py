"""The port's opt-in ``GuardedBackend`` against the reference, on the CPU.

The counterpart of tests/test_chaos.py's three guarded-backend tests, with
``FaultyBackend(TorchBackend())`` as the dying primary: every fallback is a
``backend_fallback`` health event and a warning, the results equal the
fallback's, and a whole fit through a dying primary agrees with the
reference's clean ``jnp`` fit on the same numpy inputs (5e-3, the reference
test's tolerance: the guarded fit takes the host loop, the clean one the
fused solve). No default picks the guard.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro_torch.core import (CudaBackend, TorchBackend, backend_names, falkon_fit, health,
                              make_kernel, resolve_backend)
from repro_torch.core.backend import GuardedBackend
from repro_torch.testing import faults

KERN = make_kernel("gaussian", sigma=1.5)
JKERN = jcore.make_kernel("gaussian", sigma=1.5)


@pytest.fixture(autouse=True)
def _clean_events():
    health.clear_events()
    yield
    health.clear_events()


def _x(n, d, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def test_guarded_backend_falls_back_per_dispatch():
    gb = GuardedBackend(primary=faults.FaultyBackend(TorchBackend()), fallback=TorchBackend())
    x = _x(64, 3)
    xt, z, v = torch.from_numpy(x), torch.from_numpy(x[:16]), torch.ones(16)
    with faults.fault("backend.error"):
        with pytest.warns(RuntimeWarning, match="falling back to torch"):
            g = gb.gram_block(KERN, xt, z)
        mv = gb.knm_matvec(KERN, xt, z, v)
    ref = jcore.JnpBackend()
    np.testing.assert_allclose(g.numpy(), ref.gram_block(JKERN, jnp.asarray(x), jnp.asarray(x[:16])),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(mv.numpy(), ref.knm_matvec(JKERN, jnp.asarray(x), jnp.asarray(x[:16]),
                                                          jnp.ones(16)), rtol=1e-5)
    evts = health.events("backend_fallback")
    assert len(evts) == 2 and {e["method"] for e in evts} == {"gram_block", "knm_matvec"}
    assert {(e["primary"], e["fallback"]) for e in evts} == {("faulty", "torch")}


def test_guarded_backend_fit_survives_dying_primary():
    x = _x(200, 4)
    y = np.sin(2 * x[:, 0]).astype(np.float32)
    clean = jcore.falkon_fit(JKERN, jnp.asarray(x), jnp.asarray(y), jnp.asarray(x[:24]), 1e-3,
                             iters=8, backend="jnp")
    gb = GuardedBackend(primary=faults.FaultyBackend(TorchBackend()), fallback=TorchBackend())
    xt = torch.from_numpy(x)
    with faults.fault("backend.error"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        m = falkon_fit(KERN, xt, torch.from_numpy(y), xt[:24], 1e-3, iters=8, backend=gb)
    pred = m.predict(xt[:16], backend="torch")
    np.testing.assert_allclose(pred.numpy(), clean.predict(jnp.asarray(x[:16])), rtol=5e-3, atol=5e-3)
    assert health.events("backend_fallback")


def test_guarded_backend_happy_path_uses_primary():
    gb = GuardedBackend(primary=TorchBackend(), fallback=TorchBackend())
    x = torch.from_numpy(_x(32, 3))
    out = gb.gram_block(KERN, x, x[:8])
    assert out.shape == (32, 8) and torch.equal(out, TorchBackend().gram_block(KERN, x, x[:8]))
    assert health.events("backend_fallback") == []


def test_guarded_quadratic_op_falls_back_for_the_failing_call_only():
    gb = GuardedBackend(primary=faults.FaultyBackend(TorchBackend()), fallback=TorchBackend())
    x = torch.from_numpy(_x(300, 5))
    z, v = x[:20], torch.randn(20, generator=torch.Generator().manual_seed(0))
    op, want = gb.knm_quadratic(KERN, x, z), TorchBackend().knm_quadratic(KERN, x, z)(v)
    with faults.fault("backend.error", skip=1, times=1), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        outs = [op(v) for _ in range(3)]
    assert all(torch.equal(o, want) for o in outs)
    assert [e["method"] for e in health.events("backend_fallback")] == ["knm_quadratic"]


def test_guard_is_registered_opt_in_and_not_graph_safe():
    assert {"cuda", "guarded", "sharded", "stream", "torch"} <= set(backend_names())
    gb = resolve_backend("guarded")
    assert isinstance(gb, GuardedBackend) and gb.primary == CudaBackend()
    assert gb.fallback == TorchBackend() and not gb.graph_safe
    with pytest.raises(RuntimeError, match="CPU"):  # no default, the guard included, on the CPU
        resolve_backend(None, device="cpu")
