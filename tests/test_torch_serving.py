"""KRR serving in the port (``repro_torch.serving.krr`` / ``async_krr``,
``repro_torch.testing.faults``) against the reference on the same traffic.

The model is fitted by the reference and carried across as numpy
(``interop.model_from_numpy``), so both packages serve the same centers and
alpha. Tolerances: predictions 1e-4 * max|pred| (the K_nM contraction
tolerance); ``stats``, statuses and swap provenance equal. The async
server's script runs on one ``VirtualClock`` per package: deadlines,
``shed_oldest``, ``QueueFull``, a NaN-tile split-retry, SLO degrade and
recover through ``dispatch.latency(advance=)`` and a probe-rejected
``swap_model``. The multi-output waves test holds the functions that the
reference's red ``test_multi_output_waves_cross_backend[jnp]`` calls, at
1e-4 * max (its 1e-6 absolute bound is not a tolerance of the port).
"""
import dataclasses
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core as jcore
import repro.serving as jserving
from repro.testing import faults as jfaults
from repro_torch import api as tapi
from repro_torch import serving as tserving
from repro_torch.core import health
from repro_torch.interop import model_from_numpy
from repro_torch.testing import faults

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the script at the repo root)

D = 6
KNM_TOL = 1e-4


def _ref_fit(seed, n, m, k=None, lam=1e-3, iters=15):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    y = np.sin(2 * x[:, 0]) + 0.3 * x[:, 1] ** 2
    if k is not None:
        y = np.stack([y, -y, np.cos(x[:, 2])], axis=1)
    kern = jcore.make_kernel("gaussian", sigma=1.5)
    return jcore.falkon_fit(kern, jnp.asarray(x), jnp.asarray(y.astype(np.float32)),
                            jnp.asarray(x[:m]), lam, iters=iters, backend="jnp")


def _port(ref_model):
    return model_from_numpy(np.asarray(ref_model.centers), np.asarray(ref_model.alpha),
                            "gaussian", 1.5, device="cpu")


@pytest.fixture(scope="module")
def models():
    ref = {"model": _ref_fit(0, 400, 48), "fallback": _ref_fit(7, 100, 16, lam=1e-2, iters=5)}
    ref["bad"] = dataclasses.replace(ref["model"], alpha=ref["model"].alpha.at[0].set(jnp.nan))
    port = {"model": _port(ref["model"]), "fallback": _port(ref["fallback"])}
    alpha = port["model"].alpha.clone()
    alpha[0] = float("nan")
    port["bad"] = dataclasses.replace(port["model"], alpha=alpha)
    return ref, port


def _requests(sizes, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((r, D)).astype(np.float32) for r in sizes]


def _close(out, ref, tol=KNM_TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-30))


@pytest.fixture(autouse=True)
def _clean():
    health.clear_events()
    assert not faults.active()
    yield
    assert not faults.active() and not jfaults.active()
    health.clear_events()


def test_pow2_bucket_matches_reference():
    for rows in (1, 2, 3, 63, 64, 65, 1000, 1024, 1025, 4096):
        for mb in (1, 16, 64):
            assert tserving.pow2_bucket(rows, mb) == jserving.pow2_bucket(rows, mb)


def test_api_surface_is_the_references():
    want = ["as_generator" if n == "as_prng_key" else n for n in japi.__all__]
    assert list(tapi.__all__) == want
    assert tapi.KrrServer is tserving.KrrServer and tapi.ServeConfig is tserving.ServeConfig


@pytest.mark.parametrize("max_wave,min_bucket", [(512, 64), (128, 32), (64, 16)])
def test_krr_server_matches_reference(models, max_wave, min_bucket):
    (ref, port), reqs = models, _requests([3, 17, 64, 100, 1, 50, 50, 200, 9])
    out = {}
    for name, pkg, mdl in (("ref", jserving, ref["model"]), ("port", tserving, port["model"])):
        srv = pkg.KrrServer(mdl, max_wave=max_wave, min_bucket=min_bucket)
        rids = [srv.submit(q) for q in reqs]
        preds = srv.flush()
        out[name] = ([np.asarray(preds[r]) for r in rids], srv.stats, srv.pending_rows)
    for got, want in zip(out["port"][0], out["ref"][0]):
        _close(got, want)
    assert out["port"][1] == out["ref"][1] and out["port"][2] == out["ref"][2] == 0
    srv = tserving.KrrServer(port["model"], max_wave=max_wave, min_bucket=min_bucket)
    for q in reqs:  # the direct path on the port's own model
        _close(srv.predict(q), port["model"].predict(torch.from_numpy(q)))


def test_krr_server_validation_and_swaps_match_reference(models):
    ref, port = models
    stats = {}
    for name, pkg, fx, mdl in (("ref", jserving, jfaults, ref), ("port", tserving, faults, port)):
        clk = fx.VirtualClock()
        srv = pkg.KrrServer(mdl["model"], clock=clk)
        for bad in (np.zeros((5,), np.float32), np.zeros((0, D), np.float32),
                    np.zeros((4, D + 2), np.float32)):
            with pytest.raises(ValueError, match=rf"\(r, {D}\)"):
                srv.submit(bad)
        nan = np.zeros((4, D), np.float32)
        nan[1, 2] = np.nan
        with pytest.raises(ValueError, match="non-finite"):
            srv.submit(nan)
        clk.advance(2.0)
        assert srv.swap_model(mdl["fallback"])
        assert not srv.swap_model(mdl["bad"])
        with pytest.raises(ValueError, match="feature dim"):
            srv.swap_model(_dim3(name))
        srv.submit(_requests([9])[0])
        assert srv.pending_rows == 9
        stats[name] = dict(srv.stats)
        srv.reset()
        assert srv.flush() == {} and srv.stats["requests"] == 0
    assert stats["port"] == stats["ref"] and stats["port"]["last_swap"] == 2.0


def _dim3(name):
    """A finite model over 3 features (a caller bug to swap in, not a
    poisoned model)."""
    if name == "ref":
        return jcore.FalkonModel(centers=jnp.ones((4, 3)), alpha=jnp.ones((4,)),
                                 kernel=jcore.make_kernel("gaussian", sigma=1.0))
    return model_from_numpy(np.ones((4, 3), np.float32), np.ones((4,), np.float32),
                            "gaussian", 1.0, device="cpu")


def _async_script(pkg, fx, m):
    """One virtual-clock run of the async server; returns what it observed."""
    clk = fx.VirtualClock()
    srv = pkg.AsyncKrrServer(m["model"], fallback_model=m["fallback"], clock=clk,
                             config=pkg.ServeConfig(max_wave=64, min_bucket=16, max_queue_rows=80,
                                                    overflow="shed_oldest", deadline=1.0,
                                                    slo=0.1, slo_window=4, recover_factor=0.5,
                                                    max_inflight=2))
    reqs = _requests([20] * 6 + [8, 30, 5, 12, 40] + [8] * 13, seed=3)
    rids, degraded = [], []
    for q in reqs[:6]:  # 120 rows against an 80-row cap: the oldest two are shed
        rids.append(srv.submit(q))
    clk.advance(2.0)  # the four left queued pass their deadline
    srv.run_until_idle()
    for q in reqs[6:11]:  # one NaN tile: the first wave fails, its halves are retried
        rids.append(srv.submit(q))
    with fx.fault("gram.nan_tile", times=1):
        srv.run_until_idle()
    for i, cost in enumerate([0.5] * 4 + [0.06] * 4 + [0.01] * 5):  # degrade, hold, recover
        rids.append(srv.submit(reqs[11 + i]))
        with fx.fault("dispatch.latency", seconds=cost, advance=clk.advance):
            srv.run_until_idle()
        degraded.append(srv.degraded)
    swapped = srv.swap_model(m["bad"])  # probe-rejected: the incumbent keeps serving
    rej = pkg.AsyncKrrServer(m["model"], config=pkg.ServeConfig(max_queue_rows=20, min_bucket=16))
    rej.submit(reqs[0][:12])
    with pytest.raises(pkg.QueueFull, match="cap 20"):
        rej.submit(reqs[1][:12])
    stats = dict(srv.stats)
    return {"statuses": [srv.status(r).value for r in rids],
            "versions": [srv._requests[r].model_version for r in rids],
            "results": [None if srv.result(r) is None else np.asarray(srv.result(r))
                        for r in rids],
            "degraded": degraded, "swapped": swapped, "stats": stats,
            "p99": srv.p99_latency()}


def test_async_server_script_matches_reference_request_by_request(models):
    ref, port = models
    from repro.serving import async_krr as jasync

    want = _async_script(jasync, jfaults, ref)
    got = _async_script(types.SimpleNamespace(AsyncKrrServer=tapi.AsyncKrrServer,
                                              ServeConfig=tapi.ServeConfig,
                                              QueueFull=tserving.QueueFull), faults, port)
    assert got["statuses"] == want["statuses"]
    assert got["versions"] == want["versions"]
    assert got["degraded"] == want["degraded"] and got["swapped"] is want["swapped"] is False
    assert got["stats"] == want["stats"] and got["p99"] == want["p99"]
    for a, b in zip(got["results"], want["results"]):
        assert (a is None) == (b is None)
        if a is not None:
            _close(a, b)
    # the script reached every branch it names
    assert {"shed", "expired", "done"} <= set(got["statuses"])
    assert got["stats"]["wave_failures"] == 1 and got["stats"]["splits"] >= 1
    assert got["stats"]["degraded_waves"] >= 1 and got["stats"]["swaps_rejected"] == 1
    assert True in got["degraded"] and got["degraded"][-1] is False


def test_backend_error_script_matches_reference_and_chip_smoke(models):
    ref, port = models
    from repro.serving import async_krr as jasync

    reqs = _requests([8, 8], seed=5)
    want = chip_smoke.backend_error_script(jasync.AsyncKrrServer, jasync.ServeConfig, jfaults,
                                           ref["model"], reqs)
    got = chip_smoke.backend_error_script(tapi.AsyncKrrServer, tapi.ServeConfig, faults,
                                          port["model"], reqs)
    assert got == want
    assert list(got) == list(chip_smoke.BACKEND_ERROR_EXPECTED)


def test_multi_output_waves_match_reference():
    ref_model = _ref_fit(0, 400, 48, k=3, iters=12)
    port_model = _port(ref_model)
    reqs = _requests([3, 40, 100])
    outs = []
    for pkg, mdl in ((jserving, ref_model), (tserving, port_model)):
        srv = pkg.KrrServer(mdl, max_wave=128, min_bucket=32)
        rids = [srv.submit(q) for q in reqs]
        preds = srv.flush()
        outs.append([np.asarray(preds[r]) for r in rids])
    for q, want, got in zip(reqs, *outs):
        assert got.shape == (q.shape[0], 3)
        _close(got, want)
        _close(got, port_model.predict(torch.from_numpy(q)))
        _close(got, np.asarray(ref_model.predict(jnp.asarray(q))))


def test_async_server_predicts_through_an_estimator_and_refuses_an_unfitted_one():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 4)).astype(np.float32)
    est = tapi.FalkonRegressor(sampler=tapi.UniformSampler(m=32),
                               config=tapi.FitConfig(lam=1e-4, iters=10, device="cpu"))
    with pytest.raises(ValueError, match="call .fit"):
        tapi.AsyncKrrServer(est)
    est.fit(x, np.sin(x[:, 0]))
    srv = tapi.AsyncKrrServer(est, config=tapi.ServeConfig(min_bucket=16))
    rid = srv.submit(x[:9])
    srv.run_until_idle()
    _close(srv.result(rid), est.predict(x[:9]))
    with pytest.raises(ValueError, match="exceed max_wave"):
        tapi.AsyncKrrServer(est, config=tapi.ServeConfig(max_wave=8)).submit(x[:9])


def test_a_model_without_a_backend_serves_on_the_card_only(models):
    _, port = models
    mdl = dataclasses.replace(port["model"], backend=None)  # the default: the card
    srv = tapi.KrrServer(mdl)
    srv.submit(_requests([4])[0])
    with pytest.raises(RuntimeError, match="no backend is chosen by default"):
        srv.flush()


def test_fault_registry_and_corrupt_never_write_the_callers_tensor():
    with pytest.raises(ValueError, match="unknown fault point"):
        with faults.fault("gram.nan_tlie"):
            pass
    with faults.fault("backend.error", times=2) as f:
        with pytest.raises(RuntimeError, match="already armed"):
            with faults.fault("backend.error"):
                pass
        for _ in range(2):
            with pytest.raises(faults.FaultInjected):
                faults.raise_if()
        faults.raise_if()
        assert f.fired == 2 and f.exhausted
    x = torch.ones((4, 3))
    k = torch.eye(3) * 2.0
    with faults.fault("online.corrupt_row", row=2), faults.fault("kmm.indefinite"), \
            faults.fault("gram.nan_tile", rows=2):
        bad = faults.corrupt("online.corrupt_row", x)
        assert bool(torch.isnan(bad[2]).all()) and int(torch.isnan(bad).sum()) == 3
        assert float(torch.linalg.eigvalsh(faults.corrupt("kmm.indefinite", k)).max()) < 0
        assert int(torch.isnan(faults.corrupt("gram.nan_tile", x)).sum()) == 6
    assert torch.equal(x, torch.ones((4, 3))) and torch.equal(k, torch.eye(3) * 2.0)
    clk = faults.VirtualClock()
    with faults.fault("dispatch.latency", seconds=lambda r, c: r * 0.5, advance=clk.advance):
        faults.sleep_if(rows=3, centers=1)
    assert clk() == 1.5
    with pytest.raises(ValueError, match="backwards"):
        clk.advance(-1.0)


def test_faulty_backend_hooks_every_dispatch(models):
    _, port = models
    from repro_torch.core import TorchBackend

    fb = faults.FaultyBackend(TorchBackend())
    mdl, x = port["model"], torch.from_numpy(_requests([6])[0])
    want = mdl.predict(x)
    assert torch.equal(mdl.predict(x, backend=fb), want)
    with faults.fault("backend.error", times=1):
        with pytest.raises(faults.FaultInjected):
            mdl.predict(x, backend=fb)
    assert fb.block == TorchBackend().block  # unknown attributes delegate


def test_nystrom_hosts_the_indefinite_kmm_point():
    from repro_torch.core import nystrom_krr, make_kernel

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((200, 4)).astype(np.float32))
    kern = make_kernel("gaussian", sigma=1.5)
    with faults.fault("kmm.indefinite", shift=50.0) as f:
        try:
            m = nystrom_krr(kern, x, torch.sin(x[:, 0]), x[:20], 1e-3, backend="torch")
        except health.HealthError:
            m = None
    assert f.fired == 1
    assert m is None or bool(torch.all(torch.isfinite(m.alpha)))


def test_chip_smoke_phase_12_rehearses_on_the_cpu():
    # phase 12 at a tiny size on phase 4's and phase 5's tiny outputs: every
    # gate runs (the durable fit is killed at its third barrier: 12 chunks)
    res = chip_smoke.end_to_end("cpu", n_train=1536, n_test=512, m=120, iters=10,
                                refit_rows=1024, referee_rows=256)
    tensors = res.pop("tensors")
    bless_t = chip_smoke.bless_end_to_end("cpu", tensors, lam_bless=1e-2, m_cap=400,
                                          score_rows=256).pop("tensors")
    krr = chip_smoke.krr_online("cpu", tensors, bless_t, requests=64, max_wave=256,
                                min_bucket=16, chunk=128, online_rows=1024, appends=4,
                                append_rows=128)
    assert krr["serve"]["dispatches"] == krr["async"]["dispatches"] >= 2
    assert krr["durable"]["bit_identical"] and krr["durable"]["resumed_from_step"] == 8
    assert krr["online"]["nan_rejected"] and krr["online"]["nan_state_untouched"]
    assert krr["stream"]["n_chunks"] == 12 and krr["stream"]["peak_bytes_above_base"] is None
    assert set(krr["referee"]) >= {"k2_fit", "stream", "durable", "online"}
    assert sum(krr["launches"].values()) == 0  # the CPU runs the plain versions
