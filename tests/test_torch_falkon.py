"""The port's slice end to end against the reference, on the CPU.

The same numpy data and the same JAX-sampled center set go through the
reference ``FalkonRegressor`` on ``PallasBackend(interpret=True)`` and through
the port's ``FalkonRegressor(config=FitConfig(device="cpu"))``; predictions
agree to 1e-3 of their largest value (DESIGN.md §10; compared in prediction
space because eigh with rank truncation may keep a different q). A JAX-fitted
model carried across by ``interop.model_from_numpy`` predicts to 1e-4. The
phases of chip_smoke.py are rehearsed here at a tiny size.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core as jcore
from repro_torch import core
from repro_torch.api import (BlessSampler, ExactKrr, FalkonRegressor, FitConfig, NystromRegressor,
                             UniformSampler)
from repro_torch.interop import center_set_from_numpy, model_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the script at the repo root)

CPU = FitConfig(lam=1e-3, iters=30, device="cpu")


def _problem(n=1024, n_test=256, d=6, k=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n + n_test, d)).astype(np.float32)
    y = np.sin(2 * x[:, 0]) + 0.3 * x[:, 1] ** 2
    if k is not None:
        y = np.stack([y * (j + 1) + np.cos(x[:, j]) for j in range(k)], axis=1)
    y = y.astype(np.float32)
    return x[:n], y[:n], x[n:], y[n:]


def _close(out, ref, rel):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("weights,k", [("identity", None), ("nystrom", 3)])
def test_falkon_regressor_matches_reference_on_a_jax_sampled_center_set(weights, k):
    x, y, xte, _ = _problem(k=k)
    cs = japi.UniformSampler(m=96, weights=weights, replace=False).sample(
        jax.random.PRNGKey(0), jnp.asarray(x), jcore.make_kernel("gaussian", sigma=2.0))
    ref = japi.FalkonRegressor(kernel="gaussian", sigma=2.0, sampler=japi.UniformSampler(m=96),
                               config=japi.FitConfig(lam=CPU.lam, iters=CPU.iters,
                                                     backend=jcore.PallasBackend(interpret=True)))
    ref.fit(jnp.asarray(x), jnp.asarray(y), center_set=cs)
    est = FalkonRegressor(kernel="gaussian", sigma=2.0, sampler=UniformSampler(m=96), config=CPU)
    est.fit(x, y, center_set=center_set_from_numpy(*map(np.asarray, cs)))
    _close(est.predict(xte).numpy(), ref.predict(jnp.asarray(xte)), 1e-3)
    np.testing.assert_array_equal(est.centers_.numpy(), np.asarray(ref.centers_))


def test_jax_fitted_model_predicts_through_the_port():
    x, y, xte, _ = _problem(seed=1)
    jm = jcore.falkon_fit(jcore.make_kernel("matern32", sigma=1.5), jnp.asarray(x),
                          jnp.asarray(y), jnp.asarray(x[:80]), 1e-4, iters=10, backend="jnp")
    tm = model_from_numpy(np.asarray(jm.centers), np.asarray(jm.alpha), "matern32", 1.5,
                          lam=jm.lam, n_train=jm.n_train, a_diag=np.asarray(jm.a_diag),
                          device="cpu")
    _close(tm.predict(torch.from_numpy(xte)).numpy(), jm.predict(jnp.asarray(xte)), 1e-4)
    _close(tm.predictive_variance(torch.from_numpy(xte)).numpy(),
           jm.predictive_variance(jnp.asarray(xte), backend="jnp"), 1e-3)


def test_cuda_backend_plumbing_matches_torch_backend_on_cpu_tensors():
    # On CPU tensors CudaBackend runs each kernel's plain version: the whole
    # fit through it must match TorchBackend.
    x, y, xte, _ = _problem(n=700, seed=2)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    kern = core.make_kernel("cauchy", sigma=2.0)
    preds = [core.falkon_fit(kern, xt, yt, xt[:64], 1e-4, iters=10, backend=be)
             .predict(torch.from_numpy(xte), backend=be)
             for be in (core.CudaBackend(), core.TorchBackend())]
    _close(preds[0].numpy(), preds[1].numpy(), 1e-4)


def test_direct_solvers_match_reference():
    x, y, xte, _ = _problem(n=400, seed=3)
    jk, tk = jcore.make_kernel("gaussian", sigma=2.0), core.make_kernel("gaussian", sigma=2.0)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    jn = jcore.nystrom_krr(jk, jnp.asarray(x), jnp.asarray(y), jnp.asarray(x[:50]), 1e-3,
                           backend="jnp")
    tn = core.nystrom_krr(tk, xt, yt, xt[:50], 1e-3, backend="torch")
    _close(tn.predict(torch.from_numpy(xte)).numpy(), jn.predict(jnp.asarray(xte)), 1e-3)
    je = jcore.exact_krr(jk, jnp.asarray(x), jnp.asarray(y), 1e-3, backend="jnp")
    te = core.exact_krr(tk, xt, yt, 1e-3, backend="torch")
    _close(te.predict(torch.from_numpy(xte)).numpy(), je.predict(jnp.asarray(xte)), 1e-3)
    assert te.alpha.shape == (400,)


def test_falkon_converges_to_the_direct_nystrom_solution():
    # the reference's own check (tests/test_falkon.py): relative L2 < 1e-3
    x, y, _, _ = _problem(n=800, k=2, seed=4)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    kern = core.make_kernel("gaussian", sigma=2.0)
    fal = core.falkon_fit(kern, xt, yt, xt[:60], 1e-3, iters=40, backend="torch")
    nys = core.nystrom_krr(kern, xt, yt, xt[:60], 1e-3, backend="torch")
    pf, pn = fal.predict(xt), nys.predict(xt)
    assert float(torch.linalg.norm(pf - pn) / torch.linalg.norm(pn)) < 1e-3
    assert fal.diagnostics.residuals.shape == (41, 2) and not fal.diagnostics.diverged


def test_row_mask_fit_matches_reference():
    x, y, xte, _ = _problem(n=500, k=2, seed=5)
    mask = (np.random.default_rng(6).random((500, 2)) > 0.25).astype(np.float32)
    jm = jcore.falkon_fit(jcore.make_kernel("gaussian", sigma=2.0), jnp.asarray(x),
                          jnp.asarray(y), jnp.asarray(x[:40]), 1e-3, iters=15, backend="jnp",
                          row_mask=jnp.asarray(mask), fused=False)
    tm = core.falkon_fit(core.make_kernel("gaussian", sigma=2.0), torch.from_numpy(x),
                         torch.from_numpy(y), torch.from_numpy(x[:40]), 1e-3, iters=15,
                         backend="torch", row_mask=torch.from_numpy(mask))
    _close(tm.predict(torch.from_numpy(xte)).numpy(), jm.predict(jnp.asarray(xte)), 1e-3)


def test_estimator_surface():
    x, y, xte, yte = _problem(n=600, seed=7)
    assert FalkonRegressor().sampler == BlessSampler()
    assert NystromRegressor().sampler == BlessSampler()
    seen = []
    est = FalkonRegressor(sigma=2.0, sampler=UniformSampler(150, weights="identity"),
                          config=CPU, warm_start=True)
    with pytest.raises(RuntimeError, match="not fitted"):
        est.predict(xte)
    est.fit(x, y, callback=lambda i, model: seen.append(i))
    assert seen == list(range(CPU.iters))
    first = est.centers_
    est.fit(x, y, key=123)  # warm start keeps the centers of the first fit
    assert est.centers_ is first
    assert est.score(xte, yte) > 0.5
    pred, std = est.predict(xte, return_std=True)
    assert pred.shape == std.shape == (xte.shape[0],) and bool(torch.all(std >= 0))
    nys = NystromRegressor(sigma=2.0, sampler=UniformSampler(150), config=CPU).fit(x, y)
    assert nys.score(xte, yte) > 0.5
    assert ExactKrr(sigma=2.0, config=CPU).fit(x[:200], y[:200]).predict(xte).shape == (256,)


def test_default_device_estimator_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, _, _ = _problem(n=64)
    for est in (FalkonRegressor(sampler=UniformSampler(8)), FalkonRegressor(),
                NystromRegressor()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            est.fit(x, y)


# -- chip_smoke.py rehearsed on the CPU ------------------------------------------------


def test_chip_smoke_phases_rehearse_on_the_cpu(monkeypatch):
    from repro_torch.kernels import rls_score_ops

    worst = chip_smoke.kernel_parity("cpu", n=301, m=40, d=18, score_ms=(1, 40, 70),
                                     quad_ms=(40, 65), route_ms=(50, 70))
    assert set(worst) == set(chip_smoke.KERNELS)
    res = chip_smoke.end_to_end("cpu", n_train=1536, n_test=512, m=120, iters=10,
                                refit_rows=1024, referee_rows=256)
    assert res["test_error"] < 0.2 and res["refit"]["rows"] == 1024
    assert res["variance"]["rows"] == 256 and res["variance"]["min_var"] >= 0
    tensors = res.pop("tensors")
    # a fused-kernel budget of 32 centers sends the ladder's later levels
    # down the K1 + K6 composition, as levels above 1 024 centers go on the card
    monkeypatch.setattr(rls_score_ops, "MAX_FUSED_M", 32)
    fb = chip_smoke.bless_end_to_end("cpu", tensors, lam_bless=1e-2, m_cap=400,
                                     score_rows=256)
    assert fb["repeat_bit_identical"] and fb["levels_above_1024"] > 0
    assert [lvl["lam"] for lvl in fb["levels"]][-1] == 1e-2
    bless_t = fb.pop("tensors")
    calls = chip_smoke.main_path_calls(tensors, sigma=4.0, bless_t=bless_t, folds=3)
    extra = ["knm_t@cv", "knm_matvec@cv", "gram@slab", "gram@stream", "knm_matvec@wave",
             "knm_matvec@wave_half", "quadform@ladder"]
    assert [c[0] for c in calls] == list(chip_smoke.KERNELS) + extra
    masked = next(c for c in calls if c[0] == "falkon_matvec_masked")
    assert masked[1:5] == (1536, int(bless_t["center_set"].count), 18, 3)
    rhs = next(c for c in calls if c[0] == "knm_t@cv")  # K3 at the sweep's shape
    assert rhs[1:5] == masked[1:5] and rhs[5]().shape == (masked[2], 3)
    panel = next(c for c in calls if c[0] == "knm_matvec@cv")  # the sweep's panel predict
    assert panel[1:5] == masked[1:5] and panel[5]().shape == (1536, 3)
    slab = next(c for c in calls if c[0] == "gram@slab")  # one variance slab: all 512 rows here
    assert slab[1:4] == (512, 120, 18) and slab[5]().shape == (512, 120)
    # phase 12's shapes: one streamed chunk (all 1 536 rows here) against the
    # BLESS centers, and serving waves (all 512 test rows here) against M
    tile = next(c for c in calls if c[0] == "gram@stream")
    assert tile[1:4] == (1536, masked[2], 18) and tile[5]().shape == (1536, masked[2])
    for name in ("knm_matvec@wave", "knm_matvec@wave_half"):
        wave = next(c for c in calls if c[0] == name)
        assert wave[1:5] == (512, 120, 18, 1) and wave[5]().shape == (512,)
    errs = chip_smoke.main_path_parity(calls)
    assert set(errs) == set(chip_smoke.KERNELS) | set(extra)
    for name, n, m, d, k, kern, _, library in calls:
        out = library()
        assert bool(torch.all(torch.isfinite(out)))
        if name == "falkon_matvec_masked":  # the yardstick computes the same function
            ref = kern()
            assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    # phase 7: the sweep on the BLESS centers, its repeat, the exactness gate
    cv = chip_smoke.cross_validation("cpu", tensors, bless_t["center_set"], folds=3,
                                     lams=(1e-3, 1e-4), iters=10, exact_rows=1024, exact_m=64)
    assert cv["repeat_bit_identical"] and len(cv["scores"]) == 2 and cv["best_lam"] in (1e-3, 1e-4)
    assert cv["exact"]["max_rel_err"] <= chip_smoke.CV_RTOL and cv["exact"]["replay_equals_sweep"]
    assert cv["mask_tax"] is None  # timed on the card only
    assert sum(cv["launches"].values()) == 0  # the CPU runs the plain versions
    # phase 8: the classifier on the same centers against phase 5's regressor
    clf = chip_smoke.classify("cpu", tensors, bless_t["center_set"], fb["test_error"])
    assert clf["classes"] == [-1.0, 1.0] and clf["margin_sum_over_max"] <= 1e-5


def test_chip_smoke_bounds():
    # K_MM at M = 10^4: the 400 MB write bounds it; the K_nM sweeps are bound
    # by the fp32 operations.
    ms, by = chip_smoke.bound("gram", 10_000, 10_000, 18, 10_000)
    assert by == "bytes" and ms == pytest.approx(4 * (2 * 10_000 * 18 + 10 ** 8) / 3.35e12 * 1e3)
    ms, by = chip_smoke.bound("falkon_matvec", 10 ** 6, 10 ** 4, 18, 1)
    assert by == "operations" and ms == pytest.approx(10 ** 10 * 45 / 67e12 * 1e3)
    # K6 at the predictive-variance shape and K5 at a full ladder level are
    # bound by the G W product's fp32 operations
    ms, by = chip_smoke.bound("quadform", 10 ** 5, 10 ** 4, 18, 1)
    assert by == "operations" and ms == pytest.approx((2e13 + 2e9) / 67e12 * 1e3)
    ms, by = chip_smoke.bound("rls_score", 30_000, 1024, 18, 1)
    ops = 30_000 * 1024 * (41 + 2 * 1024 + 2)
    assert by == "operations" and ms == pytest.approx(ops / 67e12 * 1e3)
    # K7 at the sweep's shape: K2's count plus the (n, k) mask's n k multiplies
    ms, by = chip_smoke.bound("falkon_matvec_masked", 10 ** 6, 2980, 18, 5)
    ops = 10 ** 6 * 2980 * (41 + 4 * 5) + 5 * 10 ** 6
    assert by == "operations" and ms == pytest.approx(ops / 67e12 * 1e3)
    k2, _ = chip_smoke.bound("falkon_matvec", 10 ** 6, 2980, 18, 5)
    assert 1.0 < ms / k2 < 1.001
    # at a tiny M the mask's 4 n k bytes count in the bytes bound
    ms, by = chip_smoke.bound("falkon_matvec_masked", 10 ** 6, 1, 1, 5)
    assert by == "bytes" and ms == pytest.approx(4 * (10 ** 6 + 1 + 10 + 5 * 10 ** 6)
                                                 / 3.35e12 * 1e3)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    # alone in a directory, and on a machine with no CUDA device: non-zero, no result line
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
