"""The port's solver layer against the reference, on the CPU: kernels and
families, the Def. 2 preconditioner, CG, the health fences, center sets, the
exact leverage scores, the backend seam, the uniform sampler, and the rule
that the port runs on the card unless asked for the CPU."""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core as jcore
from repro.core import health as jhealth
from repro.core.bless import _bucket as jax_bucket
from repro_torch import core
from repro_torch.api import FitConfig, UniformSampler, as_generator
from repro_torch.api.samplers import _bucket
from repro_torch.core import CudaBackend, TorchBackend, health
from repro_torch.interop import center_set_from_numpy

FAMILIES = ["gaussian", "laplacian", "linear", "matern32", "cauchy"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(n=160, d=5, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# -- kernels -------------------------------------------------------------------


@pytest.mark.parametrize("kind", FAMILIES)
def test_kernel_cross_and_diag_match_reference(kind):
    x, z = _data(), _data(40, seed=1)
    jk = jcore.make_kernel(kind, sigma=1.3, kappa_sq=5.0)
    tk = core.make_kernel(kind, sigma=1.3, kappa_sq=5.0)
    ref = np.asarray(jk.cross(jnp.asarray(x), jnp.asarray(z)))
    np.testing.assert_allclose(tk.cross(_t(x), _t(z)).numpy(), ref, rtol=0,
                               atol=2e-5 * max(1.0, np.abs(ref).max()))
    np.testing.assert_allclose(tk.diag(_t(x)).numpy(), np.asarray(jk.diag(jnp.asarray(x))),
                               rtol=1e-6)
    assert tk.cross_unfused(_t(x), _t(z)).shape == ref.shape


def test_sq_dists_clamps_and_blocked_cross_matches_cross():
    x = _data(50)
    d2 = core.sq_dists(_t(x), _t(x))
    assert float(d2.min()) >= 0.0
    k = core.make_kernel("gaussian", sigma=2.0)
    torch.testing.assert_close(core.blocked_cross(k, _t(x), _t(x[:7]), block=16),
                               k.cross(_t(x), _t(x[:7])))
    with pytest.raises(ValueError, match="registered"):
        core.make_kernel("rbf")


# -- preconditioner and CG ---------------------------------------------------------


def _bbt(prec, m):
    b = prec.apply(torch.eye(m)) if isinstance(prec, core.Preconditioner) else \
        np.asarray(prec.apply(jnp.eye(m)))
    b = np.asarray(b, dtype=np.float64)
    return b @ b.T


@pytest.mark.parametrize("weights", ["identity", "skewed"])
def test_preconditioner_matches_reference(weights):
    # B B^T is invariant to the eigenvector basis eigh picks, so it is the
    # quantity both packages must agree on.
    z = _data(40, d=4, seed=2) * 1.5
    m = z.shape[0]
    a = np.ones(m, np.float32) if weights == "identity" else \
        np.linspace(0.5, 2.0, m).astype(np.float32)
    lam, n = 1e-3, 500
    jp = jcore.make_preconditioner(jcore.make_kernel("gaussian", sigma=1.0), jnp.asarray(z),
                                   jnp.asarray(a), lam, n)
    tp = core.make_preconditioner(core.make_kernel("gaussian", sigma=1.0), _t(z), _t(a), lam, n)
    ref = _bbt(jp, m)
    np.testing.assert_allclose(_bbt(tp, m), ref, rtol=0, atol=1e-3 * np.abs(ref).max())
    assert int((tp.q_iso.abs().sum(0) > 0).sum()) == int((np.abs(jp.q_iso).sum(0) > 0).sum())


def test_preconditioner_truncates_duplicate_centers_at_fixed_shape():
    z = np.repeat(_data(10, d=3, seed=3), 3, axis=0)  # rank 10 of 30
    tp = core.make_preconditioner(core.make_kernel("gaussian", sigma=1.0), _t(z),
                                  torch.ones(30), 1e-3, 100)
    kept = int((tp.q_iso.abs().sum(0) > 0).sum())
    assert tp.q_iso.shape == (30, 30) and kept == 10
    assert torch.all(torch.isfinite(tp.apply(torch.ones(30))))


def test_fp64_preconditioner_and_fit_stay_fp64():
    # An fp64 solve is the referee of the fp32 paths (chip_smoke.py): given
    # fp64 inputs the factors, alpha and predictions stay fp64 and agree with
    # the fp32 fit on a well-conditioned problem.
    x = _t(_data(600, d=4, seed=6))
    y = torch.sin(x[:, 0])
    kern = core.make_kernel("gaussian", sigma=1.5)
    z = x[:50]
    p64 = core.make_preconditioner(kern, z.double(), torch.ones(50, dtype=torch.float64),
                                   1e-3, 600)
    assert all(t.dtype == torch.float64 for t in p64[:4])
    p32 = core.make_preconditioner(kern, z, torch.ones(50), 1e-3, 600)
    assert p32.q_iso.dtype == torch.float32
    ref = _bbt(p32, 50)
    np.testing.assert_allclose(_bbt(p64, 50), ref, rtol=0, atol=1e-3 * np.abs(ref).max())
    fits = [core.falkon_fit(kern, x.to(dt), y.to(dt), z.to(dt), 1e-3, iters=30,
                            backend="torch") for dt in (torch.float32, torch.float64)]
    assert fits[1].alpha.dtype == torch.float64
    p32, p64 = (f.predict(x[:200].to(f.alpha.dtype)) for f in fits)
    assert p64.dtype == torch.float64
    assert float((p32.double() - p64).abs().max()) <= 1e-3 * float(p64.abs().max())


def _spd(m=24, seed=4):
    g = np.random.default_rng(seed).standard_normal((m, m)).astype(np.float32)
    return g @ g.T / m + 0.1 * np.eye(m, dtype=np.float32)


@pytest.mark.parametrize("shape", ["vector", "panel", "frozen"])
def test_cg_matches_reference(shape):
    a = _spd()
    rng = np.random.default_rng(5)
    b = rng.standard_normal((24,) if shape == "vector" else (24, 3)).astype(np.float32)
    if shape == "frozen":
        b[:, 1] = 0.0  # a zero column is frozen from iteration 0
    ja = jnp.asarray(a)
    jb, jres = jcore.cg(lambda v: ja @ v, jnp.asarray(b), 12, trajectory=True)
    ta = _t(a)
    tb, tres = core.cg(lambda v: ta @ v, _t(b), 12, trajectory=True)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jb)).max())
    assert tres.shape == jres.shape
    r0 = np.asarray(jres)[0]
    np.testing.assert_allclose(tres.numpy()[:6], np.asarray(jres)[:6], rtol=1e-3,
                               atol=1e-6 * float(np.max(r0)))
    if shape == "frozen":
        assert float(tb[:, 1].abs().max()) == 0.0


def test_cg_callback_sees_every_iterate():
    a = _t(_spd())
    seen = []
    core.cg(lambda v: a @ v, torch.ones(24), 5, callback=lambda i, beta: seen.append(i))
    assert seen == list(range(5))


# -- health ------------------------------------------------------------------------


def test_safe_cholesky_matches_reference_and_reports_the_jitter_level():
    a = _spd(16)
    tc, tl = health.safe_cholesky(_t(a))
    jc, jl = jhealth.safe_cholesky(jnp.asarray(a))
    assert tl == jl == 0
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    # slightly indefinite (eigenvalue -5e-5 on a unit diagonal): level 2 in both
    q, _ = np.linalg.qr(np.random.default_rng(6).standard_normal((16, 16)))
    ev = np.linspace(1.0, 2.0, 16)
    ev[0] = -5e-5
    b = (q * ev) @ q.T
    b = (b / np.mean(np.diag(b))).astype(np.float32)
    health.clear_events()
    _, tl = health.safe_cholesky(_t(b))
    _, jl = jhealth.safe_cholesky(jnp.asarray(b))
    assert tl == jl > 0
    assert health.events("jitter_escalation")[-1]["level"] == tl


def test_safe_cholesky_raises_when_the_ladder_is_exhausted():
    a = -np.eye(4, dtype=np.float32)
    with pytest.raises(health.FactorizationError):
        health.safe_cholesky(_t(a))
    with pytest.raises(jhealth.FactorizationError):
        jhealth.safe_cholesky(jnp.asarray(a))
    chol, level = health.chol_with_jitter_ladder(_t(a))
    assert level == health.JITTER_LEVELS - 1 and bool(torch.all(torch.isnan(chol)))


def test_check_finite_and_diagnostics_classification():
    health.clear_events()
    x = torch.ones(3)
    assert health.check_finite(x, "x") is x
    with pytest.raises(health.NonFiniteError, match="1 non-finite"):
        health.check_finite(torch.tensor([1.0, float("nan")]), "y")
    assert health.events("non_finite")[-1]["bad"] == 1
    conv = health.SolveDiagnostics(torch.tensor([1.0, 1e-3, 1e-9]))
    assert conv.converged and not conv.diverged and not conv.stalled
    div = health.SolveDiagnostics(torch.tensor([1.0, 10.0, 1e3]))
    assert div.diverged and "diverged" in div.summary()
    stall = health.SolveDiagnostics(torch.tensor([1.0, 0.5, 0.5, 0.5, 0.5]))
    assert stall.stalled
    ref = jhealth.SolveDiagnostics(jnp.asarray([[1.0, 1.0], [1e-3, 2.0], [1e-9, 3e2]]))
    mine = health.SolveDiagnostics(torch.tensor([[1.0, 1.0], [1e-3, 2.0], [1e-9, 3e2]]))
    np.testing.assert_allclose(mine.reduction, ref.reduction)
    assert (mine.converged, mine.diverged, mine.stalled) == (ref.converged, ref.diverged,
                                                             ref.stalled)


# -- center sets and leverage ------------------------------------------------------


def test_uniform_center_set_matches_reference_convention():
    idx = np.array([5, 2, 9, 0, 7], np.int32)
    jcs = jcore.uniform_center_set(jnp.asarray(idx), 50, 8)
    tcs = core.uniform_center_set(_t(idx), 50, 8)
    for a, b in zip(tcs, jcs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = center_set_from_numpy(*map(np.asarray, jcs))
    for a, b in zip(back, tcs):
        assert torch.equal(a, b)
    assert core.CenterSet.empty(4).mask.sum() == 0


def test_exact_rls_and_effective_dim_match_reference():
    x = _data(120, d=3, seed=7)
    jk, tk = jcore.make_kernel("gaussian", sigma=1.5), core.make_kernel("gaussian", sigma=1.5)
    ref = np.asarray(jcore.exact_rls(jk, jnp.asarray(x), 1e-3))
    np.testing.assert_allclose(core.exact_rls(tk, _t(x), 1e-3).numpy(), ref, rtol=5e-4,
                               atol=1e-6)
    np.testing.assert_allclose(float(core.effective_dim(tk, _t(x), 1e-3)),
                               float(jcore.effective_dim(jk, jnp.asarray(x), 1e-3)), rtol=5e-4)


# -- backend seam ------------------------------------------------------------------


def test_backend_registry_and_resolution():
    assert core.backend_names() == ["cuda", "guarded", "sharded", "stream", "torch"]
    assert isinstance(core.resolve_backend("torch"), TorchBackend)
    assert isinstance(core.resolve_backend("cuda"), CudaBackend)
    inst = TorchBackend(block=64)
    assert core.resolve_backend(inst) is inst
    with pytest.raises(ValueError, match="unknown backend"):
        core.resolve_backend("pallas")
    assert CudaBackend(bf16=True) != CudaBackend() and hash(TorchBackend()) == hash(TorchBackend())


@pytest.mark.parametrize("kind", ["gaussian", "linear", "matern32"])
def test_torch_backend_rls_scores_match_reference(kind):
    x, z = _data(90, seed=8), _data(24, seed=9)
    mask = np.arange(24) < 19
    lamn = 0.05
    reg = np.where(mask, lamn * np.linspace(0.5, 1.5, 24), 1.0).astype(np.float32)
    jk = jcore.make_kernel(kind, sigma=1.4, kappa_sq=10.0)
    tk = core.make_kernel(kind, sigma=1.4, kappa_sq=10.0)
    ref = np.asarray(jcore.JnpBackend().rls_scores(jk, jnp.asarray(x), jnp.asarray(z),
                                                   jnp.asarray(mask), jnp.asarray(reg), lamn))
    out = TorchBackend().rls_scores(tk, _t(x), _t(z), _t(mask), _t(reg), lamn).numpy()
    np.testing.assert_allclose(out, ref, rtol=5e-4, atol=5e-4 * np.abs(ref).max())


@pytest.mark.parametrize("backend", [TorchBackend(block=64), CudaBackend()])
@pytest.mark.parametrize("panel", [False, True])
def test_backend_knm_ops_match_reference(backend, panel):
    # CudaBackend on CPU tensors runs each kernel's plain version: this pins
    # its plumbing (vector/panel shapes, the bandwidth it passes) on the CPU.
    x, z = _data(200, seed=10), _data(30, seed=11)
    rng = np.random.default_rng(12)
    v = rng.standard_normal((30, 2) if panel else (30,)).astype(np.float32)
    y = rng.standard_normal((200, 2) if panel else (200,)).astype(np.float32)
    jk, tk = jcore.make_kernel("laplacian", sigma=2.0), core.make_kernel("laplacian", sigma=2.0)
    jb = jcore.JnpBackend()
    pairs = [
        (jb.knm_quadratic(jk, jnp.asarray(x), jnp.asarray(z))(jnp.asarray(v)),
         backend.knm_quadratic(tk, _t(x), _t(z))(_t(v))),
        (jb.knm_t(jk, jnp.asarray(x), jnp.asarray(z), jnp.asarray(y)),
         backend.knm_t(tk, _t(x), _t(z), _t(y))),
        (jb.knm_matvec(jk, jnp.asarray(x), jnp.asarray(z), jnp.asarray(v)),
         backend.knm_matvec(tk, _t(x), _t(z), _t(v))),
        (jb.gram_block(jk, jnp.asarray(x), jnp.asarray(z)), backend.gram_block(tk, _t(x), _t(z))),
    ]
    for ref, out in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_torch_backend_mask_panels_match_reference():
    x, z = _data(150, seed=13), _data(20, seed=14)
    rng = np.random.default_rng(15)
    v = rng.standard_normal((20, 3)).astype(np.float32)
    y = rng.standard_normal((150, 3)).astype(np.float32)
    mask = (rng.random((150, 3)) > 0.3).astype(np.float32)
    jk, tk = jcore.make_kernel("gaussian", sigma=1.5), core.make_kernel("gaussian", sigma=1.5)
    jb = jcore.JnpBackend()
    jq, jt = jb.knm_operators(jk, jnp.asarray(x), jnp.asarray(z), jnp.asarray(y),
                              mask=jnp.asarray(mask))
    tq, tt = TorchBackend(block=64).knm_operators(tk, _t(x), _t(z), _t(y), mask=_t(mask))
    for ref, out in ((jq(jnp.asarray(v)), tq(_t(v))), (jt, tt)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_cuda_backend_names_the_kernels_it_does_not_have_yet():
    # K5, K6 and K7 have landed: the Eq. 3 methods and the mask panels
    # compute (on CPU tensors through the kernels' plain versions) and match
    # TorchBackend; nothing raises for a kernel still missing.
    be, k = CudaBackend(), core.make_kernel()
    x = torch.from_numpy(_data(4, 2))
    mask, reg = torch.ones(4, dtype=torch.bool), torch.full((4,), 2.0)
    torch.testing.assert_close(be.masked_quadform(k, x, x, mask, reg),
                               TorchBackend().masked_quadform(k, x, x, mask, reg))
    torch.testing.assert_close(be.rls_scores(k, x, x, mask, reg, 2.0),
                               TorchBackend().rls_scores(k, x, x, mask, reg, 2.0))
    rows = torch.tensor([1.0, 0.0, 1.0, 0.5])
    torch.testing.assert_close(be.knm_quadratic(k, x, x, mask=rows)(torch.ones(4)),
                               TorchBackend().knm_quadratic(k, x, x, mask=rows)(torch.ones(4)))
    torch.testing.assert_close(be.knm_t(k, x, x, torch.ones(4), mask=rows),
                               TorchBackend().knm_t(k, x, x, torch.ones(4), mask=rows))
    from repro_torch.core import backend as backend_module
    assert not hasattr(backend_module, "_not_yet")


@pytest.mark.parametrize("case", ["vector", "panel", "broadcast"])
def test_cuda_backend_mask_panels_match_torch_backend(case):
    # CudaBackend's mask paths (K7 for the quadratic op, the targets times the
    # mask then K3) on CPU tensors against TorchBackend's streamer.
    x, z = _data(150, seed=16), _data(20, seed=17)
    rng = np.random.default_rng(18)
    k = None if case == "vector" else 3
    v = rng.standard_normal((20,) if k is None else (20, k)).astype(np.float32)
    y = rng.standard_normal((150,) if k is None else (150, k)).astype(np.float32)
    mask = (rng.random((150,) if case != "panel" else (150, 3)) > 0.3).astype(np.float32)
    tk = core.make_kernel("matern32", sigma=1.5)
    ymask = np.broadcast_to(mask[:, None], y.shape) if case == "broadcast" else mask
    cq, ct = CudaBackend().knm_operators(tk, _t(x), _t(z), _t(y), mask=_t(ymask))
    tq, tt = TorchBackend(block=64).knm_operators(tk, _t(x), _t(z), _t(y), mask=_t(ymask))
    cq = CudaBackend().knm_quadratic(tk, _t(x), _t(z), mask=_t(mask))
    for out, ref in ((cq(_t(v)), tq(_t(v))), (ct, tt)):
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))


# -- sampler -------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 7, 33, 100, 1045])
def test_bucket_matches_reference(m):
    assert _bucket(m) == jax_bucket(m)


@pytest.mark.parametrize("weights", ["nystrom", "identity"])
@pytest.mark.parametrize("replace", [False, True])
def test_uniform_sampler_conventions(weights, replace):
    x = torch.zeros(500, 3)
    cs = UniformSampler(m=100, weights=weights, replace=replace).sample(3, x, core.make_kernel())
    jcs = japi.UniformSampler(m=100, weights=weights, replace=replace).sample(
        3, jnp.zeros((500, 3)), jcore.make_kernel())
    assert cs.idx.shape == jcs.idx.shape and int(cs.count) == int(jcs.count) == 100
    valid = cs.idx[cs.mask]
    assert valid.shape == (100,) and int(valid.min()) >= 0 and int(valid.max()) < 500
    if not replace:
        assert torch.unique(valid).numel() == 100
    np.testing.assert_allclose(cs.weight.numpy(), np.asarray(jcs.weight))
    np.testing.assert_array_equal(cs.mask.numpy(), np.asarray(jcs.mask))


def test_uniform_sampler_seeds_and_validation():
    x = torch.zeros(300, 2)
    s = UniformSampler(m=20, replace=False)
    assert torch.equal(s.sample(7, x, None).idx, s.sample(7, x, None).idx)
    assert not torch.equal(s.sample(7, x, None).idx, s.sample(8, x, None).idx)
    g = as_generator(7)
    assert as_generator(g) is g
    with pytest.raises(TypeError):
        as_generator("7")
    with pytest.raises(ValueError, match="distinct"):
        UniformSampler(m=400, replace=False).sample(0, x, None)
    with pytest.raises(ValueError, match="weights"):
        UniformSampler(m=4, weights="bless").sample(0, x, None)


# -- devices ---------------------------------------------------------------------------


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    # The entry points never run on the CPU unless asked for it.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert FitConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        core.default_backend()
    with pytest.raises(RuntimeError, match="backend='torch'"):
        core.default_backend("cpu")
    with pytest.raises(RuntimeError):
        core.falkon_fit(core.make_kernel(), torch.zeros(8, 2), torch.zeros(8),
                        torch.zeros(2, 2), 1e-3)
    from repro_torch.interop import model_from_numpy
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_from_numpy(np.zeros((2, 2)), np.zeros(2), "gaussian", 1.0)
    assert isinstance(model_from_numpy(np.zeros((2, 2)), np.zeros(2), "gaussian", 1.0,
                                       device="cpu").backend, TorchBackend)


def test_port_imports_neither_jax_nor_the_reference():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(mod.name)
        sys.path.insert(0, sys.argv[1])
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib", "repro.")) or m == "repro")
        print("LOADED", len([m for m in sys.modules if m.startswith("repro_torch")]))
        print("BAD", bad)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code, REPO], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert int(out.stdout.split("LOADED")[1].split()[0]) >= 15
