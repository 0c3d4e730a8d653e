"""K1-K6 on the card, held against their plain PyTorch versions on the same
CUDA tensors. Needs an NVIDIA Hopper card and nvcc; elsewhere every test
skips with the reason. Run on the card with

    python -m pytest -m gpu tests/test_torch_cuda.py

Tolerances: Gram 2e-5 absolute; K_nM contractions and the quadratic form
1e-4 * max|ref|; RLS scores 5e-4 relative + 5e-5 (tests/test_backend.py's
form); bf16 3e-2 * max|ref|; end-to-end predictions 1e-3 * max|pred|.
"""
import pytest
import torch

from repro_torch import core, kernels
from repro_torch.kernels import falkon_matvec_ops as fo
from repro_torch.kernels import gram_ops as go
from repro_torch.kernels import quadform_ops as qo
from repro_torch.kernels import rls_score_ops as ro

pytestmark = pytest.mark.gpu

FAMILIES = ["gaussian", "laplacian", "linear", "matern32", "cauchy"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only on the card)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, n, m, d, k, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((n, d), generator=g, device=dev), torch.randn((m, d), generator=g, device=dev),
            torch.randn((m, k), generator=g, device=dev), torch.randn((n, k), generator=g, device=dev))


def _close(out, ref, tol):
    assert out.shape == ref.shape and out.device.type == "cuda"
    assert bool(torch.all(torch.isfinite(out)))
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", FAMILIES)
@pytest.mark.parametrize("shape", [(5003, 301, 18), (64, 64, 8), (1, 1, 1), (777, 130, 41)])
def test_gram_kernel_matches_plain(dev, kind, bf16, shape):
    n, m, d = shape
    x, z, _, _ = _inputs(dev, n, m, d, 1)
    ref = go.gram_reference(x, z, 2.5, kind=kind, bf16=bf16)
    tol = (3e-2 if bf16 else 2e-5) * max(1.0, float(ref.abs().max()))
    _close(go.gram(x, z, 2.5, kind=kind, bf16=bf16), ref, tol)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", FAMILIES)
@pytest.mark.parametrize("k", [None, 3, 40])
def test_knm_kernels_match_plain(dev, kind, bf16, k):
    x, z, v, y = _inputs(dev, 20_011, 517, 18, k or 1, seed=1)
    if k is None:
        v, y = v[:, 0], y[:, 0]
    kw = dict(kind=kind, bf16=bf16)
    rel = 3e-2 if bf16 else 1e-4
    for out, ref in ((fo.falkon_matvec(x, z, v, 3.0, **kw), fo.falkon_matvec_reference(x, z, v, 3.0, **kw)),
                     (fo.knm_t(x, z, y, 3.0, **kw), fo.knm_t_reference(x, z, y, 3.0, **kw)),
                     (fo.knm_matvec(x, z, v, 3.0, **kw), fo.knm_matvec_reference(x, z, v, 3.0, **kw))):
        _close(out, ref, rel * float(ref.abs().max()))


def test_launch_counts_and_bit_repeatable_reductions(dev):
    x, z, v, y = _inputs(dev, 9000, 200, 18, 2, seed=2)
    kernels.reset_launch_counts()
    a = fo.knm_t(x, z, y)
    b = fo.knm_t(x, z, y)
    c = fo.falkon_matvec(x, z, v)
    d = fo.falkon_matvec(x, z, v)
    go.gram(z, z)
    fo.knm_matvec(x, z, v)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d)  # fixed-order sums, no atomics
    assert kernels.launch_counts() == {"gram": 1, "falkon_matvec": 2, "knm_t": 2, "knm_matvec": 1,
                                       "rls_score": 0, "quadform": 0}


def _score_inputs(dev, r, m, d, kind, seed):
    """Candidates, a padded center set (the last tenth invalid) and the
    inverse W = (K_JJ * mask + diag(reg))^-1 the backend would form."""
    x, z, _, _ = _inputs(dev, r, m, d, 1, seed)
    mask = torch.arange(m, device=dev) < max(1, m - m // 10)
    lamn = 1e-3 * 50_000
    weight = 0.5 + torch.rand((m,), generator=torch.Generator(device=dev).manual_seed(seed),
                              device=dev)
    reg = torch.where(mask, lamn * weight, torch.ones_like(weight))
    kern = core.make_kernel(kind, sigma=2.5)
    mm = mask.float()
    kjj = go.gram_reference(z, z, 2.5, kind=kind) * (mm[:, None] * mm[None, :]) + torch.diag(reg)
    w = torch.cholesky_solve(torch.eye(m, device=dev), torch.linalg.cholesky(kjj))
    return kern, x, z, w, mask, reg, lamn


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", FAMILIES)
@pytest.mark.parametrize("shape", [(5003, 1000, 18), (777, 1024, 7), (70, 1, 3), (1, 130, 41)])
def test_rls_score_kernel_matches_plain(dev, kind, bf16, shape):
    r, m, d = shape
    _, x, z, w, mask, _, lamn = _score_inputs(dev, r, m, d, kind, seed=5)
    out = ro.rls_score(x, z, w, mask, lamn, 2.5, kind=kind, bf16=bf16)
    ref = ro.rls_score_reference(x, z, w, mask, lamn, 2.5, kind=kind, bf16=bf16)
    assert out.shape == ref.shape == (r,) and bool(torch.all(torch.isfinite(out)))
    if bf16:
        _close(out, ref, 3e-2 * float(ref.abs().max()))
    else:
        torch.testing.assert_close(out, ref, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", FAMILIES)
@pytest.mark.parametrize("shape", [(7001, 1000), (300, 4097), (1, 1), (65, 63)])
def test_quadform_kernel_matches_plain(dev, kind, bf16, shape):
    n, m = shape
    _, x, z, w, mask, _, _ = _score_inputs(dev, n, m, 18, kind, seed=6)
    g = go.gram(x, z, 2.5, kind=kind) * mask.float()[None, :]
    ref = qo.quadform_reference(g, w, bf16=bf16)
    _close(qo.quadform(g, w, bf16=bf16), ref, (3e-2 if bf16 else 1e-4) * float(ref.abs().max()))


def test_score_kernels_are_bit_repeatable_and_counted(dev):
    _, x, z, w, mask, _, lamn = _score_inputs(dev, 9000, 700, 18, "gaussian", seed=7)
    g = go.gram(x, z, 2.5)
    kernels.reset_launch_counts()
    a, b = ro.rls_score(x, z, w, mask, lamn, 2.5), ro.rls_score(x, z, w, mask, lamn, 2.5)
    c, d = qo.quadform(g, w), qo.quadform(g, w)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d)  # each row in one block; fixed-order sums
    counts = kernels.launch_counts()
    assert counts["rls_score"] == 2 and counts["quadform"] == 2
    with pytest.raises(ValueError, match="at most 1024"):
        ro.rls_score(x[:4], x[:1025], torch.eye(1025, device=dev),
                     torch.ones(1025, dtype=torch.bool, device=dev), 1.0)
    assert qo.quadform(g[:0], w).shape == (0,)


@pytest.mark.parametrize("m", [700, 1100])
def test_cuda_backend_scores_match_torch_backend(dev, m):
    # M <= 1024 runs K5; above it K1 + K6 through masked_quadform.
    kern, x, z, _, mask, reg, lamn = _score_inputs(dev, 3000, m, 18, "gaussian", seed=8)
    kernels.reset_launch_counts()
    out = core.CudaBackend().rls_scores(kern, x, z, mask, reg, lamn)
    counts = kernels.launch_counts()
    assert (counts["rls_score"], counts["quadform"]) == ((1, 0) if m <= 1024 else (0, 1))
    ref = core.TorchBackend().rls_scores(kern, x, z, mask, reg, lamn)
    torch.testing.assert_close(out, ref, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("alg", ["bless", "bless_r"])
def test_bless_ladder_on_the_card_is_bit_repeatable(dev, alg):
    # large enough that the CDF and the dedup sums span many scan tiles
    fn = getattr(core, alg)
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((200_000, 18), generator=g, device=dev)
    kern = core.make_kernel("gaussian", sigma=4.0)
    kernels.reset_launch_counts()
    runs = [fn(11, x, kern, 2e-4, m_cap=4000) for _ in range(3)]
    assert kernels.launch_counts()["rls_score"] > 0
    for other in runs[1:]:
        assert [lvl.m_h for lvl in other.levels] == [lvl.m_h for lvl in runs[0].levels]
        for la, lb in zip(runs[0].levels, other.levels):
            assert torch.equal(la.centers.idx, lb.centers.idx)
            assert torch.equal(la.centers.weight, lb.centers.weight)


def test_categorical_draws_are_bit_repeatable(dev):
    from repro_torch.core.sampling import categorical

    w = torch.rand((1_000_000,), generator=torch.Generator(device=dev).manual_seed(3),
                   device=dev)
    draws = [categorical(5, w, 200_000) for _ in range(5)]
    assert all(torch.equal(draws[0], d) for d in draws[1:])
    assert draws[0].device.type == "cuda" and int(draws[0].max()) < w.shape[0]


def test_empty_and_degenerate_shapes(dev):
    x, z, v, y = _inputs(dev, 100, 10, 4, 2, seed=3)
    assert fo.knm_matvec(x[:0], z, v).shape == (0, 2)
    assert torch.count_nonzero(fo.knm_t(x[:0], z, y[:0])) == 0
    assert torch.count_nonzero(fo.falkon_matvec(x[:0], z, v)) == 0
    with pytest.raises(ValueError, match="float32"):
        go.gram(x.double(), z.double())
    with pytest.raises(ValueError, match="share one device"):
        go.gram(x, z.cpu())


def test_cuda_and_torch_backends_agree_end_to_end(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((30_000, 18), generator=g, device=dev)
    y = torch.sign(torch.sin(x[:, 0]) + 0.3 * x[:, 1])
    centers = x[:1000]
    kern = core.make_kernel("gaussian", sigma=4.0)
    preds = []
    for be in (core.CudaBackend(), core.TorchBackend()):
        model = core.falkon_fit(kern, x, y, centers, 1e-3, iters=20, backend=be)
        preds.append(model.predict(x[:5000], backend=be))
    _close(preds[0], preds[1], 1e-3 * float(preds[1].abs().max()))


def test_estimator_runs_on_the_card_by_default(dev):
    from repro_torch.api import FalkonRegressor, FitConfig, UniformSampler

    x = torch.randn((4000, 6), device=dev)
    y = torch.cos(x[:, 0])
    est = FalkonRegressor(sigma=2.0, sampler=UniformSampler(200, weights="identity", replace=False),
                          config=FitConfig(lam=1e-4, iters=15))
    kernels.reset_launch_counts()
    est.fit(x, y)
    pred = est.predict(x)
    assert pred.device.type == "cuda" and est.score(x, y) > 0.5
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in ("gram", "falkon_matvec", "knm_t", "knm_matvec"))
    # the default sampler is BLESS, which scores every level through K5
    kernels.reset_launch_counts()
    est = FalkonRegressor(sigma=2.0, config=FitConfig(lam=1e-4, iters=15)).fit(x, y)
    pred, std = est.predict(x, return_std=True)
    assert kernels.launch_counts()["rls_score"] > 0 and est.score(x, y) > 0.5
    assert std.device.type == "cuda" and bool(torch.all(torch.isfinite(std)))
