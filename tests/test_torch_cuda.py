"""K1-K4 on the card, held against their plain PyTorch versions on the same
CUDA tensors. Needs an NVIDIA Hopper card and nvcc; elsewhere every test
skips with the reason. Run on the card with

    python -m pytest -m gpu tests/test_torch_cuda.py

Tolerances: Gram 2e-5 absolute; K_nM contractions 1e-4 * max|ref|; bf16
3e-2 * max|ref|; end-to-end predictions 1e-3 * max|pred|.
"""
import pytest
import torch

from repro_torch import core, kernels
from repro_torch.kernels import falkon_matvec_ops as fo
from repro_torch.kernels import gram_ops as go

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
    assert kernels.launch_counts() == {"gram": 1, "falkon_matvec": 2, "knm_t": 2, "knm_matvec": 1}


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
    assert all(count > 0 for count in kernels.launch_counts().values())
