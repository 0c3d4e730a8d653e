"""K1-K9 on the card, held against their plain PyTorch versions on the same
CUDA tensors, and the LM stack on the card. Needs an NVIDIA Hopper card and
nvcc; elsewhere every test skips with the reason. Run on the card with

    python -m pytest -m gpu tests/test_torch_cuda.py

Tolerances: Gram 2e-5 absolute; K_nM contractions and the quadratic form
1e-4 * max|ref|; RLS scores 5e-4 relative + 5e-5 (tests/test_backend.py's
form); bf16 3e-2 * max|ref|; end-to-end predictions 1e-3 * max|pred|; K8
2e-5 (bf16 2e-2) and K9 2e-4 (bf16 3e-2) * max|ref| (tests/test_kernels.py);
whole LM forwards 2e-4 and decode against forward 5e-3 * max|ref|.
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


# K1's routes: wide (16-byte stores, several column runs), scalar (m % 4 != 0),
# at the d cap, and tiled above it.
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", FAMILIES)
@pytest.mark.parametrize("shape", [(10_007, 4_100, 18), (3_001, 2_977, 18), (129, 8, 64),
                                   (777, 132, 65), (1, 1, 1), (70, 1_030, 3),
                                   (20_001, 5_001, 7)])
def test_gram_routes_match_plain(dev, kind, bf16, shape):
    n, m, d = shape
    plan = go.gram_plan(n, m, d)
    assert plan.route == ("tiled" if d > go.DMAX else "wide" if m % 4 == 0 else "scalar")
    x, z, _, _ = _inputs(dev, n, m, d, 1, seed=30)
    ref = go.gram_reference(x, z, 2.5, kind=kind, bf16=bf16)
    tol = (3e-2 if bf16 else 2e-5) * max(1.0, float(ref.abs().max()))
    _close(go.gram(x, z, 2.5, kind=kind, bf16=bf16), ref, tol)


@pytest.mark.parametrize("m,d", [(10_000, 18), (2_977, 18), (300, 65)])
def test_gram_of_centers_is_symmetric_and_repeats_bit_for_bit(dev, m, d):
    _, z, _, _ = _inputs(dev, 1, m, d, 1, seed=31)
    kernels.reset_launch_counts()
    kmm = go.gram(z, z, 4.0)
    torch.cuda.synchronize()
    assert torch.equal(kmm, kmm.T) and torch.equal(kmm, go.gram(z, z, 4.0))
    assert kernels.launch_counts()["gram"] == 2


# K4's routes: the register route with and without a center split (ragged n
# and M), every family, bf16, vector and panels of 2, 5 and 40 columns.
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", FAMILIES)
@pytest.mark.parametrize("k", [None, 2, 5, 40])
@pytest.mark.parametrize("split", [True, False])
def test_knm_matvec_register_route_matches_plain(dev, kind, bf16, k, split):
    n, m = (20_011, 1_023) if split else (1_000_003, 77)
    x, z, v, _ = _inputs(dev, n, m, 18, k or 1, seed=32)
    if k is None:
        v = v[:, 0]
    plan = fo.knm_matvec_plan(n, m, 18, k or 1)
    assert plan.route == "register" and (plan.n_chunks > 1) == split
    kw = dict(kind=kind, bf16=bf16)
    ref = fo.knm_matvec_reference(x, z, v, 3.0, **kw)
    _close(fo.knm_matvec(x, z, v, 3.0, **kw), ref, (3e-2 if bf16 else 1e-4) * float(ref.abs().max()))


@pytest.mark.parametrize("kind", FAMILIES)
@pytest.mark.parametrize("n,m,d,k", [(3_001, 1_023, 32, 5), (4_999, 77, 33, 3), (65, 700, 40, 1)])
def test_knm_matvec_routes_at_and_above_d_32_match_plain(dev, kind, n, m, d, k):
    x, z, v, _ = _inputs(dev, n, m, d, k, seed=33)
    assert fo.knm_matvec_plan(n, m, d, k).route == ("register" if d <= fo.KT_DMAX else "tiled")
    ref = fo.knm_matvec_reference(x, z, v, 3.0, kind=kind)
    _close(fo.knm_matvec(x, z, v, 3.0, kind=kind), ref, 1e-4 * float(ref.abs().max()))


@pytest.mark.parametrize("n,m,k", [(100_000, 10_000, 1), (20_011, 1_023, 5), (1_000_003, 77, 2),
                                   (9, 1, 1)])
def test_knm_matvec_repeats_bit_for_bit(dev, n, m, k):
    x, z, v, _ = _inputs(dev, n, m, 18, k, seed=34)
    kernels.reset_launch_counts()
    first = fo.knm_matvec(x, z, v, 4.0)
    torch.cuda.synchronize()
    assert torch.equal(first, fo.knm_matvec(x, z, v, 4.0))  # fixed-order sums, no atomics
    assert kernels.launch_counts()["knm_matvec"] == 2
    ref = fo.knm_matvec_reference(x, z, v, 4.0)
    _close(first, ref, 1e-4 * float(ref.abs().max()))


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
    assert kernels.launch_counts() == {"gram": 1, "falkon_matvec": 2, "falkon_matvec_masked": 0,
                                       "knm_t": 2, "knm_matvec": 1, "rls_score": 0, "quadform": 0,
                                       "flash_attention": 0, "ssd": 0}


# K3's register route (d <= 32) and its tiled route above the cap: M not a
# multiple of the 512-center slice, n not a multiple of the 64-row tile.
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", FAMILIES)
@pytest.mark.parametrize("k", [1, 2, 5, 8, 9])
@pytest.mark.parametrize("d", [18, 32, 33])
def test_knm_t_routes_match_plain(dev, kind, bf16, k, d):
    x, z, _, y = _inputs(dev, 3001, 1023, d, k, seed=20)
    plan = fo.knm_t_plan(x.shape[0], z.shape[0], d, k)
    assert plan.route == ("register" if d <= fo.KT_DMAX else "tiled")
    kw = dict(kind=kind, bf16=bf16)
    ref = fo.knm_t_reference(x, z, y, 3.0, **kw)
    _close(fo.knm_t(x, z, y, 3.0, **kw), ref, (3e-2 if bf16 else 1e-4) * float(ref.abs().max()))


@pytest.mark.parametrize("n,m,d,k", [(20_011, 1_500, 18, 1), (20_011, 1_500, 18, 5),
                                     (65_537, 513, 7, 2), (4_999, 77, 40, 3)])
def test_knm_t_repeats_bit_for_bit(dev, n, m, d, k):
    x, z, _, y = _inputs(dev, n, m, d, k, seed=21)
    kernels.reset_launch_counts()
    first = fo.knm_t(x, z, y)
    torch.cuda.synchronize()
    assert torch.equal(first, fo.knm_t(x, z, y))  # fixed-order sums, no atomics
    assert kernels.launch_counts()["knm_t"] == 2
    ref = fo.knm_t_reference(x, z, y)
    _close(first, ref, 1e-4 * float(ref.abs().max()))


@pytest.mark.parametrize("m,k,d", [(12_289, 1, 18), (16_384, 5, 18), (12_289, 2, 40)])
def test_two_stage_route_matches_plain_and_keeps_the_mask_exact(dev, m, k, d):
    # stage 2 of the two-stage route is K3's plan: the register route at
    # d = 18, the tiled route at d = 40
    x, z, v, _ = _inputs(dev, 9_001, m, d, k, seed=22)
    assert fo.matvec_plan(x.shape[0], m, d, k).route == "two-stage"
    mask = _mask(dev, x.shape[0], k, "k3", seed=23)
    ref = fo.falkon_matvec_reference(x, z, v, 3.0)
    plain = fo.falkon_matvec(x, z, v, 3.0)
    _close(plain, ref, 1e-4 * float(ref.abs().max()))
    ref = fo.falkon_matvec_masked_reference(x, z, v, mask, 3.0)
    _close(fo.falkon_matvec(x, z, v, 3.0, mask=mask), ref, 1e-4 * float(ref.abs().max()))
    ones = fo.falkon_matvec(x, z, v, 3.0, mask=torch.ones_like(mask))
    torch.cuda.synchronize()
    assert torch.equal(ones, plain) and torch.equal(plain, fo.falkon_matvec(x, z, v, 3.0))


def _mask(dev, n, k, case, seed=0):
    """The row masks K7 takes: a 0/1 vector or panel, fractional weights, or
    an (n,) mask that the wrapper broadcasts to the panel."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if case == "fractional":
        return torch.rand((n, k), generator=g, device=dev)
    shape = (n,) if case in ("vec", "broadcast") else (n, k)
    return (torch.rand(shape, generator=g, device=dev) > 0.3).float()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", FAMILIES)
@pytest.mark.parametrize("case,k", [("vec", None), ("k3", 3), ("k40", 40), ("broadcast", 3),
                                    ("fractional", 3)])
def test_masked_kernel_matches_plain(dev, kind, bf16, case, k):
    x, z, v, _ = _inputs(dev, 20_011, 517, 18, k or 1, seed=10)
    if k is None:
        v = v[:, 0]
    mask = _mask(dev, x.shape[0], k or 1, case, seed=11)
    kw = dict(kind=kind, bf16=bf16)
    ref = fo.falkon_matvec_masked_reference(x, z, v, mask, 3.0, **kw)
    _close(fo.falkon_matvec(x, z, v, 3.0, mask=mask, **kw), ref,
           (3e-2 if bf16 else 1e-4) * float(ref.abs().max()))


@pytest.mark.parametrize("k", [None, 3, 40])
def test_masked_kernel_all_ones_is_bit_identical_to_k2_and_zeros_give_zero(dev, k):
    x, z, v, _ = _inputs(dev, 9001, 300, 18, k or 1, seed=12)
    if k is None:
        v = v[:, 0]
    rows = (x.shape[0],) if k is None else (x.shape[0], k)
    kernels.reset_launch_counts()
    ones = fo.falkon_matvec(x, z, v, mask=torch.ones(rows, device=dev))
    zeros = fo.falkon_matvec(x, z, v, mask=torch.zeros(rows, device=dev))
    plain = fo.falkon_matvec(x, z, v)
    again = fo.falkon_matvec(x, z, v, mask=torch.ones(rows, device=dev))
    torch.cuda.synchronize()
    assert torch.equal(ones, plain) and torch.equal(ones, again)
    assert torch.count_nonzero(zeros) == 0
    counts = kernels.launch_counts()
    assert counts["falkon_matvec_masked"] == 3 and counts["falkon_matvec"] == 1
    with pytest.raises(ValueError, match="mask must be"):
        fo.falkon_matvec(x, z, v, mask=torch.ones((x.shape[0] + 1,), device=dev))


def test_masked_fit_is_bit_repeatable_and_matches_torch_backend(dev):
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn((30_000, 18), generator=g, device=dev)
    y = torch.sign(torch.sin(x[:, 0]) + 0.3 * x[:, 1])
    fold = torch.arange(x.shape[0], device=dev) % 4
    mask = (fold[:, None] != torch.arange(4, device=dev)[None, :]).float()
    kern = core.make_kernel("gaussian", sigma=4.0)
    kernels.reset_launch_counts()
    fits = [core.falkon_fit(kern, x, y[:, None] * mask, x[:1000], 1e-3, iters=20,
                            backend=core.CudaBackend(), row_mask=mask) for _ in range(3)]
    torch.cuda.synchronize()
    assert kernels.launch_counts()["falkon_matvec_masked"] == 60
    assert all(torch.equal(fits[0].alpha, f.alpha) for f in fits[1:])
    ref = core.falkon_fit(kern, x, y[:, None] * mask, x[:1000], 1e-3, iters=20,
                          backend=core.TorchBackend(), row_mask=mask)
    pred, want = fits[0].predict(x[:5000]), ref.predict(x[:5000], backend=core.TorchBackend())
    _close(pred, want, 1e-3 * float(want.abs().max()))


# At d = 18 and k = 1, M = 7 and 8 961 take the cluster route with one block
# per cluster and with 8 blocks whose last holds one center, 12 288 is the
# route's cap (8 blocks of 1 536), 12 289 takes the two-stage route.
ROUTE_MS = {7: ("cluster", 1), 8961: ("cluster", 8), 12_288: ("cluster", 8),
            12_289: ("two-stage", 0)}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", FAMILIES)
@pytest.mark.parametrize("m", sorted(ROUTE_MS))
def test_matvec_routes_match_plain(dev, kind, bf16, m):
    x, z, v, _ = _inputs(dev, 3001, m, 18, 5, seed=15)
    plan = fo.matvec_plan(x.shape[0], m, 18, 1)
    assert (plan.route, plan.cluster) == ROUTE_MS[m]
    vec_mask = _mask(dev, x.shape[0], 1, "vec", seed=16)
    panel_mask = _mask(dev, x.shape[0], 5, "k3", seed=17)
    kw = dict(kind=kind, bf16=bf16)
    rel = 3e-2 if bf16 else 1e-4
    kernels.reset_launch_counts()
    for out, ref in ((fo.falkon_matvec(x, z, v[:, 0], 3.0, **kw),
                      fo.falkon_matvec_reference(x, z, v[:, 0], 3.0, **kw)),
                     (fo.falkon_matvec(x, z, v[:, 0], 3.0, mask=vec_mask, **kw),
                      fo.falkon_matvec_masked_reference(x, z, v[:, 0], vec_mask, 3.0, **kw)),
                     (fo.falkon_matvec(x, z, v, 3.0, mask=panel_mask, **kw),
                      fo.falkon_matvec_masked_reference(x, z, v, panel_mask, 3.0, **kw))):
        _close(out, ref, rel * float(ref.abs().max()))
    counts = kernels.launch_counts()
    assert (counts["falkon_matvec"], counts["falkon_matvec_masked"]) == (1, 2)


@pytest.mark.parametrize("m,k,route", [(10_000, 1, "cluster"), (2978, 5, "cluster"),
                                       (12_289, 1, "two-stage"), (10_000, 5, "two-stage")])
def test_matvec_routes_keep_the_mask_exact_and_repeat(dev, m, k, route):
    # an all-ones mask gives K2 bit for bit on either route, zeros give 0,
    # and a call repeats itself bit for bit (fixed-order sums, no atomics)
    x, z, v, _ = _inputs(dev, 20_011, m, 18, k, seed=17)
    assert fo.matvec_plan(x.shape[0], m, 18, k).route == route
    ones = torch.ones((x.shape[0], k), device=dev)
    plain = fo.falkon_matvec(x, z, v)
    torch.cuda.synchronize()
    assert torch.equal(fo.falkon_matvec(x, z, v, mask=ones), plain)
    assert torch.equal(fo.falkon_matvec(x, z, v), plain)
    assert torch.count_nonzero(fo.falkon_matvec(x, z, v, mask=torch.zeros_like(ones))) == 0
    assert torch.count_nonzero(fo.falkon_matvec(x[:0], z, v)) == 0  # n = 0 gives zeros


def test_sweep_and_classifier_run_on_the_card_by_default(dev):
    from repro_torch.api import FalkonClassifier, FitConfig, KFoldSweep, UniformSampler

    g = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn((6000, 6), generator=g, device=dev)
    y = torch.cos(x[:, 0])
    kernels.reset_launch_counts()
    sweep = KFoldSweep(sigma=2.0, sampler=UniformSampler(200), lams=(1e-3, 1e-5), folds=3,
                       iters=15)
    res, again = sweep.run(x, y), sweep.run(x, y)
    assert kernels.launch_counts()["falkon_matvec_masked"] == 2 * 2 * 15
    assert res.scores.device.type == "cuda" and res.scores.shape == (2, 3)
    assert torch.equal(res.scores, again.scores) and torch.equal(res.fold_id, again.fold_id)
    labels = (x[:, 0] > 0).long() + (x[:, 1] > 0.5).long()
    clf = FalkonClassifier(sigma=2.0, sampler=UniformSampler(200),
                           config=FitConfig(lam=1e-5, iters=15)).fit(x, labels)
    assert list(clf.classes_) == [0, 1, 2] and clf.score(x, labels) > 0.9
    assert clf.decision_function(x).shape == (6000, 3)


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
@pytest.mark.parametrize("m", [1, 63, 640, 1024])
def test_rls_score_kernel_matches_plain_at_ragged_rows(dev, kind, bf16, m):
    # 1 537 rows: a partial 32-row tile; M across one to eight 128-column tiles
    _, x, z, w, mask, _, lamn = _score_inputs(dev, 1537, m, 18, kind, seed=18)
    out = ro.rls_score(x, z, w, mask, lamn, 2.5, kind=kind, bf16=bf16)
    ref = ro.rls_score_reference(x, z, w, mask, lamn, 2.5, kind=kind, bf16=bf16)
    assert out.shape == ref.shape == (1537,) and bool(torch.all(torch.isfinite(out)))
    if bf16:
        _close(out, ref, 3e-2 * float(ref.abs().max()))
    else:
        torch.testing.assert_close(out, ref, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", FAMILIES)
@pytest.mark.parametrize("shape", [(7001, 1000), (300, 4097), (1, 1), (65, 63), (129, 128),
                                   (128, 129), (257, 4099), (1000, 2560)])
def test_quadform_kernel_matches_plain(dev, kind, bf16, shape):
    n, m = shape
    _, x, z, w, mask, _, _ = _score_inputs(dev, n, m, 18, kind, seed=6)
    g = go.gram(x, z, 2.5, kind=kind) * mask.float()[None, :]
    ref = qo.quadform_reference(g, w, bf16=bf16)
    _close(qo.quadform(g, w, bf16=bf16), ref, (3e-2 if bf16 else 1e-4) * float(ref.abs().max()))


@pytest.mark.parametrize("bf16", [False, True])
def test_quadform_kernel_takes_a_misaligned_g(dev, bf16):
    # G starting 4 bytes past a 16-byte boundary (and m % 4 == 0) takes the
    # kernel's 4-byte staging path; the 16-byte one gives the same result.
    _, x, z, w, mask, _, _ = _score_inputs(dev, 1000, 256, 18, "gaussian", seed=8)
    g = go.gram(x, z, 2.5) * mask.float()[None, :]
    gm = torch.empty(g.numel() + 1, device=dev)[1:].view(g.shape)
    gm.copy_(g)
    assert gm.data_ptr() % 16 != 0 and gm.is_contiguous()
    ref = qo.quadform_reference(g, w, bf16=bf16)
    out = qo.quadform(gm, w, bf16=bf16)
    _close(out, ref, (3e-2 if bf16 else 1e-4) * float(ref.abs().max()))
    torch.testing.assert_close(out, qo.quadform(g, w, bf16=bf16), rtol=0, atol=0)


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


# -- K8 and K9: the LM kernels ---------------------------------------------------------------


#: the last 48 pad the tensor-core kernel's tiles: D in {17, 32, 80, 128}, S of
#: one row, one ragged tile and many; GQA groups 1, 4, 8; bidirectional.
ATTN_CASES = [(1, 4, 4, 1, 8, True), (2, 8, 2, 300, 64, True), (1, 8, 1, 1000, 80, True),
              (2, 4, 4, 300, 64, False), (1, 2, 2, 129, 128, False), (1, 4, 1, 77, 32, True),
              (1, 2, 1, 200, 17, True)] + [
    (1, hq, hkv, s, d, causal) for d in (17, 32, 80, 128) for s in (1, 129, 2053)
    for hq, hkv, causal in ((8, 8, True), (8, 2, True), (8, 1, True), (8, 2, False))] + [
    # the 192- and 256-wide tiles (gemma-2b's D = 256), ragged D among them
    (1, hq, hkv, s, d, causal) for d in (129, 200, 256) for s in (1, 1000, 2053)
    for hq, hkv, causal in ((8, 1, True), (8, 2, False))] + [(2, 8, 1, 2048, 256, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal", ATTN_CASES)
def test_flash_attention_kernel_matches_plain(dev, dtype, b, hq, hkv, s, d, causal):
    from repro_torch.kernels import flash_attention_ops as fa

    g = torch.Generator(device=dev).manual_seed(s + d)
    q, k, v = (torch.randn((b, h, s, d), generator=g, device=dev).to(dtype)
               for h in (hq, hkv, hkv))
    ref = fa.flash_attention_reference(q, k, v, causal=causal)
    out = fa.flash_attention(q, k, v, causal=causal)
    assert out.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    _close(out.float(), ref.float(), tol * float(ref.float().abs().max()))
    # and per query row: a causal row over i keys has outputs about sqrt(e / i),
    # far below row 0's, which sets max|ref|
    row_err = (out.float() - ref.float()).abs().amax(-1) / ref.float().abs().amax(-1)
    assert float(row_err.max()) <= tol, float(row_err.max())


def test_flash_attention_repeats_and_fp32_is_untouched_by_bf16_calls(dev):
    # No float atomics: the bf16 output repeats bit for bit. The fp32 kernel
    # shares no state with the bf16 one: its output is the same bits before
    # and after a bf16 call.
    from repro_torch.kernels import flash_attention_ops as fa

    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn((2, h, 1000, 128), generator=g, device=dev) for h in (8, 2, 2))
    before = fa.flash_attention(q, k, v)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    first = fa.flash_attention(qb, kb, vb)
    assert torch.equal(first, fa.flash_attention(qb, kb, vb))
    assert torch.equal(before, fa.flash_attention(q, k, v))


SSD_CASES = [(2, 96, 4, 8, 16, 32), (2, 80, 2, 16, 8, 32), (1, 1000, 3, 64, 16, 64),
             (2, 257, 4, 32, 16, 128), (1, 5, 2, 8, 4, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_ssd_kernel_matches_plain(dev, dtype, b, s, h, p, n, chunk):
    from repro_torch.kernels import ssd_ops as so

    g = torch.Generator(device=dev).manual_seed(s + h)
    x = torch.randn((b, s, h, p), generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g, device=dev))
    a = -torch.exp(0.3 * torch.randn((h,), generator=g, device=dev))
    bm, cm = (0.5 * torch.randn((b, s, n), generator=g, device=dev) for _ in range(2))
    y, st = so.ssd(x, dt, a, bm, cm, chunk=chunk)
    yr, sr = so.ssd_reference(x, dt, a, bm, cm, chunk=chunk)
    assert y.dtype == dtype and st.dtype == torch.float32
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-4
    _close(y.float(), yr.float(), tol * float(yr.float().abs().max()))
    _close(st, sr, tol * float(sr.abs().max()))
    y2, st2 = so.ssd(x, dt, a, bm, cm, chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(st, st2)  # no atomics: bit-repeatable


# K9 over many chunks (S = 4 100: 129 chunks of 32), with H not a multiple of
# the 8-head scan group, and P, N off the kernels' vector widths.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("b,s,h,p,n", [(1, 4100, 12, 64, 16), (2, 777, 3, 17, 5)])
def test_ssd_kernel_carries_the_state_over_many_chunks(dev, dtype, chunk, b, s, h, p, n):
    from repro_torch.kernels import ssd_ops as so

    g = torch.Generator(device=dev).manual_seed(s + chunk)
    x = torch.randn((b, s, h, p), generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g, device=dev))
    a = -torch.exp(0.3 * torch.randn((h,), generator=g, device=dev))
    bm, cm = (0.5 * torch.randn((b, s, n), generator=g, device=dev) for _ in range(2))
    y, st = so.ssd(x, dt, a, bm, cm, chunk=chunk)
    yr, sr = so.ssd_reference(x, dt, a, bm, cm, chunk=chunk)
    assert y.dtype == dtype and st.dtype == torch.float32
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-4
    _close(y.float(), yr.float(), tol * float(yr.float().abs().max()))
    _close(st, sr, tol * float(sr.abs().max()))
    y2, st2 = so.ssd(x, dt, a, bm, cm, chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(st, st2)  # no atomics: bit-repeatable


def test_lm_kernels_count_launches_and_refuse_what_they_do_not_take(dev):
    from repro_torch.kernels import flash_attention_ops as fa
    from repro_torch.kernels import ssd_ops as so
    from repro_torch.models import attention as attn

    q = torch.randn((1, 4, 64, 32), device=dev)
    x = torch.randn((1, 64, 2, 8), device=dev)
    dt, a = torch.rand((1, 64, 2), device=dev), -torch.rand((2,), device=dev)
    bm = torch.randn((1, 64, 4), device=dev)
    kernels.reset_launch_counts()
    first = fa.flash_attention(q, q[:, :2], q[:, :2])
    assert torch.equal(first, fa.flash_attention(q, q[:, :2], q[:, :2]))
    so.ssd(x, dt, a, bm, bm)
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == 2 and counts["ssd"] == 1
    with pytest.raises(NotImplementedError, match="softcap"):
        fa.flash_attention(q, q, q, softcap=30.0)
    with pytest.raises(NotImplementedError, match="softcap"):
        attn.attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2), causal=True,
                       softcap=30.0)
    with pytest.raises(ValueError, match="head dim"):  # K8 takes D up to 256
        fa.flash_attention(*(torch.zeros((1, 1, 8, 264), device=dev),) * 3)
    with pytest.raises(ValueError, match="shared memory"):
        so.ssd(torch.zeros((1, 8, 1, 64), device=dev), dt[:, :8, :1], a[:1],
               torch.zeros((1, 8, 128), device=dev), torch.zeros((1, 8, 128), device=dev),
               chunk=128)
    assert kernels.launch_counts() == counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_combine_repeats_bit_for_bit(dev, dtype):
    from repro_torch.models.moe import MoE

    m = MoE(256, 512, 16, 2, "swiglu", capacity_factor=1.25,
            generator=torch.Generator(device=dev).manual_seed(0), dtype=dtype, device=dev)
    x = torch.randn((2, 500, 256), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(dtype)
    out = m(x)
    for _ in range(2):
        assert torch.equal(out, m(x))
    if dtype == torch.float32:  # the card and the CPU route and combine alike
        cpu = m.to("cpu")(x.cpu()).to(dev)
        _close(out, cpu, 1e-4 * float(cpu.abs().max()))


def test_smoke_jamba_on_the_card_matches_the_cpu_and_runs_the_kernels(dev):
    import dataclasses

    from repro_torch.configs import get_config, smoke
    from repro_torch.models import LM
    from repro_torch.serving import ServeEngine, prefill, prefill_logits

    cfg = dataclasses.replace(smoke(get_config("jamba-v0.1-52b")), dtype="float32",
                              capacity_factor=16.0)
    lm_gpu, lm_cpu = LM(cfg, seed=2, device="cuda"), LM(cfg, seed=2, device="cpu")
    lm_cpu.load_state_dict({k: v.cpu() for k, v in lm_gpu.state_dict().items()})
    tokens = torch.randint(0, cfg.vocab_size, (2, 300), device=dev)
    kernels.reset_launch_counts()
    h = lm_gpu({"tokens": tokens})
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == 1 and counts["ssd"] == 7
    ref = lm_cpu({"tokens": tokens.cpu()}).to(dev)
    _close(h, ref, 2e-4 * float(ref.abs().max()))
    # decode on the card reproduces its forward and launches no LM kernel
    want = prefill_logits(lm_gpu, {"tokens": tokens[:, :24]})
    kernels.reset_launch_counts()
    got, _ = prefill(lm_gpu, tokens[:, :24], 24)
    assert kernels.launch_counts()["flash_attention"] == 0
    _close(got, want.float(), 5e-3 * float(want.abs().max()))
    eng = ServeEngine(lm_gpu, max_len=32, batch_slots=2)
    eng.add_request(0, [3, 4, 5])
    for _ in range(4):
        eng.step()
    assert len(eng.finish(0)) == 5


# -- KRR serving, streaming, durable and online FALKON on the card -------------------


def test_device_chunks_from_pinned_memory_equal_the_device_resident_result(dev):
    # Sixteen distinct chunks copied from pinned host memory on a side stream
    # while K1 (and the product after it) reads the previous one: a chunk
    # block handed back to the allocator before the consumer's stream is done
    # with it (no record_stream) would give other bits than the slices of the
    # same rows already on the card.
    from repro_torch.stream import ChunkStore, StreamBackend

    x, z, v, _ = _inputs(dev, 1 << 20, 2048, 18, 3)
    store = ChunkStore(x, chunk=1 << 16)
    assert store.x.is_pinned() and store.n_chunks == 16
    sb = StreamBackend(inner=core.CudaBackend(), chunk=1 << 16)
    kern = core.make_kernel("gaussian", sigma=4.0)
    want = sb.knm_matvec(kern, x, z, v)
    kernels.reset_launch_counts()
    for _ in range(3):
        assert torch.equal(sb.knm_matvec(kern, store, z, v), want)
    assert kernels.launch_counts()["gram"] == 3 * 16
    op = sb.knm_quadratic(kern, store, z)
    assert torch.equal(op(v), sb.knm_quadratic(kern, x, z)(v))


def test_streamed_fit_matches_the_cuda_backend_fit(dev):
    from repro_torch.stream import ChunkStore

    x, z, _, _ = _inputs(dev, 40_000, 256, 8, 1)
    y = torch.sin(2 * x[:, 0]) + 0.3 * x[:, 1]
    kern = core.make_kernel("gaussian", sigma=2.0)
    ref = core.falkon_fit(kern, x, y, x[:256], 1e-4, iters=20, backend=core.CudaBackend())
    fit = core.falkon_fit(kern, ChunkStore(x, y, chunk=4096), y, x[:256], 1e-4, iters=20,
                          backend="stream:cuda")
    want = ref.predict(x[:4096])
    _close(fit.predict(x[:4096]), want, 1e-3 * float(want.abs().max()))


def test_async_krr_server_round_on_the_card(dev):
    from repro_torch.serving import AsyncKrrServer, RequestStatus, ServeConfig
    from repro_torch.testing import faults

    x, _, _, _ = _inputs(dev, 4000, 48, 6, 1)
    kern = core.make_kernel("gaussian", sigma=1.5)
    model = core.falkon_fit(kern, x, torch.sin(2 * x[:, 0]), x[:48], 1e-3, iters=15)
    g = torch.Generator().manual_seed(0)
    reqs = [torch.randn((int(r), 6), generator=g) for r in torch.randint(1, 65, (40,), generator=g)]
    srv = AsyncKrrServer(model, config=ServeConfig(max_wave=256, min_bucket=16))
    rids = [srv.submit(q) for q in reqs]
    kernels.reset_launch_counts()
    with faults.fault("gram.nan_tile", times=1):
        srv.run_until_idle()
    assert kernels.launch_counts()["knm_matvec"] == srv.stats["dispatches"]
    assert srv.stats["wave_failures"] == 1 and srv.stats["splits"] >= 1
    for rid, q in zip(rids, reqs):
        assert srv.status(rid) == RequestStatus.DONE
        want = model.predict(q.to(dev))
        _close(srv.result(rid), want, 1e-4 * float(want.abs().max()))


def test_durable_resume_is_bit_identical_on_the_card(dev, tmp_path):
    from repro_torch.online import resumable_streamed_fit
    from repro_torch.stream import ChunkStore
    from repro_torch.testing import faults

    x, _, _, _ = _inputs(dev, 40_000, 8, 6, 1)
    store = ChunkStore(x, torch.sin(2 * x[:, 0]), chunk=4096)  # 10 chunks
    kern = core.make_kernel("gaussian", sigma=1.5)
    kw = dict(centers=x[:300], lam=1e-4, iters=20, backend="stream:cuda", ckpt_every=3)
    whole = resumable_streamed_fit(kern, store, ckpt_dir=str(tmp_path / "whole"), **kw)
    with faults.fault("ckpt.torn_write", stage="pre_rename", skip=1, times=1):
        with pytest.raises(faults.FaultInjected):
            resumable_streamed_fit(kern, store, ckpt_dir=str(tmp_path / "killed"), **kw)
    resumed = resumable_streamed_fit(kern, store, ckpt_dir=str(tmp_path / "killed"), **kw)
    assert torch.equal(resumed.alpha, whole.alpha) and resumed.alpha.device.type == "cuda"


def test_fused_plan_captures_once_per_bucket_and_replays_its_eager_body(dev):
    from repro_torch.core import falkon as fm

    x, _, _, _ = _inputs(dev, 20_000, 64, 6, 1)
    y = torch.sin(2 * x[:, 0])
    kern = core.make_kernel("gaussian", sigma=1.5)
    t0 = fm._FUSED_FIT_TRACES
    first = core.falkon_fit(kern, x, y, x[:64], 1e-3, iters=17, backend="torch")
    assert fm._FUSED_FIT_TRACES == t0 + 1
    kept = first.alpha.clone()
    # a new n in the bucket, a new lam and a new bandwidth: no new capture,
    # and each takes effect: refereed by an fp64 host-loop fit on the same
    # inputs, the fused fit no farther from it than the fp32 host loop, plus
    # 1e-3 of max|pred| (both fp32 paths converge to fp32 noise, where they
    # part by ~1e-3)
    xs = x[:4096]
    for k2, n, lam in ((kern, 19_000, 1e-3), (kern, 20_000, 1e-4),
                       (core.make_kernel("gaussian", sigma=2.5), 20_000, 1e-3)):
        fused = core.falkon_fit(k2, x[:n], y[:n], x[:64], lam, iters=17, backend="torch")
        host = core.falkon_fit(k2, x[:n], y[:n], x[:64], lam, iters=17, backend="torch",
                               fused=False)
        ref = core.falkon_fit(k2, x[:n].double(), y[:n].double(), x[:64].double(), lam,
                              iters=17, backend="torch", fused=False).predict(xs.double())

        def dist(m):
            return float((m.predict(xs).double() - ref).abs().max()) / float(ref.abs().max())

        assert dist(fused) <= dist(host) + 1e-3, (dist(fused), dist(host))
    assert fm._FUSED_FIT_TRACES == t0 + 1 and torch.equal(first.alpha, kept)
    plan = [p for k, p in fm._FUSED_PLANS.items() if k[4] == 17 and k[8] == x.device][0]
    replay = plan.run()[0].clone()
    eager = plan.eager()[0]
    assert float((replay - eager).abs().max()) <= 1e-6 * float(eager.abs().max())
    with pytest.raises(ValueError, match="graph-safe"):
        core.falkon_fit(kern, x, y, x[:64], 1e-3, backend=core.CudaBackend(), fused=True)


def test_sharded_world_of_one_on_nccl_is_the_cuda_backend_bitwise(dev, tmp_path):
    import torch.distributed as dist

    from repro_torch.core.backend import ShardedBackend

    x, _, _, _ = _inputs(dev, 50_000, 300, 18, 1)
    y = torch.sin(2 * x[:, 0])
    kern = core.make_kernel("gaussian", sigma=4.0)
    want = core.falkon_fit(kern, x, y, x[:300], 1e-5, iters=15, backend="cuda")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv", rank=0, world_size=1)
    try:
        kernels.reset_launch_counts()
        before = ShardedBackend.collectives
        got = core.falkon_fit(kern, x, y, x[:300], 1e-5, iters=15, backend=ShardedBackend())
        launches = kernels.launch_counts()
        assert ShardedBackend.collectives > before
        assert isinstance(core.default_backend(n=1 << 20), core.CudaBackend)  # one rank
    finally:
        dist.destroy_process_group()
    assert torch.equal(got.alpha, want.alpha)
    assert launches["falkon_matvec"] == 15 and launches["knm_t"] == 1


def test_guarded_happy_path_is_the_cuda_backend(dev):
    from repro_torch.core import health
    from repro_torch.core.backend import GuardedBackend

    x, _, _, _ = _inputs(dev, 30_000, 200, 18, 1)
    y = torch.sin(2 * x[:, 0])
    kern = core.make_kernel("gaussian", sigma=4.0)
    health.clear_events()
    counts = []
    fits = []
    for be in (core.CudaBackend(), GuardedBackend()):
        kernels.reset_launch_counts()
        fits.append(core.falkon_fit(kern, x, y, x[:200], 1e-5, iters=12, backend=be))
        counts.append(kernels.launch_counts())
    assert torch.equal(fits[0].alpha, fits[1].alpha)
    assert counts[0] == counts[1] and counts[1]["falkon_matvec"] == 12
    assert health.events("backend_fallback") == []


def test_guarded_refuses_the_plain_fallback_on_the_card(dev):
    # a primary that dies on the card: the failure is recorded and re-raised,
    # and no plain version serves the card's tensors
    from repro_torch.core import health
    from repro_torch.core.backend import GuardedBackend
    from repro_torch.testing import faults

    x, _, _, _ = _inputs(dev, 20_000, 100, 8, 1)
    y = torch.sin(2 * x[:, 0])
    kern = core.make_kernel("gaussian", sigma=2.0)
    health.clear_events()
    gb = GuardedBackend(primary=faults.FaultyBackend(core.CudaBackend()))
    kernels.reset_launch_counts()
    with faults.fault("backend.error", skip=4, times=1) as f:  # the 3rd quadratic-op call
        with pytest.raises(faults.FaultInjected):
            core.falkon_fit(kern, x, y, x[:100], 1e-4, iters=8, backend=gb)
    events = health.events("backend_fallback")
    assert f.fired == 1 and [(e["method"], e["fallback"]) for e in events] == [
        ("knm_quadratic", None)]
    assert kernels.launch_counts()["falkon_matvec"] == 2
    health.clear_events()


# -- gradients through K8 and K9, training, and BLESS-Nystrom attention on the card ----------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal", [(1, 4, 2, 300, 64, True), (2, 8, 1, 129, 256, True),
                                                  (1, 4, 4, 200, 200, False)])
def test_flash_attention_gradient_is_the_plain_versions(dev, dtype, b, hq, hkv, s, d, causal):
    from repro_torch.kernels import flash_attention_ops as fa

    g = torch.Generator(device=dev).manual_seed(s + d)
    q, k, v = (torch.randn((b, h, s, d), generator=g, device=dev).to(dtype).requires_grad_(True)
               for h in (hq, hkv, hkv))
    go = torch.randn((b, hq, s, d), generator=g, device=dev).to(dtype)
    kernels.reset_launch_counts()
    out = fa.flash_attention(q, k, v, causal=causal)
    got = torch.autograd.grad(out, (q, k, v), go)
    assert kernels.launch_counts()["flash_attention"] == 1
    assert kernels.plain_counts()["flash_attention"] == {"cuda_calls": 1,
                                                         "backward_recomputes": 1}
    want = torch.autograd.grad(fa.flash_attention_reference(q, k, v, causal=causal), (q, k, v), go)
    for a, w in zip(got, want):  # the same function, recomputed: the same bits
        assert a.dtype == dtype and torch.equal(a, w)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    ref = fa.flash_attention_reference(q, k, v, causal=causal).float()
    _close(out.float(), ref, tol * float(ref.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_gradient_is_the_plain_versions(dev, dtype):
    from repro_torch.kernels import ssd_ops as so

    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((2, 200, 4, 32), generator=g, device=dev).to(dtype).requires_grad_(True)
    dt = torch.nn.functional.softplus(torch.randn((2, 200, 4), generator=g, device=dev))
    a = -torch.exp(0.3 * torch.randn((4,), generator=g, device=dev))
    bm, cm = ((0.5 * torch.randn((2, 200, 128), generator=g, device=dev)).to(dtype)
              for _ in range(2))
    ins = [t.requires_grad_(True) for t in (x, dt, a, bm, cm)]
    gy = torch.randn((2, 200, 4, 32), generator=g, device=dev).to(dtype)
    kernels.reset_launch_counts()
    y, _ = so.ssd(*ins, chunk=64)
    got = torch.autograd.grad(y, ins, gy)
    assert kernels.launch_counts()["ssd"] == 1
    assert kernels.plain_counts()["ssd"] == {"cuda_calls": 1, "backward_recomputes": 1}
    want = torch.autograd.grad(so.ssd_reference(*ins, chunk=64)[0], ins, gy)
    for a_, w in zip(got, want):
        assert torch.equal(a_, w)


def test_a_train_step_on_the_card_matches_the_cpus_and_runs_the_kernels(dev):
    import dataclasses

    from repro_torch.configs import get_config, smoke
    from repro_torch.data import SyntheticLM
    from repro_torch.models import LM
    from repro_torch.optim import OptConfig
    from repro_torch.training import make_train_step, train_state_init

    cfg = dataclasses.replace(smoke(get_config("jamba-v0.1-52b")), dtype="float32",
                              capacity_factor=16.0)
    lm_cpu = LM(cfg, seed=4, device="cpu")
    lm = LM(cfg, seed=4, device="cpu").to(dev)
    opt = OptConfig(peak_lr=1e-3, warmup=0)
    pipe = SyntheticLM(cfg.vocab_size, 2, 128, seed=1, device="cpu")
    states = [train_state_init(lm), train_state_init(lm_cpu)]
    steps = [make_train_step(lm, opt, loss_chunks=4), make_train_step(lm_cpu, opt, loss_chunks=4)]
    for i in range(2):
        b = pipe.batch_at(i)
        kernels.reset_launch_counts()
        states[0], m = steps[0](states[0], {k: v.to(dev) for k, v in b.items()})
        counts, plain = kernels.launch_counts(), kernels.plain_counts()
        states[1], mc = steps[1](states[1], b)
        assert abs(float(m["loss"]) - float(mc["loss"])) <= 1e-4 * float(mc["loss"])
        # one attention and seven Mamba layers, each twice (the remat recompute)
        assert counts["flash_attention"] == 2 and counts["ssd"] == 14
        assert all(c["cuda_calls"] == c["backward_recomputes"] for c in plain.values())


def test_nystrom_attention_on_the_card_matches_the_cpu(dev):
    from repro_torch.models import attention as attn

    g = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn((1, 2048, 8, 256), generator=g, device=dev)
    k, v = (torch.randn((1, 2048, 1, 256), generator=g, device=dev) for _ in range(2))
    out = attn.nystrom_attention(q, k, v, landmarks=256)
    ref = attn.nystrom_attention(q.cpu(), k.cpu(), v.cpu(), landmarks=256).to(dev)
    _close(out, ref, 1e-3 * float(ref.abs().max()))
    kc, vc = attn.bless_compress_cache(k, v, 256)
    kr, vr = attn.bless_compress_cache(k.cpu(), v.cpu(), 256)
    assert ({tuple(r) for r in kc[0, :, 0].cpu().tolist()}
            == {tuple(r) for r in kr[0, :, 0].tolist()})


def test_gpipe_on_two_gloo_ranks_sharing_the_card_matches_the_sequential_blocks(dev):
    # chip_smoke.py phase 16 (b) at a small width: two rank processes on the
    # card, the stage params' gradients and the collective bytes gated there
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    res = chip_smoke.gpipe("cuda", mb=(1, 64), cfg_overrides=dict(
        n_layers=4, d_model=128, ssm_state=16, ssm_headdim=32, vocab_size=512), timeout=300)
    assert res["out_err"] <= chip_smoke.PIPE_OUT_TOL
    assert res["grad_worst"] <= chip_smoke.PIPE_GRAD_TOL
    # 4 Mamba blocks, 2 per stage, (S + M - 1) = 5 steps on each rank
    assert res["rank_launches"] == [{"flash_attention": 0, "ssd": 10}] * 2
    assert all(b == {**b, **res["expected_bytes"]} for b in res["bytes"])
