"""The port's sampler slice against the reference, on the CPU: K5 and K6
(plain paths) against the Pallas kernels in interpret mode, the CUDA
backend's Eq. 3 methods on CPU tensors against ``PallasBackend(interpret=
True)``, per-level scores on center sets carried across from the JAX ladder,
the sampling primitives' distributions, the BLESS / BLESS-R accuracy bands
of ``tests/test_bless.py``, and FALKON-BLESS through the front door.

Tolerances: K5 and every score 5e-4 relative + 5e-5 (tests/test_backend.py's
form); K6 1e-4 of max|ref|; bf16 3e-2 of max|ref|; end to end 1e-3 of
max|pred| (DESIGN.md §10). The two packages draw different random numbers
from a seed, so draws are compared as distributions and scores on identical
center sets.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.api as japi
import repro.core as jcore
from repro.kernels.quadform import ops as jqf
from repro.kernels.rls_score import ops as jrls
from repro_torch import core
from repro_torch.api import (BlessRSampler, BlessSampler, ChenYangSampler, ExactRlsSampler,
                             FalkonRegressor, FitConfig, NystromRegressor, RecursiveRlsSampler,
                             SqueakSampler, TwoPassSampler)
from repro_torch.core import CudaBackend
from repro_torch.core import backend as backend_mod
from repro_torch.core.sampling import categorical, gumbel_topk
from repro_torch.interop import bless_result_from_numpy, center_set_from_numpy
from repro_torch.kernels import quadform_ops as qo
from repro_torch.kernels import rls_score_ops as ro

# both packages re-export the function ``bless`` under its module's name
jbless = importlib.import_module("repro.core.bless")
tbless = importlib.import_module("repro_torch.core.bless")

FAMILIES = ["gaussian", "laplacian", "linear", "matern32", "cauchy"]
LAM = 1e-3
TKERN = core.make_kernel("gaussian", sigma=2.0)
JKERN = jcore.make_kernel("gaussian", sigma=2.0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _scores_close(out, ref):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=5e-4, atol=5e-5)


def _max_close(out, ref, rel):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * np.abs(ref).max())


def _score_problem(r, m, d, kind, seed=0):
    """Candidates, a padded center set (the last tenth invalid) and the
    inverse W = (K_JJ * mask + diag(reg))^-1, built in float64 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((r, d)).astype(np.float32)
    z = rng.standard_normal((m, d)).astype(np.float32)
    mask = np.arange(m) < max(1, m - m // 10)
    lamn = 50.0
    reg = np.where(mask, lamn * (0.5 + rng.random(m)), 1.0).astype(np.float32)
    kern = jcore.make_kernel(kind, sigma=2.5)
    kjj = np.asarray(kern.cross(jnp.asarray(z), jnp.asarray(z)), np.float64)
    kjj = kjj * np.outer(mask, mask) + np.diag(reg)
    w = np.linalg.inv(kjj).astype(np.float32)
    return x, z, w, mask, reg, lamn


# -- K5 and K6 (plain paths) against the Pallas kernels ---------------------------

#: every family in fp32, bf16 on the gaussian; M on each side of 1024
CASES = ([(kind, m, False) for kind in FAMILIES for m in (200, 1100)]
         + [("gaussian", m, True) for m in (200, 1100)])


@pytest.mark.parametrize("kind,m,bf16", CASES)
def test_rls_score_plain_matches_pallas_kernel(kind, m, bf16):
    x, z, w, mask, _, lamn = _score_problem(96, m, 7, kind)
    ref = jrls.rls_score(jnp.asarray(x), jnp.asarray(z), jnp.asarray(w), jnp.asarray(mask),
                         jnp.asarray(lamn), 2.5, kind=kind, interpret=True, bf16=bf16)
    out = ro.rls_score(_t(x), _t(z), _t(w), _t(mask), lamn, 2.5, kind=kind, bf16=bf16)
    if bf16:
        _max_close(out.numpy(), ref, 3e-2)
    else:
        _scores_close(out.numpy(), ref)
    assert ro.rls_score.launches == 0  # CPU tensors never reach a launch


@pytest.mark.parametrize("kind,m,bf16", CASES)
def test_quadform_plain_matches_pallas_kernel(kind, m, bf16):
    x, z, w, mask, _, _ = _score_problem(130, m, 7, kind, seed=1)
    g = np.asarray(jcore.make_kernel(kind, sigma=2.5).cross(jnp.asarray(x), jnp.asarray(z)))
    g = (g * mask[None, :]).astype(np.float32)
    ref = jqf.quadform(jnp.asarray(g), jnp.asarray(w), interpret=True, bf16=bf16)
    out = qo.quadform(_t(g), _t(w), bf16=bf16)
    _max_close(out.numpy(), ref, 3e-2 if bf16 else 1e-4)


def test_score_wrappers_check_their_inputs():
    x, z, w, mask, _, lamn = _score_problem(8, 5, 3, "gaussian")
    with pytest.raises(ValueError, match="need x_cand"):
        ro.rls_score(_t(x), _t(z), _t(w[:4, :4]), _t(mask), lamn)
    with pytest.raises(ValueError, match="need G"):
        qo.quadform(_t(x), _t(w))
    assert qo.quadform(torch.zeros(0, 5), _t(w)).shape == (0,)
    # the plain versions are the wrappers' CPU path
    torch.testing.assert_close(ro.rls_score(_t(x), _t(z), _t(w), _t(mask), lamn),
                               ro.rls_score_reference(_t(x), _t(z), _t(w), _t(mask), lamn))


# -- the backend seam ----------------------------------------------------------------


@pytest.mark.parametrize("m", [300, 1100])
@pytest.mark.parametrize("kind", ["gaussian", "laplacian", "linear"])
def test_cuda_backend_scores_on_cpu_tensors_match_pallas_backend(kind, m, monkeypatch):
    # M <= 1024 goes through the fused K5; above it, K1 + K6 in row chunks
    # (the slab budget is cut so the 160 candidates take several chunks).
    monkeypatch.setattr(backend_mod, "QUADFORM_SLAB_BYTES", 4 * m * 48)
    x, z, _, mask, reg, lamn = _score_problem(160, m, 6, kind, seed=2)
    jk = jcore.make_kernel(kind, sigma=2.5, kappa_sq=50.0)
    tk = core.make_kernel(kind, sigma=2.5, kappa_sq=50.0)
    pal = jcore.PallasBackend(interpret=True)
    args = (jnp.asarray(x), jnp.asarray(z), jnp.asarray(mask), jnp.asarray(reg))
    targs = (_t(x), _t(z), _t(mask), _t(reg))
    _scores_close(CudaBackend().rls_scores(tk, *targs, lamn).numpy(),
                  pal.rls_scores(jk, *args, jnp.asarray(lamn)))
    _max_close(CudaBackend().masked_quadform(tk, *targs).numpy(),
               pal.masked_quadform(jk, *args), 5e-4)


def test_cuda_backend_keeps_mask_panels_for_k7():
    be, k = CudaBackend(), core.make_kernel()
    x = torch.zeros(4, 2)
    with pytest.raises(NotImplementedError, match="K7"):
        be.knm_t(k, x, x, torch.ones(4), mask=torch.ones(4))


# -- per-level scores on center sets carried across ------------------------------------


@pytest.fixture(scope="module")
def jax_ladder(clustered_data):
    """The reference's Alg. 1 ladder on the clustered data, and its levels
    carried across into the port."""
    res = jcore.bless(jax.random.PRNGKey(0), clustered_data, JKERN, LAM, backend="jnp")
    port = bless_result_from_numpy(
        [(lvl.lam, *map(np.asarray, lvl.centers), lvl.d_h, lvl.m_h, lvl.r_h)
         for lvl in res.levels], res.lam_path)
    return np.asarray(clustered_data), res, port


def _distinct(cs) -> int:
    return int(np.unique(np.asarray(cs.idx)[np.asarray(cs.mask)]).size)


@pytest.mark.parametrize("backend", ["torch", CudaBackend()], ids=["torch", "cuda-plain"])
def test_per_level_scores_match_the_jax_ladder(jax_ladder, backend):
    x, res, port = jax_ladder
    n = x.shape[0]
    rng = np.random.default_rng(3)
    dup_levels = 0
    for h in range(1, len(res.levels)):
        jc, tc = res.levels[h - 1].centers, port.levels[h - 1].centers
        dup_levels += _distinct(jc) < int(jc.count)
        dbuf = jbless._bucket(_distinct(jc))
        lam_h = res.levels[h].lam
        cand = rng.integers(0, n, 200)
        cmask = np.arange(200) < 180
        ref = jbless._rls_dedup(JKERN, jnp.asarray(x[cand]), jnp.asarray(cmask),
                                jnp.asarray(x), jc, jnp.asarray(lam_h * n, jnp.float32),
                                backend=jcore.JnpBackend(), dbuf=dbuf)
        out = tbless._rls_dedup(TKERN, _t(x[cand]), _t(cmask), _t(x), tc, lam_h * n,
                                backend=core.resolve_backend(backend), dbuf=dbuf)
        _scores_close(out.numpy(), ref)
        ref = jcore.approx_rls(JKERN, jnp.asarray(x[cand]), jnp.asarray(cmask),
                               jnp.asarray(x), jc, jnp.asarray(lam_h), backend="jnp")
        out = core.approx_rls(TKERN, _t(x[cand]), _t(cmask), _t(x), tc, lam_h,
                              backend=backend)
        _scores_close(out.numpy(), ref)
    assert dup_levels >= 3  # the Alg. 1 multisets carry duplicates


@pytest.mark.parametrize("h", [4, 9])
def test_score_phase_matches_in_both_count_regimes(jax_ladder, h):
    # level 4 draws R_h = 48 < n candidates; level 9 has R_h >= n and scores
    # every point once, carrying multiplicities (the ``counts`` regime)
    x, res, port = jax_ladder
    n = x.shape[0]
    lvl = res.levels[h]
    rbuf = jbless._bucket(lvl.r_h)
    counts = n <= rbuf
    assert counts == (h == 9)
    dbuf = jbless._bucket(_distinct(res.levels[h - 1].centers))
    cand, s, wvec, _, d_dev = jbless._bless_score_impl(
        jax.random.PRNGKey(h), jnp.asarray(x), JKERN, res.levels[h - 1].centers,
        jnp.asarray(lvl.lam, jnp.float32), jnp.asarray(lvl.r_h, jnp.int32),
        backend=jcore.JnpBackend(), rbuf=rbuf, dbuf=dbuf, counts=counts)
    tcand, ts, twvec, _, _ = tbless._bless_score(
        torch.Generator().manual_seed(h), _t(x), TKERN, port.levels[h - 1].centers, lvl.lam,
        lvl.r_h, backend=CudaBackend(), rbuf=rbuf, dbuf=dbuf, counts=counts)
    assert ts.shape == s.shape and twvec.shape == wvec.shape
    if counts:  # every point in order: the scores themselves agree
        np.testing.assert_array_equal(tcand.numpy(), np.arange(n))
        _scores_close(ts.numpy(), s)
        assert int(twvec.gt(0).sum()) <= lvl.r_h and float(twvec.sum()) > 0
    else:  # other random candidates: score the port's against the reference
        ref = jbless._rls_dedup(JKERN, jnp.asarray(x[tcand.numpy()]),
                                jnp.arange(rbuf) < lvl.r_h, jnp.asarray(x),
                                res.levels[h - 1].centers,
                                jnp.asarray(lvl.lam * n, jnp.float32),
                                backend=jcore.JnpBackend(), dbuf=dbuf)
        _scores_close(ts.numpy(), ref)


def test_dedup_merges_duplicates_harmonically():
    cs = center_set_from_numpy(np.array([5, 3, 5, 7, 3, 5, 0, 0]),
                               np.array([1, 2, 4, 1, 2, 1, 1, 1], np.float32),
                               np.arange(8) < 6, 6)
    idx, mask, reg = tbless._dedup_centers(cs, 2.0, 4)
    jidx, jmask, jreg = jbless._dedup_centers(
        jcore.CenterSet(*(jnp.asarray(np.asarray(a)) for a in cs)), 2.0, 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(reg.numpy(), np.asarray(jreg), rtol=1e-6)
    np.testing.assert_allclose(reg.numpy()[:3], [2.0, 1 / (1 / 2 + 1 / 8 + 1 / 2), 2.0],
                               rtol=1e-6)


# -- sampling primitives: chi-square in the mold of tests/test_scenarios.py ------------

_CHI2_99 = {  # chi-square 0.99 critical values by degrees of freedom
    3: 11.34, 4: 13.28, 5: 15.09, 6: 16.81, 7: 18.48, 9: 21.67, 11: 24.72,
    15: 30.58, 19: 36.19, 23: 41.64, 31: 52.19,
}


def _chi2_bound(df: int) -> float:
    """0.99 critical value, padded 1.5x as tests/test_scenarios.py does."""
    return 1.5 * _CHI2_99.get(df, df + 2.33 * (2 * df) ** 0.5)


@settings(max_examples=12, deadline=None, derandomize=True)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1),
       r=st.integers(min_value=4, max_value=24))
def test_categorical_frequencies_match_choice(seed, r):
    """Inverse-CDF draws follow p = w / sum(w) within a chi-square bound —
    the same bound np.random.choice itself satisfies — and zero-weight
    slots are never selected."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.1, 3.0, size=r).astype(np.float32)
    w[rng.integers(0, r)] = 0.0
    m = 8000
    p = w / w.sum()
    live = p > 0
    expected = m * p[live]
    df = int(live.sum()) - 1
    idx = categorical(seed, _t(w), m).numpy()
    assert idx.shape == (m,) and idx.min() >= 0 and idx.max() < r
    counts = np.bincount(idx, minlength=r)
    assert counts[w == 0.0].sum() == 0
    stat = float(np.sum((counts[live] - expected) ** 2 / expected))
    assert stat < _chi2_bound(df), (seed, r, stat, df)
    ref = np.bincount(rng.choice(r, size=m, p=p), minlength=r)
    ref_stat = float(np.sum((ref[live] - expected) ** 2 / expected))
    assert ref_stat < _chi2_bound(df), (seed, r, ref_stat, df)


@settings(max_examples=12, deadline=None, derandomize=True)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1),
       r=st.integers(min_value=6, max_value=32),
       k=st.integers(min_value=1, max_value=6))
def test_gumbel_topk_is_without_replacement(seed, r, k):
    k = min(k, r - 2)
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.1, 3.0, size=r).astype(np.float32)
    dead = rng.integers(0, r)
    w[dead] = 0.0
    idx = gumbel_topk(seed, _t(w), k).numpy()
    assert idx.shape == (k,) and len(set(idx.tolist())) == k
    assert idx.min() >= 0 and idx.max() < r and dead not in idx


def test_gumbel_topk_uniform_scores_are_permutation_distributed():
    """On uniform weights each index lands in each output position equally
    often (chi-square on the first and last position's marginals)."""
    r, k, trials = 8, 3, 4000
    gen = torch.Generator().manual_seed(5)
    draws = np.stack([gumbel_topk(gen, torch.ones(r), k).numpy() for _ in range(trials)])
    for pos in (0, k - 1):
        counts = np.bincount(draws[:, pos], minlength=r)
        stat = float(np.sum((counts - trials / r) ** 2 / (trials / r)))
        assert stat < _chi2_bound(r - 1), (pos, stat)
    assert all(len(set(row.tolist())) == k for row in draws)


def test_gumbel_topk_weighted_draws_favor_heavy_slots():
    w = torch.tensor([10.0, 1.0, 1.0, 1.0, 10.0, 1.0])
    gen = torch.Generator().manual_seed(0)
    hits = np.zeros(6)
    for _ in range(200):
        hits[gumbel_topk(gen, w, 2).numpy()] += 1
    assert hits[0] + hits[4] > hits[1] + hits[2] + hits[3] + hits[5]


# -- ladder constants ----------------------------------------------------------------


@pytest.mark.parametrize("x", [1, 7, 32, 33, 100, 1045, 4097, 10_000])
def test_buckets_match_reference(x):
    assert tbless._bucket(x) == jbless._bucket(x)
    assert tbless._bucket32(x) == jbless._bucket32(x)


def test_ladder_and_theory_constants_match_reference():
    for args in ((1e-3, 1.0, 2.0), (1e-4, 1.0, 2.0), (1e-6, 50.0, 3.0)):
        assert tbless.lam_ladder(*args) == jcore.lam_ladder(*args)
    assert len(tbless.lam_ladder(1e-3, 1.0, 2.0)) == 10
    assert tbless.theory_constants(1.0, 2.0, 1000, 10) == jcore.theory_constants(
        1.0, 2.0, 1000, 10)


# -- BLESS / BLESS-R accuracy: tests/test_bless.py's bands ------------------------------


@pytest.fixture(scope="module")
def exact_scores(clustered_data):
    x = _t(clustered_data)
    return x, {lam: core.exact_rls(TKERN, x.double(), lam).float()
               for lam in (LAM, 2 * LAM, 4 * LAM)}


@pytest.mark.parametrize("algo", ["bless", "bless_r"])
def test_multiplicative_accuracy(exact_scores, algo):
    x, ell = exact_scores
    if algo == "bless":
        res = core.bless(0, x, TKERN, LAM, q1=4.0, q2=4.0, backend=CudaBackend())
    else:
        res = core.bless_r(0, x, TKERN, LAM, q2=4.0, backend=CudaBackend())
    racc = (res.scores(TKERN, x, backend="torch") / ell[LAM]).numpy()
    assert 0.8 < racc.mean() < 1.4
    assert np.quantile(racc, 0.02) > 1 / 3.0
    assert np.quantile(racc, 0.98) < 3.0


def test_thm1b_size_bound_and_path_accuracy(exact_scores):
    x, ell = exact_scores
    q2 = 3.0
    res = core.bless(1, x, TKERN, LAM, q1=3.0, q2=q2, backend="torch")
    for lvl in res.levels[2:]:
        deff_h = float(torch.sum(core.exact_rls(TKERN, x.double(), lvl.lam)))
        assert lvl.m_h <= q2 * max(10 * 2.0, 3 * 2.0 * deff_h) + 8, (lvl.lam, lvl.m_h)
    res = core.bless(2, x, TKERN, LAM, q1=4.0, q2=4.0, backend="torch")
    for lvl in (res.levels[-3], res.levels[-1]):
        ell_h = ell[LAM] if lvl.lam == LAM else core.exact_rls(TKERN, x.double(), lvl.lam)
        s = core.approx_rls_all(TKERN, x, lvl.centers, lvl.lam, backend="torch")
        assert 0.6 < float(torch.median(s / ell_h.float())) < 1.8, lvl.lam


@pytest.mark.parametrize("algo", ["bless", "bless_r"])
def test_final_d_h_tracks_the_jax_ladder(clustered_data, algo):
    # d_h is a random estimate (one seed's BLESS-R d_h spreads ~8 % here), so
    # the ladders are compared by their mean over four seeds each
    x = _t(clustered_data)
    refs = [getattr(jcore, algo)(jax.random.PRNGKey(s), clustered_data, JKERN, LAM,
                                 backend="jnp") for s in range(4)]
    ress = [getattr(core, algo)(s, x, TKERN, LAM, backend="torch") for s in range(4)]
    assert all(res.lam_path == refs[0].lam_path for res in ress)
    ref_d = np.mean([r.final.d_h for r in refs])
    d = np.mean([r.final.d_h for r in ress])
    assert abs(d - ref_d) < 0.1 * ref_d, (d, ref_d)
    assert all(r.final.centers.idx.shape[0] == tbless._bucket(r.final.m_h) for r in ress)


@pytest.mark.parametrize("algo", ["bless", "bless_r"])
def test_ladders_are_deterministic_given_the_seed(clustered_data, algo):
    x = _t(clustered_data)
    fn = getattr(core, algo)
    a, b = fn(3, x, TKERN, LAM, backend="torch"), fn(3, x, TKERN, LAM, backend="torch")
    assert [lvl.m_h for lvl in a.levels] == [lvl.m_h for lvl in b.levels]
    assert torch.equal(a.final.centers.idx, b.final.centers.idx)
    assert torch.equal(a.final.centers.weight, b.final.centers.weight)
    c = fn(torch.Generator().manual_seed(3), x, TKERN, LAM, backend="torch")
    assert torch.equal(a.final.centers.idx, c.final.centers.idx)
    assert not torch.equal(a.final.centers.idx, fn(4, x, TKERN, LAM, backend="torch")
                           .final.centers.idx)


# -- the other samplers on the same seam --------------------------------------------------


@pytest.mark.parametrize("sampler", [
    TwoPassSampler(lam=LAM, m2=300), RecursiveRlsSampler(lam=LAM, m_cap=400),
    SqueakSampler(lam=LAM, m_cap=400), ExactRlsSampler(m=300, lam=LAM),
    ChenYangSampler(m=300, lam=LAM)], ids=lambda s: type(s).__name__)
def test_baseline_samplers_produce_usable_scores(exact_scores, sampler):
    x, ell = exact_scores
    cs = sampler.sample(4, x, TKERN, backend=CudaBackend())
    m = int(cs.count)
    assert cs.idx.shape[0] == tbless._bucket(m) and bool(torch.all(cs.mask[:m]))
    assert bool(torch.all(cs.weight[:m] > 0)) and int(cs.idx[:m].max()) < x.shape[0]
    racc = (core.approx_rls_all(TKERN, x, cs, LAM, backend="torch") / ell[LAM]).numpy()
    assert 0.5 < np.median(racc) < 2.0


def test_chen_yang_scores_track_exact_rls():
    # the data of tests/test_rls_score.py's own check (``_ladder_data``)
    centers = jax.random.normal(jax.random.PRNGKey(3), (8, 4)) * 3.0
    assign = jax.random.randint(jax.random.PRNGKey(4), (220,), 0, 8)
    x = _t(centers[assign] + 0.3 * jax.random.normal(jax.random.PRNGKey(5), (220, 4)))
    kern = core.make_kernel("gaussian", sigma=1.5)
    est = core.fast_spectral_rls(0, kern, x, 1e-2, backend="torch").numpy()
    exact = core.exact_rls(kern, x.double(), 1e-2).numpy()
    assert est.shape == (220,) and np.all(est > 0.0) and np.all(est <= 1.0 + 1e-6)
    assert 1 / 3 < np.median(est / exact) < 3.0 and np.corrcoef(est, exact)[0, 1] > 0.5


# -- FALKON-BLESS through the front door ----------------------------------------------------


def _problem(n=1024, n_test=256, d=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n + n_test, d)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + 0.3 * x[:, 1] ** 2).astype(np.float32)
    return x[:n], y[:n], x[n:], y[n:]


CPU = FitConfig(lam=LAM, iters=30, device="cpu")


def test_falkon_on_carried_bless_centers_matches_reference():
    x, y, xte, _ = _problem()
    cs = japi.BlessSampler(lam=LAM, m_cap=200).sample(jax.random.PRNGKey(0), jnp.asarray(x),
                                                      JKERN, backend="jnp")
    assert int(np.unique(np.asarray(cs.idx)[np.asarray(cs.mask)]).size) < int(cs.count)
    ref = japi.FalkonRegressor(kernel=JKERN, config=japi.FitConfig(
        lam=LAM, iters=CPU.iters, backend=jcore.PallasBackend(interpret=True)))
    ref.fit(jnp.asarray(x), jnp.asarray(y), center_set=cs)
    est = FalkonRegressor(kernel=TKERN, config=CPU)
    est.fit(x, y, center_set=center_set_from_numpy(*map(np.asarray, cs)))
    _max_close(est.predict(xte).numpy(), ref.predict(jnp.asarray(xte)), 1e-3)


def test_default_sampler_is_bless_and_fits_on_the_cpu():
    x, y, xte, yte = _problem(n=600)
    est = FalkonRegressor(kernel=TKERN, config=CPU)
    assert est.sampler == BlessSampler() and NystromRegressor().sampler == BlessSampler()
    est.fit(x, y)
    assert est.center_set_.idx.shape[0] == tbless._bucket(int(est.center_set_.count))
    pred, std = est.predict(xte, return_std=True)
    assert est.score(xte, yte) > 0.5 and bool(torch.all(std >= 0))
    nys = NystromRegressor(kernel=TKERN, sampler=BlessRSampler(lam=1e-2), config=CPU).fit(x, y)
    assert nys.score(xte, yte) > 0.5


def test_falkon_bless_fit_equals_the_front_door_bitwise():
    x, y, _, _ = _problem(n=400)
    est = FalkonRegressor(kernel=TKERN, sampler=BlessSampler(lam=LAM, q2=3.0, m_cap=200),
                          config=FitConfig(lam=1e-5, iters=15, backend="torch", device="cpu"))
    est.fit(x, y, key=11)
    ref = core.falkon_bless_fit(11, TKERN, _t(x), _t(y), LAM, 1e-5, iters=15, q2=3.0,
                                m_cap=200, backend="torch", device="cpu")
    assert torch.equal(est.model_.centers, ref.centers)
    assert torch.equal(est.model_.alpha, ref.alpha)
