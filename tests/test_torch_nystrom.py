"""BLESS-Nystrom attention in the PyTorch port against the reference.

The same numpy inputs, made from a seed, go through the reference's
``repro.models.attention`` functions (JAX on the CPU) and the port's
``repro_torch.models.attention`` in one process. Tolerances: the RLS scores
5e-4 relative + 5e-5 (tests/test_backend.py's form); the Newton-Schulz
pseudo-inverse 1e-5 * max; Nystrom attention 1e-3 * max|out| in fp32; the
landmark sets and the compressed caches equal (the port breaks ties as
``jax.lax.top_k`` does, lower index first, so even the order agrees); an LM
forward through Nystrom attention 5e-3 * max|logit|. The reference's four
property tests (tests/test_attention.py) are ported beside them.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import attention as ja
from repro.models import forward as jforward
from repro.models import init_params, logits_fn
from repro_torch import configs, kernels
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import LM
from repro_torch.models import attention as ta
from repro_torch.serving import prefill_logits

SCORE_RTOL, SCORE_ATOL = 5e-4, 5e-5
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # one intra-op thread: these small shapes gain nothing from more, and
    # the suite runs several workers side by side on the machine's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng(seed):
    return np.random.default_rng(seed)


def _qkv(b, s, hq, hkv, d, seed, scale=0.5):
    r = _rng(seed)
    q = (r.standard_normal((b, s, hq, d)) * scale).astype(np.float32)
    k = (r.standard_normal((b, s, hkv, d)) * scale).astype(np.float32)
    v = r.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- the five functions against the reference ------------------------------------------------


@pytest.mark.parametrize("s,d,m_pilot,lam", [(128, 16, 32, 1e-3), (300, 32, 128, 1e-3),
                                             (1000, 64, 128, 1e-4), (77, 8, 256, 1e-2)])
def test_rls_scores_one_rung_matches_reference(s, d, m_pilot, lam):
    keys = _rng(s).standard_normal((s, d)).astype(np.float32)
    want = np.asarray(ja.rls_scores_one_rung(jnp.asarray(keys), m_pilot, lam))
    got = ta.rls_scores_one_rung(torch.from_numpy(keys), m_pilot, lam).numpy()
    assert got.shape == (s,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_rls_scores_batch_over_leading_axes_as_the_reference_vmaps():
    keys = _rng(3).standard_normal((2, 3, 200, 16)).astype(np.float32)
    want = np.asarray(jax.vmap(jax.vmap(lambda kh: ja.rls_scores_one_rung(kh, 64, 1e-3)))(
        jnp.asarray(keys)))
    got = ta.rls_scores_one_rung(torch.from_numpy(keys), 64, 1e-3).numpy()
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.parametrize("s,d,m,m_pilot", [(256, 32, 64, 128), (96, 16, 32, 32),
                                           (512, 64, 100, 128)])
def test_bless_topm_landmarks_match_reference_as_sets_and_in_order(s, d, m, m_pilot):
    keys = (_rng(s + m).standard_normal((s, d)) * 0.5).astype(np.float32)
    want = np.asarray(ja.bless_topm_landmarks(jnp.asarray(keys), m, m_pilot=m_pilot))
    got = ta.bless_topm_landmarks(torch.from_numpy(keys), m, m_pilot=m_pilot).numpy()
    assert set(got.tolist()) == set(want.tolist())
    np.testing.assert_array_equal(got, want)  # ties (at the clip) to the lower index


def test_ties_at_the_clip_go_to_the_lower_index():
    # At S = 256 and lam = 1e-3 most scores clip to 1: the top m is the
    # first m indices among the tied ones, as jax.lax.top_k returns them
    keys = (_rng(0).standard_normal((256, 32)) * 0.5).astype(np.float32)
    scores = ta.rls_scores_one_rung(torch.from_numpy(keys), 128, 1e-3)
    assert int((scores == 1.0).sum()) > 64
    got = ta.bless_topm_landmarks(torch.from_numpy(keys), 64)
    tied = torch.nonzero(scores == 1.0)[:, 0]
    np.testing.assert_array_equal(got.numpy(), tied[:64].numpy())


@pytest.mark.parametrize("n,batch", [(32, ()), (100, (3,)), (64, (2, 4))])
def test_iterative_pinv_matches_reference(n, batch):
    a = np.abs(_rng(n).standard_normal(batch + (n, n))).astype(np.float32)
    a /= a.sum(-1, keepdims=True)  # row-stochastic, as the softmax kernel matrix is
    want = np.asarray(ja._iterative_pinv(jnp.asarray(a)))
    got = ta._iterative_pinv(torch.from_numpy(a)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("b,s,hq,hkv,d,m", [(2, 256, 4, 2, 32, 64), (1, 300, 8, 1, 64, 100),
                                             (2, 96, 4, 4, 16, 32), (1, 128, 2, 2, 32, 200)])
def test_nystrom_attention_matches_reference(b, s, hq, hkv, d, m):
    q, k, v = _qkv(b, s, hq, hkv, d, seed=s + m)
    want = np.asarray(ja.nystrom_attention(*map(jnp.asarray, (q, k, v)), landmarks=m))
    got = ta.nystrom_attention(*_t(q, k, v), landmarks=m)
    assert got.shape == (b, s, hq, d) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-3 * np.abs(want).max()


def test_nystrom_attention_keeps_the_input_dtype():
    q, k, v = _qkv(1, 96, 4, 2, 32, seed=5)
    out = ta.nystrom_attention(*(t.to(torch.bfloat16) for t in _t(q, k, v)), landmarks=32)
    assert out.dtype == torch.bfloat16 and bool(torch.all(torch.isfinite(out.float())))


@pytest.mark.parametrize("b,s,h,d,m,m_pilot", [(2, 128, 2, 16, 16, 32), (1, 500, 3, 32, 64, 256)])
def test_bless_compress_cache_matches_reference(b, s, h, d, m, m_pilot):
    r = _rng(s)
    k = (r.standard_normal((b, s, h, d)) * 0.3).astype(np.float32)
    v = r.standard_normal((b, s, h, d)).astype(np.float32)
    kc, vc = ja.bless_compress_cache(jnp.asarray(k), jnp.asarray(v), m, m_pilot=m_pilot)
    tk, tv = ta.bless_compress_cache(*_t(k, v), m, m_pilot=m_pilot)
    assert tk.shape == (b, m, h, d) and tv.shape == (b, m, h, d)
    for bi in range(b):
        for hi in range(h):  # the kept rows as sets, then in order
            assert ({tuple(row) for row in tk[bi, :, hi].numpy()}
                    == {tuple(row) for row in np.asarray(kc)[bi, :, hi]})
    np.testing.assert_array_equal(tk.numpy(), np.asarray(kc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(vc))


def test_bless_compress_cache_keeps_bf16_caches_bit_for_bit():
    k, v = _t(*(_rng(1).standard_normal((1, 64, 2, 16)).astype(np.float32) for _ in range(2)))
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    kc, vc = ta.bless_compress_cache(kb, vb, 8, m_pilot=16)
    assert kc.dtype == torch.bfloat16
    idx = ta.bless_topm_landmarks(kb.permute(0, 2, 1, 3), 8, m_pilot=16, lam=1e-4)
    assert torch.equal(kc[0, :, 0], kb[0, idx[0, 0], 0])
    assert torch.equal(vc[0, :, 1], vb[0, idx[0, 1], 1])


# -- the reference's property tests (tests/test_attention.py), ported --------------------


def test_rls_scores_valid():
    keys = torch.from_numpy(_rng(0).standard_normal((128, 16)).astype(np.float32))
    s = ta.rls_scores_one_rung(keys, m_pilot=32, lam=1e-3)
    assert s.shape == (128,)
    assert float(s.min()) > 0 and float(s.max()) <= 1.0


def test_nystrom_error_decreases_with_landmarks():
    q, k, v = _t(*_qkv(2, 256, 4, 2, 32, seed=0))
    exact = ta.attention(q, k, v, causal=False)
    errs = []
    for m in (16, 64, 192):
        approx = ta.nystrom_attention(q, k, v, landmarks=m)
        errs.append(float(torch.linalg.norm(approx - exact) / torch.linalg.norm(exact)))
    assert errs[2] < errs[0]
    assert errs[2] < 0.2


def test_nystrom_beats_uniform_landmarks_on_skewed_keys():
    """The paper's point: leverage-score landmarks capture rare-but-important
    directions that uniform sampling misses."""
    r = _rng(0)
    s, d = 256, 16
    kk = (r.standard_normal((s, d)) * 0.05).astype(np.float32)  # a tight cluster
    out_idx = np.arange(0, s, 20)  # 5 % outliers
    kk[out_idx] = (r.standard_normal((out_idx.shape[0], d)) * 2.0).astype(np.float32)
    kk = torch.from_numpy(kk)
    scores = ta.rls_scores_one_rung(kk, m_pilot=64, lam=1e-3)
    top = ta.bless_topm_landmarks(kk, 16, m_pilot=64, lam=1e-3)
    hit = np.isin(top.numpy(), out_idx).mean()
    assert float(hit) > 0.4  # outliers are high-leverage and get picked
    assert float(scores[out_idx].mean()) > 2.0 * float(scores.mean())


def test_bless_compress_cache_shapes_and_selection():
    b, s, h, d = 2, 128, 2, 16
    r = _rng(0)
    k = torch.from_numpy((r.standard_normal((b, s, h, d)) * 0.05).astype(np.float32))
    v = torch.from_numpy(r.standard_normal((b, s, h, d)).astype(np.float32))
    k[:, 7] = 5.0  # one very distinctive key
    kc, vc = ta.bless_compress_cache(k, v, m=16, m_pilot=32)
    assert kc.shape == (b, 16, h, d) and vc.shape == (b, 16, h, d)
    assert float(kc.abs().max()) >= 4.9  # the distinctive key survives compression


# -- the LM through BLESS-Nystrom attention ---------------------------------------------------


def _carried(name, **kw):
    kw = dict(dtype="float32", attention_impl="bless_nystrom", **kw)
    jcfg = dataclasses.replace(jconfigs.smoke(jconfigs.get_config(name)), **kw)
    tcfg = dataclasses.replace(configs.smoke(configs.get_config(name)), **kw)
    params = init_params(jcfg, jax.random.PRNGKey(0))
    lm = LM(tcfg, device="cpu")
    lm.load_state_dict(lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params)), strict=True)
    return jcfg, params, tcfg, lm


# dense (qwen3-32b: 4 heads over 4 in the smoke model, qk-norm), hybrid (Jamba: one
# attention layer of 8), MQA (gemma-2b: 4 q heads over 1 kv head) and GQA
# (phi3-mini's smoke model with 16 q heads over 4 kv heads: the reference pads
# no head there, so its grouping is the port's).
#
# S = 256 > 32 landmarks. The smoke models' keys lie far apart against the
# kernel's bandwidth, so their Gram matrix is close to the identity: at S <=
# m_pilot = 128 every key is a pilot and the scores lie closer together than
# the two packages' fp32 rounding differences, which then order the
# near-ties differently. At S = 256 the pilot is every other key and the
# others clip to 1, a tie both packages break by the lower index.
@pytest.mark.parametrize("name,kw", [("qwen3-32b", {}), ("jamba-v0.1-52b", {}), ("gemma-2b", {}),
                                     ("phi3-mini-3.8b", {"n_heads": 16, "n_kv_heads": 4})])
def test_lm_forward_through_nystrom_attention_matches_reference(name, kw):
    jcfg, params, tcfg, lm = _carried(name, **kw)
    assert tcfg.nystrom_landmarks == 32
    toks = _rng(1).integers(0, tcfg.vocab_size, (2, 256))
    want = jax.jit(jforward, static_argnums=1)(params, jcfg, {"tokens": jnp.asarray(toks)})
    want_logits = np.asarray(logits_fn(params, jcfg, want))
    got = lm.logits(lm({"tokens": torch.from_numpy(toks)}))
    assert np.abs(got.detach().numpy() - want_logits).max() <= 5e-3 * np.abs(want_logits).max()
    # and the exact path below the landmark count is the full model's
    short = torch.from_numpy(toks[:, :32])
    exact = LM(dataclasses.replace(tcfg, attention_impl="full"), device="cpu")
    exact.load_state_dict(lm.state_dict())
    assert torch.equal(prefill_logits(lm, {"tokens": short}),
                       prefill_logits(exact, {"tokens": short}))


def test_nystrom_lm_decode_keeps_the_full_cache_and_launches_nothing_on_the_cpu():
    _, _, tcfg, lm = _carried("qwen3-32b")
    kernels.reset_launch_counts()
    toks = torch.from_numpy(_rng(2).integers(0, tcfg.vocab_size, (1, 40)))
    assert bool(torch.all(torch.isfinite(prefill_logits(lm, {"tokens": toks}))))
    cache = lm.init_cache(1, 40)
    for t in range(40):
        logits = lm.decode_step(cache, toks[:, t], t, length=t + 1)
    assert cache[0]["k"].shape[1] == 40 and bool(torch.all(torch.isfinite(logits)))
    assert all(n == 0 for n in kernels.launch_counts().values())


def test_chip_smoke_phase_14_rehearses_on_the_cpu():
    import sys

    sys.path.insert(0, str(REPO))
    import chip_smoke

    cfg = dataclasses.replace(configs.smoke(configs.get_config("gemma-2b")), n_layers=2,
                              attention_impl="bless_nystrom", nystrom_landmarks=32)
    res = chip_smoke.nystrom("cpu", cfg, prompt=96, repeats=1)
    assert res["nystrom_logits_finite"] and res["exact_logits_finite"]
    assert res["layer"]["landmarks"] == {"differ": 0, "untied": 0}
    assert res["layer"]["err_over_max"] == 0.0 and res["compress"]["rows_equal_as_sets"]
    assert res["compress"]["shape"] == [1, 32, 1, 32]
    full = chip_smoke.nystrom_config()
    assert (full.n_layers, full.head_dim, full.nystrom_landmarks, full.dtype) == (
        18, 256, 1024, "bfloat16")
    # the edge rule: indices outside the other's set pass only as ties
    scores = torch.tensor([[0.9, 0.5, 0.5, 0.1]])
    same = chip_smoke._same_selection(torch.tensor([[0, 1]]), torch.tensor([[0, 2]]), scores)
    assert same == {"differ": 2, "untied": 0}
    assert chip_smoke._same_selection(torch.tensor([[0, 3]]), torch.tensor([[0, 1]]),
                                      scores)["untied"] == 1
