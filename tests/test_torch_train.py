"""LM training in the PyTorch port against the reference.

The same numpy inputs and weights (carried across by
``interop.lm_params_from_numpy``) go through the reference's
``repro.models.loss_fn``, ``repro.optim`` and ``repro.training`` (JAX on the
CPU) and the port's counterparts in one process. Tolerances: the custom
VJPs of ``rms_norm`` and ``lowp`` to the last bits of their dtype (1e-6
relative in fp32, bf16's 8 bits); ``loss_fn`` 1e-5 relative in fp32; its
gradient 1e-4 * max|g| over every parameter; ``adamw_update`` 1e-6 of the
values; the schedules 1e-7 absolute at a peak of 1; three train steps at
microbatches 1 and 2, losses 1e-4 relative. The data pipeline draws with
torch's generator where the reference draws with threefry, so it is held to
the reference's own tests (determinism, resume, shapes, learnability), not to
its numbers. The reference's tests/test_optim_data.py and
test_system.py::test_lm_trains_checkpoints_and_serves are ported beside.
"""
import dataclasses
import pathlib
import re
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.configs as jconfigs
from repro.models import init_params
from repro.models import layers as jlayers
from repro.models import loss_fn as jloss_fn
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import schedules as jschedules
from repro.training import make_train_step as jmake_train_step
from repro.training import train_state_init as jtrain_state_init
from repro_torch import configs, kernels
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.data import SyntheticLM, TokenPipeline
from repro_torch.interop import lm_params_from_numpy
from repro_torch.kernels import flash_attention_ops as fa
from repro_torch.kernels import ssd_ops as so
from repro_torch.models import LM, layers, loss_fn
from repro_torch.optim import OptConfig, adamw_init, adamw_update, global_norm
from repro_torch.optim.schedules import cosine_schedule, make_schedule, wsd_schedule
from repro_torch.serving import prefill, sample_greedy
from repro_torch.training import (TrainState, copy_state_, loss_and_grads, make_train_step,
                                  train_state_init)

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


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t).astype(jnp.float32))


def _cfg(name, **kw):
    kw = dict(dtype="float32", **kw)
    return (dataclasses.replace(jconfigs.smoke(jconfigs.get_config(name)), **kw),
            dataclasses.replace(configs.smoke(configs.get_config(name)), **kw))


def _carried(name, **kw):
    """(reference cfg, params, port cfg, port LM on the CPU with the same weights)."""
    jcfg, tcfg = _cfg(name, **kw)
    params = init_params(jcfg, jax.random.PRNGKey(0))
    lm = LM(tcfg, device="cpu")
    lm.load_state_dict(lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params)), strict=True)
    return jcfg, params, tcfg, lm


def _batch(cfg, b, s, seed=1):
    toks = _rng(seed).integers(0, cfg.vocab_size, (b, s + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


# -- the custom VJPs --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 5, 16), (3, 7, 4, 32)])
def test_rms_norm_and_lowp_gradients_match_jax_vjp(dtype, shape):
    r = _rng(len(shape))
    x = r.standard_normal(shape).astype(np.float32)
    gamma = (0.1 * r.standard_normal(shape[-1:])).astype(np.float32)
    dy = r.standard_normal(shape).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jg, jdy = (jnp.asarray(a).astype(jd) for a in (x, gamma, dy))
    tx, tg, tdy = (torch.from_numpy(a).to(td).requires_grad_(True) for a in (x, gamma, dy))
    out, vjp = jax.vjp(lambda a, g: jlayers.rms_norm(a, g, 1e-6), jx, jg)
    jdx, jdg = vjp(jdy)
    tout = layers.rms_norm(tx, tg, 1e-6)
    tdx, tdg = torch.autograd.grad(tout, (tx, tg), tdy.detach())
    assert tout.dtype == td and tdx.dtype == td and tdg.dtype == td
    rtol = 1e-6 if dtype == "float32" else 2 ** -7
    for a, b in ((tout, out), (tdx, jdx), (tdg, jdg)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=rtol * np.abs(_np(b)).max())
    # lowp: the identity, its cotangent cast to the forward dtype (an fp32
    # cotangent handed to the rule directly, as XLA's reordering would)
    lo_out, lo_vjp = jax.vjp(jlayers.lowp, jx)
    (jdl,) = lo_vjp(jdy)
    tl = layers.lowp(tx)
    (tdl,) = torch.autograd.grad(tl, tx, tdy.detach())
    assert tdl.dtype == td and jdl.dtype == jd
    np.testing.assert_array_equal(_np(tl), _np(lo_out))
    np.testing.assert_array_equal(_np(tdl), _np(jdl))
    (jcast,) = jlayers._lowp_bwd(jlayers._lowp_fwd(jx)[1], jnp.asarray(dy))
    tcast = layers._Lowp.backward(types.SimpleNamespace(dtype=td), torch.from_numpy(dy))
    assert tcast.dtype == td and jcast.dtype == jd
    np.testing.assert_array_equal(_np(tcast), _np(jcast))


def test_rms_norm_and_lowp_enter_their_functions_only_for_a_gradient():
    r = _rng(4)
    x = torch.from_numpy(r.standard_normal((3, 8)).astype(np.float32)).to(torch.bfloat16)
    gamma = torch.from_numpy((0.1 * r.standard_normal(8)).astype(np.float32)).to(torch.bfloat16)
    plain = layers.rms_norm(x, gamma)  # nothing requires a gradient
    assert plain.grad_fn is None and layers.lowp(x) is x
    xg = x.clone().requires_grad_(True)
    taped = layers.rms_norm(xg, gamma)
    assert type(taped.grad_fn).__name__ == "_RmsNormBackward"
    assert type(layers.lowp(xg).grad_fn).__name__ == "_LowpBackward"
    assert torch.equal(taped.detach(), plain)  # one forward value either way
    with torch.no_grad():
        assert layers.rms_norm(xg, gamma).grad_fn is None and layers.lowp(xg) is xg


# -- loss_fn and its gradient -----------------------------------------------------------------


@pytest.mark.parametrize("name,n_chunks", [("qwen3-32b", 4), ("mamba2-370m", 8),
                                           ("jamba-v0.1-52b", 2), ("granite-moe-3b-a800m", 1)])
def test_loss_fn_matches_reference(name, n_chunks):
    jcfg, params, tcfg, lm = _carried(name)
    batch = _batch(tcfg, 2, 32)
    want = float(jax.jit(lambda p: jloss_fn(p, jcfg, _jb(batch), n_chunks=n_chunks))(params))
    with torch.no_grad():
        got = float(loss_fn(lm, _tb(batch), n_chunks=n_chunks))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    with pytest.raises(ValueError, match="n_chunks"):
        loss_fn(lm, _tb(_batch(tcfg, 1, 30)), n_chunks=4)


def _grads(lm, batch, n_chunks):
    """(loss, {name: gradient}) of loss_fn at the LM's own weights."""
    return loss_and_grads(lm, train_state_init(lm).params, batch, loss_chunks=n_chunks)


# dense, SSM, hybrid and MoE smoke models; their weights carried across
@pytest.mark.parametrize("name", ["qwen3-32b", "mamba2-370m", "jamba-v0.1-52b",
                                  "granite-moe-3b-a800m"])
def test_loss_gradient_matches_jax_grad(name):
    jcfg, params, tcfg, lm = _carried(name)
    batch = _batch(tcfg, 2, 32)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jloss_fn(p, jcfg, _jb(batch), n_chunks=4)))(
        params)
    want = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jg))
    loss, got = _grads(lm, _tb(batch), 4)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert set(got) == set(want)
    gmax = max(float(g.abs().max()) for g in want.values())
    for k, g in got.items():
        assert g.dtype == want[k].dtype and g.shape == want[k].shape, k
        assert float((g - want[k]).abs().max()) <= 1e-4 * gmax, k


def test_remat_changes_no_gradient_and_k8_k9_run_their_plain_version_on_the_cpu():
    _, _, tcfg, lm = _carried("jamba-v0.1-52b")
    batch = _tb(_batch(tcfg, 2, 32))
    kernels.reset_launch_counts()
    loss, with_remat = _grads(lm, batch, 4)
    plain = LM(dataclasses.replace(tcfg, remat=False), device="cpu")
    plain.load_state_dict(lm.state_dict())
    loss2, without = _grads(plain, batch, 4)
    assert float(loss) == float(loss2)
    for k, g in with_remat.items():
        assert float((g - without[k]).abs().max()) <= 1e-6 * float(without[k].abs().max()) + 1e-12
    assert all(n == 0 for n in kernels.launch_counts().values())
    assert all(c["cuda_calls"] == 0 for c in kernels.plain_counts().values())


def test_k8_and_k9_functions_give_their_plain_versions_gradient(monkeypatch):
    # The card's autograd.Functions run here with their launch replaced by the
    # plain version (no card): the forward is the "kernel's" output, the
    # backward recomputes the plain version under autograd; the gradient must
    # be plain autograd's.
    monkeypatch.setattr(fa, "_launch", lambda q, k, v, causal: fa.attention_ref(
        q, k, v, causal=causal))
    monkeypatch.setattr(so, "_launch", lambda x, dt, a, b, c, chunk: so.ssd_ref(
        x, dt, a, b, c, chunk=chunk))
    r = _rng(4)
    q, k, v = (torch.from_numpy(r.standard_normal((1, h, 70, 16)).astype(np.float32))
               .requires_grad_(True) for h in (4, 2, 2))
    go = torch.from_numpy(r.standard_normal((1, 4, 70, 16)).astype(np.float32))
    kernels.reset_launch_counts()
    got = torch.autograd.grad(fa._FlashAttention.apply(q, k, v, True), (q, k, v), go)
    want = torch.autograd.grad(fa.attention_ref(q, k, v, causal=True), (q, k, v), go)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)
    assert fa.flash_attention.backward_recomputes == 1
    x = torch.from_numpy(r.standard_normal((1, 70, 3, 8)).astype(np.float32)).requires_grad_(True)
    dt = torch.from_numpy(r.random((1, 70, 3)).astype(np.float32)).requires_grad_(True)
    a = torch.from_numpy(-r.random(3).astype(np.float32)).requires_grad_(True)
    bm, cm = (torch.from_numpy(r.standard_normal((1, 70, 5)).astype(np.float32))
              .requires_grad_(True) for _ in range(2))
    gy = torch.from_numpy(r.standard_normal((1, 70, 3, 8)).astype(np.float32))
    ins = (x, dt, a, bm, cm)
    y, state = so._Ssd.apply(*ins, 32)
    got = torch.autograd.grad(y, ins, gy)  # the final state unused: no cotangent
    want = torch.autograd.grad(so.ssd_ref(*ins, chunk=32)[0], ins, gy)
    for g1, g2 in zip(got, want):
        assert torch.allclose(g1, g2, rtol=1e-5, atol=1e-6)
    gs = torch.ones_like(state)
    got = torch.autograd.grad(so._Ssd.apply(*ins, 32), ins, (gy, gs))
    want = torch.autograd.grad(so.ssd_ref(*ins, chunk=32), ins, (gy, gs))
    for g1, g2 in zip(got, want):
        assert torch.allclose(g1, g2, rtol=1e-5, atol=1e-6)
    assert so.ssd.backward_recomputes == 2


# -- the optimizer and the schedules ----------------------------------------------------------


@pytest.mark.parametrize("clip", [1.0, 1e9])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_update_matches_reference(clip, wd):
    r = _rng(int(clip) % 7 + int(wd * 10))
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 3, 4)}
    params = {k: r.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    cfg = dict(peak_lr=1e-2, warmup=2, total_steps=10, weight_decay=wd, clip_norm=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jadamw_init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tst = adamw_init(tp)
    assert all(tst["master"][k].data_ptr() != tp[k].data_ptr() for k in tp)  # copies
    for step in range(4):
        grads = {k: (r.standard_normal(s) * 3).astype(np.float32) for k, s in shapes.items()}
        jp, jst = jadamw_update(jp, {k: jnp.asarray(v) for k, v in grads.items()}, jst,
                                JOptConfig(**cfg))
        tp, tst = adamw_update(tp, {k: torch.from_numpy(v) for k, v in grads.items()}, tst,
                               OptConfig(**cfg))
        assert int(tst["step"]) == int(jst["step"]) == step + 1
        for name in ("master", "mu", "nu"):
            for k in shapes:
                np.testing.assert_allclose(tst[name][k].numpy(), np.asarray(jst[name][k]),
                                           rtol=1e-6, atol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)


def test_adamw_keeps_bf16_params_and_fp32_state():
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st_ = adamw_init(params)
    assert st_["master"]["w"].dtype == torch.float32
    params, st_ = adamw_update(params, {"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}, st_,
                               OptConfig(peak_lr=1e-2, warmup=0))
    assert params["w"].dtype == torch.bfloat16
    assert torch.equal(params["w"], st_["master"]["w"].to(torch.bfloat16))
    assert float(global_norm({"w": torch.full((4,), 0.5)})) == 1.0


def test_adamw_update_with_its_norm_given_takes_the_same_step():
    r = _rng(11)
    shapes = {"a": (5, 3), "b": (7,)}
    cfg = OptConfig(peak_lr=1e-2, warmup=2, total_steps=10, clip_norm=0.5)
    params = {k: torch.from_numpy(r.standard_normal(s).astype(np.float32)) for k, s in shapes.items()}
    runs = []
    for norm in (None, global_norm, lambda g: global_norm(g) * (step + 2)):
        p = {k: v.clone() for k, v in params.items()}
        st_ = adamw_init(p)
        for step in range(3):
            g = {k: torch.from_numpy(_rng(step).standard_normal(s).astype(np.float32) * 4)
                 for k, s in shapes.items()}
            p, st_ = adamw_update(p, g, st_, cfg, grad_norm=None if norm is None else norm(g))
        runs.append((p, st_))
    (p0, s0), (p1, s1), (p2, _) = runs
    for k in shapes:
        assert torch.equal(p0[k], p1[k])
        assert all(torch.equal(s0[n][k], s1[n][k]) for n in ("master", "mu", "nu"))
    # the norm given is the one that clips
    assert not all(torch.equal(p0[k], p2[k]) for k in shapes)


@pytest.mark.parametrize("name,kw", [("cosine", dict(peak_lr=1.0, warmup=10, total=100)),
                                     ("cosine", dict(peak_lr=1.0, warmup=0, total=50,
                                                     floor=0.0)),
                                     ("wsd", dict(peak_lr=1.0, warmup=10, total=100,
                                                  decay_frac=0.2)),
                                     ("wsd", dict(peak_lr=1.0, warmup=3, total=37))])
def test_schedules_match_reference(name, kw):
    jfn = {"cosine": jschedules.cosine_schedule, "wsd": jschedules.wsd_schedule}[name]
    for step in range(0, kw["total"] + 2):
        want = float(jfn(step, **kw))
        got = make_schedule(name, **kw)(step)
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-7, (step, float(got), want)


# -- the reference's tests/test_optim_data.py, ported ------------------------------------


def test_adamw_matches_scalar_reference():
    cfg = OptConfig(peak_lr=1e-2, warmup=0, total_steps=100, schedule="cosine",
                    weight_decay=0.0, clip_norm=1e9)
    params = {"w": torch.tensor([1.0])}
    state = adamw_init(params)
    params, state = adamw_update(params, {"w": torch.tensor([0.5])}, state, cfg)
    # step 1: mu_hat = g, nu_hat = g^2 -> update = lr * g/|g| = lr
    lr1 = float(cfg.lr(1))
    np.testing.assert_allclose(float(params["w"][0]), 1.0 - lr1 * (0.5 / (0.5 + 1e-8)),
                               rtol=1e-5)


def test_grad_clip_applies():
    cfg = OptConfig(peak_lr=1e-2, warmup=0, clip_norm=1.0, weight_decay=0.0)
    # adamw_update writes the params in place: each call gets its own copy
    p1, _ = adamw_update({"w": torch.zeros(4)}, {"w": torch.full((4,), 100.0)},
                         adamw_init({"w": torch.zeros(4)}), cfg)
    p2, _ = adamw_update({"w": torch.zeros(4)}, {"w": torch.full((4,), 1000.0)},
                         adamw_init({"w": torch.zeros(4)}), cfg)
    np.testing.assert_allclose(p1["w"].numpy(), p2["w"].numpy(), rtol=1e-5)  # both clipped


@settings(max_examples=20, deadline=None)
@given(step=st.integers(0, 10_000))
def test_schedules_bounded_positive(step):
    for fn in (cosine_schedule, wsd_schedule):
        lr = float(fn(step, peak_lr=3e-4, warmup=100, total=10_000))
        assert 0.0 <= lr <= 3e-4 + 1e-9


def test_wsd_shape():
    kw = dict(peak_lr=1.0, warmup=10, total=100, decay_frac=0.2)
    assert float(wsd_schedule(5, **kw)) < 1.0  # warming
    assert float(wsd_schedule(50, **kw)) == 1.0  # stable
    assert float(wsd_schedule(99, **kw)) < 0.3  # decaying


def test_pipeline_determinism_and_resume():
    p1 = SyntheticLM(512, batch=4, seq=16, seed=3, device="cpu")
    p2 = SyntheticLM(512, batch=4, seq=16, seed=3, device="cpu")
    b1, b2 = p1.batch_at(17), p2.batch_at(17)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(p1.batch_at(18)["tokens"], b1["tokens"])
    # labels are next-token shifted view of the same stream
    assert torch.equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    t1 = TokenPipeline(512, batch=2, seq=8, seed=3, device="cpu")
    assert torch.equal(t1.batch_at(5)["tokens"], TokenPipeline(512, 2, 8, 3, "cpu").batch_at(5)
                       ["tokens"])


def test_synthetic_lm_is_learnable():
    """The rule is visible: next token equals perm[tok] 90 % of the time."""
    p = SyntheticLM(128, batch=8, seq=64, seed=0, noise=0.1, device="cpu")
    b = p.batch_at(0)
    perm = p._rule()
    match = (perm[b["tokens"]] == b["labels"]).float().mean()
    assert float(match) > 0.8


def test_token_pipeline_shapes():
    p = TokenPipeline(1000, batch=2, seq=8, device="cpu")
    b = p.batch_at(0)
    assert b["tokens"].shape == (2, 8) and b["labels"].shape == (2, 8)
    assert b["tokens"].dtype == torch.int64 and int(b["tokens"].max()) < 1000


def test_synthetic_lm_agrees_with_the_reference_in_distribution():
    # threefry cannot be reproduced: hold the port's rule-match rate to the
    # reference's, both near 1 - noise + noise / V
    from repro.data import SyntheticLM as JSyntheticLM

    rates = []
    for cls, kw in ((JSyntheticLM, {}), (SyntheticLM, {"device": "cpu"})):
        p = cls(64, batch=16, seq=256, seed=0, noise=0.3, **kw)
        b = p.batch_at(0)
        perm, toks, labels = (np.asarray(t) for t in (p._rule(), b["tokens"], b["labels"]))
        rates.append(float(np.mean(perm[toks] == labels)))
        assert toks.shape == (16, 256) and np.array_equal(toks[:, 1:], labels[:, :-1])
    expect = 1 - 0.3 + 0.3 / 64
    assert all(abs(r - expect) < 0.02 for r in rates), rates


def test_pipelines_go_to_the_card_by_default_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticLM(64, 2, 8).batch_at(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenPipeline(64, 2, 8).batch_at(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_state_init(configs.smoke(configs.get_config("qwen3-32b")))


# -- the train step ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference_over_three_steps(microbatches):
    name = "jamba-v0.1-52b"
    jcfg, tcfg = _cfg(name)
    jstate = jtrain_state_init(jcfg, jax.random.PRNGKey(0))
    lm = LM(tcfg, device="cpu")
    lm.load_state_dict(lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jstate.params)))
    state = train_state_init(lm)
    kw = dict(peak_lr=3e-3, warmup=2, total_steps=10)
    jstep = jax.jit(jmake_train_step(jcfg, JOptConfig(**kw), microbatches=microbatches,
                                     loss_chunks=4))
    step = make_train_step(lm, OptConfig(**kw), microbatches=microbatches, loss_chunks=4)
    for i in range(3):
        batch = _batch(tcfg, 4, 32, seed=10 + i)
        jstate, jm = jstep(jstate, _jb(batch))
        state, m = step(state, _tb(batch))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-4 * abs(float(jm["loss"]))
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= 1e-4 * float(jm["grad_norm"])
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(state.opt["step"]) == 3


def test_microbatches_average_the_gradient():
    _, tcfg = _cfg("qwen3-32b")
    lm = LM(tcfg, seed=1, device="cpu")
    batch = _tb(_batch(tcfg, 4, 16))
    losses = []
    for mb in (1, 2, 4):
        state = train_state_init(LM(tcfg, seed=1, device="cpu"))
        step = make_train_step(lm, OptConfig(peak_lr=1e-3, warmup=0), microbatches=mb,
                               loss_chunks=2)
        state, m = step(state, batch)
        losses.append((float(m["loss"]), float(m["grad_norm"])))
    for l, g in losses[1:]:
        assert l == pytest.approx(losses[0][0], rel=1e-5)
        assert g == pytest.approx(losses[0][1], rel=1e-4)
    with pytest.raises(ValueError, match="split"):
        make_train_step(lm, OptConfig(), microbatches=3)(state, batch)
    with pytest.raises(ValueError, match="one card"):
        make_train_step(lm, OptConfig(), grad_shardings={})


def test_train_step_from_a_config_runs_a_weightless_skeleton():
    _, tcfg = _cfg("mamba2-370m")
    state = train_state_init(tcfg, seed=0, device="cpu")
    step = make_train_step(tcfg, OptConfig(peak_lr=1e-3, warmup=0), loss_chunks=2)
    lm = LM(tcfg, seed=0, device="cpu")
    state2 = train_state_init(lm)
    batch = _tb(_batch(tcfg, 2, 16))
    _, m1 = step(state, batch)
    _, m2 = make_train_step(lm, OptConfig(peak_lr=1e-3, warmup=0), loss_chunks=2)(state2, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    assert LM(tcfg, device="meta").final_norm.device.type == "meta"


def test_state_restored_from_a_checkpoint_steps_bit_for_bit(tmp_path):
    _, tcfg = _cfg("jamba-v0.1-52b")
    state = train_state_init(tcfg, seed=0, device="cpu")
    step = make_train_step(tcfg, OptConfig(peak_lr=3e-3, warmup=1), loss_chunks=2)
    pipe = SyntheticLM(tcfg.vocab_size, 2, 16, seed=0, device="cpu")
    for i in range(2):
        state, _ = step(state, pipe.batch_at(i))
    save_checkpoint(str(tmp_path), 2, state)
    _, restored = restore_checkpoint(str(tmp_path), state)
    for (a, b) in zip(jax.tree.leaves(_as_tree(state)), jax.tree.leaves(_as_tree(restored))):
        assert torch.equal(a, b)
    # into a live state in place, from a template of CPU leaves
    live = train_state_init(tcfg, seed=5, device="cpu")
    copy_state_(live, restored)
    s1, m1 = step(state, pipe.batch_at(2))
    s2, m2 = step(restored, pipe.batch_at(2))
    s3, m3 = step(live, pipe.batch_at(2))
    assert float(m1["loss"]) == float(m2["loss"]) == float(m3["loss"])
    assert isinstance(s2, TrainState)


def _as_tree(state):
    return {"params": state.params, "opt": state.opt}


# -- test_system.py::test_lm_trains_checkpoints_and_serves, ported ------------------------


def test_lm_trains_checkpoints_and_serves():
    cfg = configs.smoke(configs.get_config("qwen3-32b"))
    opt = OptConfig(peak_lr=3e-3, warmup=5, total_steps=80)
    lm = LM(cfg, seed=0, device="cpu")
    state = train_state_init(lm)
    step = make_train_step(lm, opt, loss_chunks=4)
    pipe = SyntheticLM(cfg.vocab_size, batch=8, seq=64, seed=0, noise=0.05, device="cpu")
    losses = []
    for s in range(60):  # past the lr peak: the rule is learnt
        state, m = step(state, pipe.batch_at(s))
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.5 * losses[0], losses[::10]

    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 60, state)
        _, restored = restore_checkpoint(d, state)
        for a, b in zip(jax.tree.leaves(_as_tree(state)), jax.tree.leaves(_as_tree(restored))):
            assert torch.equal(a, b)
        # the restored state continues identically (determinism)
        s1, m1 = step(state, pipe.batch_at(60))
        s2, m2 = step(restored, pipe.batch_at(60))
        assert float(m1["loss"]) == float(m2["loss"])

    # greedy decode predicts the learned rule (the LM's own tensors were
    # trained). The reference checks a one-token prompt, t0 = 17, under its
    # threefry batches; each row's chain starts at position 0 only once, so
    # a one-token prompt is the rule's weakest point and depends on which
    # tokens the batches happened to start with (the port's batches differ);
    # the port checks the rule after a prompt that follows it instead, for
    # 32 starting tokens
    perm = pipe._rule()
    right = 0
    for t0 in range(1, 512, 16):
        chain = [t0]
        for _ in range(7):
            chain.append(int(perm[chain[-1]]))
        logits, _ = prefill(lm, torch.tensor([chain]), cache_len=8)
        right += int(sample_greedy(logits, cfg.vocab_size)[0]) == int(perm[chain[-1]])
    assert right >= 28, right


def test_new_packages_import_neither_jax_nor_the_reference():
    pkg = REPO / "src" / "repro_torch"
    files = [f for d in ("optim", "training", "data", "runtime") for f in (pkg / d).glob("*.py")]
    files += [pkg / "models" / "attention.py", pkg / "models" / "model.py"]
    assert len(files) >= 12
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    for f in files:
        assert not pat.search(f.read_text()), f


def test_chip_smoke_phase_15_and_the_wide_kernel_times_rehearse_on_the_cpu():
    import sys

    sys.path.insert(0, str(REPO))
    import chip_smoke

    wide = chip_smoke.wide_kernel_times("cpu", attn_shape=(1, 4, 1, 70, 256),
                                        ssd_shape=(1, 70, 3, 16, 32),
                                        published_shape=(1, 2, 1, 70, 256), timed=False)
    assert set(wide) == {"flash_attention@gemma", "flash_attention@gemma@fp32", "ssd@mamba",
                         "ssd@mamba@fp32", "flash_attention@gemma-published"}
    assert wide["flash_attention@gemma"]["dtype"] == "bfloat16"
    assert wide["flash_attention@gemma-published"]["shape"] == [1, 2, 1, 70, 256]
    # gemma-2b's 8 q heads padded to 16 over its one kv head, as phase 15 runs it
    assert chip_smoke.GEMMA_ATTN == (2, 16, 1, 2048, 256)
    assert chip_smoke.GEMMA_ATTN_PUBLISHED == (2, 8, 1, 2048, 256)
    assert chip_smoke.MAMBA_SSD == (4, 2048, 32, 64, 128)
    assert all(3e-4 <= lr <= 3e-3 for lr in chip_smoke.TRAIN_PEAK_LR.values())
    g = dataclasses.replace(configs.smoke(configs.get_config("gemma-2b")), n_layers=2)
    m = dataclasses.replace(configs.smoke(configs.get_config("mamba2-370m")), n_layers=2)
    res = chip_smoke.train("cpu", gemma=g, mamba=m, gemma_shape=(4, 64), mamba_shape=(4, 64),
                           parity_seq=32, peak_lr=1e-2)
    assert res["gemma"]["resume"]["bit_identical"]
    assert len(res["gemma"]["losses"]) == len(res["mamba"]["losses"]) == 6
    assert all(p["loss_rel"] == 0.0 and p["grad_worst"] == 0.0 for p in res["parity"])
    assert res["launches"] == {"flash_attention": 0, "ssd": 0}  # plain on the CPU
