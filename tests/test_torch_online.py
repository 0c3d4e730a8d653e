"""Checkpoints and durable online FALKON in the port
(``repro_torch.checkpoint``, ``repro_torch.online``) against the reference.

Checkpoints: each package restores the other's saves bit for bit (fp32 and
bf16 leaves; dict, tuple and NamedTuple trees), every ``CRASH_STAGES``
stage of a killed write leaves ``latest_step`` at the previous step, and
``AsyncCheckpointer`` snapshots before the caller's next in-place update.

Online (n = 2 400, d = 4, M = 56, chunk 1 024 with a ragged last chunk, the
converged regime lam = 1e-3, 30 CG iterations): the accumulators H and b
within 1e-4 * max of the reference's; ``solve_accumulators``' alpha no
farther from the fp64 solution than the reference's plus 1e-3 * max, and
within 1e-3 of the reference's at ``WELL_LAM`` (end-to-end FALKON); a resume
after each crash stage bit-identical to the uninterrupted port fit;
``ResumeMismatchError`` when lam or the centers change; append-then-refit
within 1e-2 of a cold fit, and within 1e-3 of the reference's
``OnlineFalkon`` at ``WELL_LAM``; the NaN fence leaves the state untouched.
The fp32 normal equations square the condition number, so at lam = 1e-3
each package is ~4e-3 of max|pred| from the fp64 fit and two packages
cannot be held to 1e-3 of each other there (ROADMAP C.3). A background refresh is held against a port
``resumable_streamed_fit`` on the same refreshed centers (1e-4), not
against the reference's sampler-dependent 2e-2 bound that its red
``test_background_refresh_absorbs_delta`` reads 4.9e-2 against.
"""
import typing

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
import repro.core as jcore
import repro.online as jonline
from repro.stream import ChunkStore as JChunkStore
from repro_torch import checkpoint as ckpt
from repro_torch import core
from repro_torch.api import ChunkStore, OnlineFalkon, ResumeMismatchError, UniformSampler
from repro_torch.api import resumable_streamed_fit
from repro_torch.core import health
from repro_torch.online import absorb, solve_accumulators
from repro_torch.testing import faults

N, D, M, CHUNK = 2400, 4, 56, 1024
LAM, ITERS = 1e-3, 30
#: where the fp32 normal equations leave each package's alpha within ~5e-4
#: of max|alpha| of the fp64 solution (LAM leaves ~2e-2, and the
#: predictions ~4e-3), so the two packages' accumulator fits can be held to
#: the end-to-end 1e-3 against each other.
WELL_LAM = 1e-1
JK = jcore.make_kernel("gaussian", sigma=1.5)
TK = core.make_kernel("gaussian", sigma=1.5)
TB = core.TorchBackend()
STREAM = "stream:torch"


class Pair(typing.NamedTuple):
    h: typing.Any
    b: typing.Any


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + 0.3 * x[:, 1]).astype(np.float32)
    return x, y


def _close(out, ref, tol):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-30))


def _store(x, y, chunk=CHUNK):
    return ChunkStore(x, y, chunk=chunk, device="cpu")


# -- checkpoints ------------------------------------------------------------------------


def _trees():
    rng = np.random.default_rng(4)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    b16 = rng.standard_normal((4, 2)).astype(ml_dtypes.bfloat16)
    i32 = np.arange(6, dtype=np.int32)  # JAX without x64 holds no int64
    ref = {"w": jnp.asarray(f32), "p": (jnp.asarray(b16), [jnp.asarray(i32)]),
           "nt": Pair(h=jnp.asarray(f32[:2]), b=jnp.asarray(b16[:1]))}
    port = {"w": torch.from_numpy(f32),
            "p": (torch.from_numpy(b16.view(np.int16)).view(torch.bfloat16),
                  [torch.from_numpy(i32)]),
            "nt": Pair(h=torch.from_numpy(f32[:2]),
                       b=torch.from_numpy(b16[:1].view(np.int16)).view(torch.bfloat16))}
    return ref, port


def _bits(a):
    """The leaf's raw bytes (bf16 compared through its bit pattern)."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy().tobytes()
    a = np.asarray(a)
    return (a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a).tobytes()


def _leaves(tree):
    return [tree["nt"].b, tree["nt"].h, tree["p"][0], tree["p"][1][0], tree["w"]]


def test_each_package_restores_the_others_checkpoints_bit_for_bit(tmp_path):
    ref, port = _trees()
    jckpt.save_checkpoint(str(tmp_path / "ref"), 3, ref, extra={"who": "ref"})
    ckpt.save_checkpoint(str(tmp_path / "port"), 3, port, extra={"who": "port"})
    step, from_ref = ckpt.restore_checkpoint(str(tmp_path / "ref"), port)
    assert step == 3 and ckpt.checkpoint_extra(str(tmp_path / "ref"), 3) == {"who": "ref"}
    assert isinstance(from_ref["nt"], Pair) and isinstance(from_ref["p"], tuple)
    assert from_ref["p"][0].dtype == torch.bfloat16
    step, from_port = jckpt.restore_checkpoint(str(tmp_path / "port"), ref)
    assert step == 3 and from_port["p"][0].dtype == jnp.bfloat16
    for a, b in zip(_leaves(from_ref), _leaves(ref)):
        assert _bits(a) == _bits(b)
    for a, b in zip(_leaves(from_port), _leaves(port)):
        assert _bits(a) == _bits(b)
    # the manifests are the same document, leaf for leaf
    import json

    def manifest(d):
        with open(tmp_path / d / "step_00000003" / "manifest.json") as f:
            return json.load(f)["leaves"]

    assert manifest("ref") == manifest("port")


@pytest.mark.parametrize("stage", ckpt.CRASH_STAGES)
def test_every_crash_stage_leaves_the_previous_step_loadable(tmp_path, stage):
    tree = {"h": torch.arange(12.0).reshape(3, 4), "b": torch.ones(3)}
    ckpt.save_checkpoint(str(tmp_path), 1, tree)
    with faults.fault("ckpt.torn_write", stage=stage, times=1):
        with pytest.raises(faults.FaultInjected, match=stage):
            ckpt.save_checkpoint(str(tmp_path), 2, {"h": tree["h"] * 2, "b": tree["b"]})
    want = 2 if stage == "post_rename" else 1  # after the rename the step is whole
    assert ckpt.latest_step(str(tmp_path)) == want
    _, back = ckpt.restore_checkpoint(str(tmp_path), tree)
    assert torch.equal(back["h"], tree["h"] * want)


def test_async_checkpointer_snapshots_before_an_in_place_update(tmp_path):
    h = torch.zeros((256, 256))
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for step in range(1, 5):
        ac.save(step, {"h": h})
        h += 1.0  # the next step's in-place update, while the write may be in flight
    ac.wait()
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003", "step_00000004"]
    for step in (3, 4):
        _, back = ckpt.restore_checkpoint(str(tmp_path), {"h": h}, step=step)
        assert torch.equal(back["h"], torch.full((256, 256), float(step - 1)))


# -- accumulators -------------------------------------------------------------------------


def test_absorb_and_solve_match_the_reference(data):
    x, y = data
    z = x[:M]
    jh, jb = jonline.absorb(JK, x, y, jnp.asarray(z), jnp.zeros((M, M)), jnp.zeros((M,)),
                            inner=jcore.JnpBackend(), chunk=CHUNK)
    th, tb = absorb(TK, _store(x, y).x, _store(x, y).y, torch.from_numpy(z),
                    torch.zeros((M, M)), torch.zeros((M,)), inner=TB, chunk=CHUNK)
    _close(th, jh, 1e-4)
    _close(tb, jb, 1e-4)
    # The fp32 normal equations square the condition number: at LAM each
    # package's alpha lies ~2 % of max|alpha| from the fp64 solution, the
    # same H and b included. There both are refereed by fp64 (ROADMAP C.3);
    # at WELL_LAM both agree to the end-to-end 1e-3.
    zt = torch.from_numpy(z).double()
    g = TK.cross(torch.from_numpy(x).double(), zt)
    for lam in (LAM, WELL_LAM):
        ja, _ = jonline.solve_accumulators(JK, jh, jb, jnp.asarray(z), lam, N, iters=ITERS)
        ta, resid = solve_accumulators(TK, th, tb, torch.from_numpy(z), lam, N, iters=ITERS,
                                       backend="torch")
        assert health.SolveDiagnostics(resid).converged
        exact = torch.linalg.solve(g.T @ g + lam * N * TK.cross(zt, zt),
                                   g.T @ torch.from_numpy(y).double())
        ja = torch.from_numpy(np.array(ja)).double()
        scale = float(exact.abs().max())
        assert float((ta.double() - exact).abs().max()) <= (
            float((ja - exact).abs().max()) + 1e-3 * scale)
        if lam == WELL_LAM:
            _close(ta, ja, 1e-3)


# -- durable fits -------------------------------------------------------------------------


def test_resumable_fit_matches_the_reference_and_rides_the_generator_state(data, tmp_path):
    x, y = data
    gen = torch.Generator().manual_seed(11)
    fit = resumable_streamed_fit(TK, _store(x, y), centers=x[:M], lam=WELL_LAM, iters=ITERS,
                                 backend=STREAM, ckpt_dir=str(tmp_path / "port"), ckpt_every=2,
                                 key=gen)
    ref = jonline.resumable_streamed_fit(JK, JChunkStore(x, y, chunk=CHUNK),
                                         centers=jnp.asarray(x[:M]), lam=WELL_LAM, iters=ITERS,
                                         ckpt_dir=str(tmp_path / "ref"), ckpt_every=2)
    xt = torch.from_numpy(x[:300])
    _close(fit.predict(xt, backend=TB), np.asarray(ref.predict(jnp.asarray(x[:300]))), 1e-3)
    step = ckpt.latest_step(str(tmp_path / "port"))
    assert step == 3  # three chunks, barriers at 2 and 3
    extra = ckpt.checkpoint_extra(str(tmp_path / "port"), step)
    assert extra["cursor"] == 3 and extra["rows"] == N and extra["schema"] == 1
    _, tree = ckpt.restore_checkpoint(str(tmp_path / "port"),
                                      {"h": torch.zeros(1), "b": torch.zeros(1),
                                       "key": torch.zeros(1, dtype=torch.uint8)})
    assert torch.equal(tree["key"], gen.get_state())


@pytest.mark.parametrize("stage", ckpt.CRASH_STAGES)
def test_resume_after_each_crash_stage_is_bit_identical(data, tmp_path, stage):
    x, y = data
    store = _store(x, y, chunk=512)  # 5 chunks: barriers at 2, 4, 5
    kw = dict(centers=x[:M], lam=LAM, iters=ITERS, backend=STREAM, ckpt_every=2)
    whole = resumable_streamed_fit(TK, store, ckpt_dir=str(tmp_path / "whole"), **kw)
    health.clear_events()
    skip = 3 if stage == "leaf" else 1  # h, b and key: the second save's first leaf
    with faults.fault("ckpt.torn_write", stage=stage, skip=skip, times=1):
        with pytest.raises(faults.FaultInjected):
            resumable_streamed_fit(TK, store, ckpt_dir=str(tmp_path / "killed"), **kw)
    resumed = resumable_streamed_fit(TK, store, ckpt_dir=str(tmp_path / "killed"), **kw)
    assert torch.equal(resumed.alpha, whole.alpha)
    assert health.events("durable_fit_resume")


def test_resume_refuses_another_fits_checkpoint(data, tmp_path):
    x, y = data
    store = _store(x, y)
    kw = dict(lam=LAM, iters=ITERS, backend=STREAM, ckpt_dir=str(tmp_path))
    resumable_streamed_fit(TK, store, centers=x[:M], **kw)
    for change in ({"lam": LAM * 2}, {"centers": x[1:M + 1]}, {"iters": ITERS + 1}):
        args = {**kw, "centers": x[:M], **change}
        with pytest.raises(ResumeMismatchError, match="refusing"):
            resumable_streamed_fit(TK, store, **args)
    with pytest.raises(ResumeMismatchError):
        resumable_streamed_fit(TK, _store(x, y, chunk=600), centers=x[:M], **kw)


# -- online -------------------------------------------------------------------------------


def test_append_then_refit_matches_cold_and_the_reference(data):
    x, y = data
    xt = np.random.default_rng(1).standard_normal((300, D)).astype(np.float32)
    for lam in (LAM, WELL_LAM):
        cold = core.falkon_fit(TK, torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(x[:M]), lam, iters=ITERS, backend=TB)
        of = OnlineFalkon(TK, x[:M], lam, x=x[:800], y=y[:800], iters=ITERS, backend=STREAM,
                          chunk=CHUNK, device="cpu")
        ref = jonline.OnlineFalkon(JK, x[:M], lam, x=x[:800], y=y[:800], iters=ITERS,
                                   chunk=CHUNK)
        for i in range(800, N, 400):
            of.append(x[i:i + 400], y[i:i + 400])
            ref.append(x[i:i + 400], y[i:i + 400])
        model, jmodel = of.refit(), ref.refit()
        assert model.diagnostics.converged and cold.diagnostics.converged
        pred = model.predict(torch.from_numpy(xt))
        _close(pred, cold.predict(torch.from_numpy(xt)), 1e-2)
        if lam == WELL_LAM:
            _close(pred, np.asarray(jmodel.predict(jnp.asarray(xt))), 1e-3)
    assert of.counters == {"appends": 4, "rows": N, "rejected": 0, "refits": 1, "refreshes": 0}


def test_nan_fence_leaves_the_state_untouched(data):
    x, y = data
    of = OnlineFalkon(TK, x[:M], LAM, x=x[:800], y=y[:800], backend=STREAM, chunk=256,
                      device="cpu")
    h0, b0, x0 = of._h.clone(), of._b.clone(), of.store.x.clone()
    batch = torch.from_numpy(x[800:900].copy())
    with faults.fault("online.corrupt_row", row=2):
        with pytest.raises(health.NonFiniteError):
            of.append(batch, y[800:900])
    assert torch.equal(batch, torch.from_numpy(x[800:900]))  # the caller's batch is not written
    bad = x[800:900].copy()
    bad[3, 1] = np.nan
    with pytest.raises(health.NonFiniteError):
        of.append(bad, y[800:900])
    assert torch.equal(of._h, h0) and torch.equal(of._b, b0) and torch.equal(of.store.x, x0)
    assert of.counters["rejected"] == 2 and of.counters["appends"] == 0
    assert health.events("online_append_rejected")
    of.append(x[800:900], y[800:900])
    assert of.counters["appends"] == 1 and of.store.shape[0] == 900
    with pytest.raises(ValueError, match="append batch"):
        of.append(x[:10, :2], y[:10])
    with pytest.raises(ValueError, match="append targets"):
        of.append(x[:10], y[:9])


@pytest.mark.parametrize("background", [False, True])
def test_refresh_matches_a_durable_fit_on_the_same_refreshed_centers(data, tmp_path, background):
    x, y = data
    # chunks of 600 rows: the snapshot's two chunks and the delta line up
    # with the durable fit's three, so the two fits add the same products in
    # the same order
    of = OnlineFalkon(TK, x[:M], LAM, x=x[:1200], y=y[:1200], iters=ITERS, backend=STREAM,
                      sampler=UniformSampler(m=M, replace=False), chunk=600, device="cpu")
    of.refresh_centers(5, background=background)
    of.append(x[1200:1800], y[1200:1800])  # the delta, appended while a refresh may run
    assert of.join_refresh() is background
    assert of.counters["refreshes"] == 1 and not of.join_refresh()
    model = of.refit()
    ref = resumable_streamed_fit(TK, _store(x[:1800], y[:1800], chunk=600), centers=model.centers,
                                 a_diag=model.a_diag, lam=LAM, iters=ITERS, backend=STREAM,
                                 ckpt_dir=str(tmp_path))
    xt = torch.from_numpy(x[:200])
    _close(model.predict(xt), ref.predict(xt), 1e-4)
    with pytest.raises(ValueError, match="sampler"):
        OnlineFalkon(TK, x[:M], LAM, x=x[:300], y=y[:300], backend=STREAM,
                     device="cpu").refresh_centers(0)


def test_online_defaults_to_the_card_and_raises_without_one(data, monkeypatch):
    x, y = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OnlineFalkon(TK, x[:M], LAM, x=x[:300], y=y[:300])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resumable_streamed_fit(TK, x[:300], y[:300], centers=x[:M], ckpt_dir="unused")


def test_fp64_accumulators_stay_finite_where_the_references_fp32_ones_diverge(tmp_path):
    # lam n = 5e-3 is far below fp32's rounding of H ~ eps * ||H||: the
    # reference's fp32 accumulators turn H + lam n K_MM indefinite and CG
    # diverges (as the port's did on the card at SUSY scale, n = 10^6,
    # M = 2 980, lam = 1e-6). The port's fp64 accumulators follow an fp64
    # falkon_fit, the referee of fp32 fits at small lam (ROADMAP C.3), to
    # 1e-3 of max|pred| (the fp32 operator path lies ~2e-2 from it here).
    n, d, m, lam = 5000, 8, 400, 1e-6
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = np.sign(np.tanh(x @ rng.standard_normal(d).astype(np.float32))).astype(np.float32)
    jk, tk = jcore.make_kernel("gaussian", sigma=4.0), core.make_kernel("gaussian", sigma=4.0)
    ref = jonline.resumable_streamed_fit(jk, JChunkStore(x, y, chunk=CHUNK),
                                         centers=jnp.asarray(x[:m]), lam=lam,
                                         ckpt_dir=str(tmp_path / "ref"))
    assert not bool(jnp.all(jnp.isfinite(ref.alpha)))
    fit = resumable_streamed_fit(tk, _store(x, y), centers=x[:m], lam=lam, backend=STREAM,
                                 ckpt_dir=str(tmp_path / "port"))
    x64 = torch.from_numpy(x).double()
    referee = core.falkon_fit(tk, x64, torch.from_numpy(y).double(), x64[:m], lam, iters=20,
                              backend=TB)
    _close(fit.predict(torch.from_numpy(x[:500])), referee.predict(x64[:500]), 1e-3)
