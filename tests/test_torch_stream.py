"""Out-of-core streaming in the port (``repro_torch.stream``) against the
reference's ``repro.stream`` on the same host data.

Both sides stream a ``ChunkStore`` of n = 4 500 rows in chunks of 1 024 (the
last chunk ragged) through ``StreamBackend``: the reference's on
``JnpBackend`` tiles, the port's on ``TorchBackend`` tiles. Tolerances, as
ROADMAP's rules set them: the Gram 2e-5 absolute; the K_nM contractions
1e-4 * max|ref|; the Eq. 3 scores and quadratic form 5e-4 relative (+ 5e-5
absolute, tests/test_backend.py's form); end-to-end FALKON 1e-3 *
max|pred|. The byte meter's peak must equal the reference's exactly: the
two packages place the same chunks and note the same tiles.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.stream as jstream
from repro.api import FalkonRegressor as JFalkonRegressor
from repro.api import FitConfig as JFitConfig
from repro_torch import core, stream
from repro_torch.api import ChunkStore, FalkonRegressor, FitConfig, StreamBackend, UniformSampler
from repro_torch.core import backend as backend_mod
from repro_torch.interop import center_set_from_numpy

N, D, M, CHUNK = 4500, 5, 40, 1024
JK = jcore.make_kernel("gaussian", sigma=1.5)
TK = core.make_kernel("gaussian", sigma=1.5)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + 0.3 * x[:, 1]).astype(np.float32)
    panel = np.stack([y, np.cos(x[:, 2])], axis=1).astype(np.float32)
    mask = (rng.random((N, 2)) > 0.3).astype(np.float32)
    return x, y, panel, mask


def _stores(x):
    return (jstream.ChunkStore(x, chunk=CHUNK),
            ChunkStore(x, chunk=CHUNK, device="cpu"))


def _close(out, ref, tol):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-30))


def _score_close(out, ref):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=5e-4, atol=5e-5)


def _padded_centers(x):
    """Mbuf = 48 slots: 40 valid centers, 8 invalid; reg = lam n A on valid."""
    z = np.concatenate([x[:M], np.zeros((8, D), np.float32)])
    mask = np.arange(48) < M
    lamn = 1e-3 * N
    reg = np.where(mask, lamn * (0.5 + np.linspace(0, 1, 48)), 1.0).astype(np.float32)
    return z, mask, reg, lamn


def _call(side, method, xs, x, y, panel, mask):
    """One protocol method on one package's side ("ref" or "port"), the byte
    meter reset before it; returns (output or list of outputs, meter peak)."""
    pkg, be, kern, arr = ((jstream, jstream.StreamBackend(inner=jcore.JnpBackend()), JK,
                           jnp.asarray) if side == "ref" else
                          (stream, StreamBackend(inner=core.TorchBackend()), TK, torch.from_numpy))
    zz = arr(x[:M])
    pkg.reset_peak_device_bytes()
    if method == "gram_block":
        r = be.gram_block(kern, xs, zz)
    elif method == "knm_matvec":
        r = be.knm_matvec(kern, xs, zz, arr(panel[:M]))
    elif method == "knm_quadratic":
        r = [be.knm_quadratic(kern, xs, zz)(arr(y[:M])),
             be.knm_quadratic(kern, xs, zz, mask=arr(mask))(arr(panel[:M]))]
    elif method == "knm_t":
        r = [be.knm_t(kern, xs, zz, arr(y)), be.knm_t(kern, xs, zz, arr(panel), mask=arr(mask))]
    elif method == "knm_operators":
        quad, kty = be.knm_operators(kern, xs, zz, arr(panel), mask=arr(mask))
        r = [quad(arr(panel[:M])), kty]
    else:
        zp, zm, reg, lamn = _padded_centers(x)
        args = (kern, xs, arr(zp), arr(zm), arr(reg))
        r = be.masked_quadform(*args) if method == "masked_quadform" else be.rls_scores(*args, lamn)
    return (r if isinstance(r, list) else [r]), pkg.peak_device_bytes()


METHODS = ["gram_block", "masked_quadform", "rls_scores", "knm_quadratic", "knm_t",
           "knm_operators", "knm_matvec"]


@pytest.mark.parametrize("method", METHODS)
def test_every_protocol_method_matches_the_reference(data, method):
    x, y, panel, mask = data
    jx, tx = _stores(x)
    want, jpeak = _call("ref", method, jx, x, y, panel, mask)
    got, tpeak = _call("port", method, tx, x, y, panel, mask)
    assert tpeak == jpeak > 0
    for g, w in zip(got, want):
        if method == "gram_block":
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=2e-5)
        elif method in ("masked_quadform", "rls_scores"):
            _score_close(g, w)
        else:
            _close(g, w, 1e-4)
    # repeated calls are bit-identical (fixed chunk order)
    again, _ = _call("port", method, tx, x, y, panel, mask)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_stream_matches_the_non_streamed_torch_backend(data):
    x, y, _, _ = data
    _, tx = _stores(x)
    z = torch.from_numpy(x[:M])
    sb, tb = StreamBackend(inner=core.TorchBackend()), core.TorchBackend()
    _close(sb.knm_t(TK, tx, z, torch.from_numpy(y)), tb.knm_t(TK, torch.from_numpy(x), z,
                                                               torch.from_numpy(y)), 1e-4)
    _close(sb.knm_matvec(TK, tx, z, torch.ones(M)), tb.knm_matvec(TK, torch.from_numpy(x), z,
                                                                  torch.ones(M)), 1e-4)


def test_chunkstore_surface_growth_and_validation():
    rng = np.random.default_rng(2)
    x0 = rng.standard_normal((100, 3)).astype(np.float32)
    y0 = rng.standard_normal((100,)).astype(np.float32)
    store = ChunkStore(x0, y0, chunk=64, device="cpu")
    x0[0, 0] = 99.0  # the store owns a copy
    assert float(store.x[0, 0]) != 99.0
    view = store.x[:100].clone()
    xs, ys = [store.x.numpy().copy()], [y0]
    for r in (1, 50, 300):
        xa = rng.standard_normal((r, 3)).astype(np.float32)
        ya = rng.standard_normal((r,)).astype(np.float32)
        assert store.append(xa, ya) == sum(a.shape[0] for a in xs) + r
        xs.append(xa)
        ys.append(ya)
    np.testing.assert_array_equal(store.x.numpy(), np.concatenate(xs))
    np.testing.assert_array_equal(store.y.numpy(), np.concatenate(ys))
    assert torch.equal(store.x[:100], view)  # existing rows never move in value
    assert store.shape == (451, 3) and len(store) == 451 and store.n_chunks == 8
    assert store.ndim == 2 and store.dtype == torch.float32 and store.device.type == "cpu"
    assert [s.stop - s.start for s in store.chunk_slices()][-1] == 451 - 7 * 64
    for idx in (np.array([3, 1, 450]), torch.tensor([3, 1, 450]), [3, 1, 450]):
        np.testing.assert_array_equal(store[idx].numpy(), store.x.numpy()[[3, 1, 450]])
    assert store[5].shape == (3,) and store[2:6].shape == (4, 3)
    assert torch.equal(store.to_device(), store.x)
    with pytest.raises(ValueError, match="append rows"):
        store.append(np.zeros((2, 5), np.float32), np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="carries y"):
        store.append(np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="has no y"):
        ChunkStore(x0, device="cpu").append(np.zeros((2, 3), np.float32), np.zeros(2))
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        ChunkStore(np.zeros(4, np.float32), device="cpu")


def test_chunkstore_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChunkStore(np.zeros((4, 3), np.float32))


def test_device_chunks_cover_exactly_and_meter_like_the_reference(data):
    x, y, _, _ = data
    jx, tx = _stores(x)
    jstream.reset_peak_device_bytes()
    jrows = [np.asarray(xb) for xb, _ in jstream.device_chunks(jx, aux=jnp.asarray(y))]
    stream.reset_peak_device_bytes()
    trows = [(xb.numpy(), yb) for xb, yb in stream.device_chunks(tx, aux=torch.from_numpy(y))]
    assert [r.shape[0] for r in jrows] == [r.shape[0] for r, _ in trows] == [1024] * 4 + [404]
    np.testing.assert_array_equal(np.concatenate([r for r, _ in trows]), x)
    assert stream.peak_device_bytes() == jstream.peak_device_bytes() == 2 * 1024 * D * 4
    # a tensor already on the target device is sliced: no copy, no accounting
    stream.reset_peak_device_bytes()
    parts = list(stream.device_chunks(torch.from_numpy(x), chunk=1000))
    assert len(parts) == 5 and stream.peak_device_bytes() == 0


def test_gram_block_refuses_to_materialize_past_its_guard(data):
    x = data[0]
    _, tx = _stores(x)
    z = tx[np.arange(8)]
    with pytest.raises(ValueError, match="refuses to materialize"):
        StreamBackend(inner=core.TorchBackend(), materialize_elems=N * 8 - 1).gram_block(TK, tx, z)
    assert StreamBackend(inner=core.TorchBackend()).gram_block(TK, tx, z).shape == (N, 8)


def test_registry_serves_stream_specs():
    be = core.resolve_backend("stream:torch")
    assert isinstance(be, StreamBackend) and isinstance(be.inner, core.TorchBackend)
    assert isinstance(core.resolve_backend("stream").inner, core.CudaBackend)
    assert isinstance(core.resolve_backend("stream:cuda").inner, core.CudaBackend)
    assert "stream" in core.backend_names()
    with pytest.raises(ValueError, match="unknown backend"):
        core.resolve_backend("stream:pallas")
    with pytest.raises(ValueError, match="not composable"):
        core.resolve_backend("torch:cuda")
    base = StreamBackend(inner=core.TorchBackend(), chunk=7)
    swapped = base.with_inner(core.CudaBackend())
    assert base.inner == core.TorchBackend() and swapped.chunk == 7


def test_default_backend_streams_past_the_row_threshold(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)  # nothing is launched
    assert backend_mod.STREAM_MIN_ROWS == 1 << 21
    assert isinstance(core.default_backend("cuda", n=1 << 20), core.CudaBackend)
    assert isinstance(core.default_backend("cuda", n=1 << 21), StreamBackend)
    monkeypatch.setenv("REPRO_STREAM_MIN_ROWS", "1000")
    be = core.default_backend("cuda", n=1000)
    assert isinstance(be, StreamBackend) and isinstance(be.inner, core.CudaBackend)
    assert isinstance(core.default_backend("cuda", n=999), core.CudaBackend)
    assert isinstance(core.resolve_backend(None, device="cuda", n=5000), StreamBackend)
    with pytest.raises(RuntimeError, match="no backend is chosen by default"):
        core.default_backend("cpu", n=5000)


def test_falkon_regressor_on_a_chunkstore_matches_the_references(data):
    x, y, _, _ = data
    idx = np.sort(np.random.default_rng(3).choice(N, size=64, replace=False))
    ref = JFalkonRegressor(kernel=JK, config=JFitConfig(lam=1e-3, iters=30,
                                                        backend=jstream.StreamBackend()))
    ref.fit(jstream.ChunkStore(x, chunk=CHUNK), jnp.asarray(y),
            center_set=jcore.CenterSet(idx=jnp.asarray(idx), weight=jnp.ones(64),
                                       mask=jnp.ones(64, bool), count=jnp.asarray(64)))
    est = FalkonRegressor(kernel=TK, sampler=UniformSampler(m=64),
                          config=FitConfig(lam=1e-3, iters=30, device="cpu"))
    store = ChunkStore(x, chunk=CHUNK, device="cpu")
    est.fit(store, y, center_set=center_set_from_numpy(idx, np.ones(64), np.ones(64, bool), 64))
    assert isinstance(est.model_.backend, StreamBackend)  # a store streams by default
    xt = x[:500]
    _close(est.predict(store)[:500], np.asarray(ref.predict(jnp.asarray(xt))), 1e-3)
    _close(est.predict(xt), np.asarray(ref.predict(jnp.asarray(xt))), 1e-3)
    # a sampler draws its centers from the store, BLESS included
    est2 = FalkonRegressor(kernel=TK, config=FitConfig(lam=1e-4, iters=10, device="cpu"))
    est2.fit(store, y, key=0)
    assert est2.centers_.shape[1] == D and bool(torch.all(torch.isfinite(est2.predict(xt))))
