"""The port's third slice on the CPU against the reference: the row-masked
fit, the one-vs-rest classifier and exact k-fold CV.

The same inputs (numpy, or JAX arrays made by the reference's own test
problems and handed across as numpy) go through the JAX functions and the
port. Tolerances: the masked fit and the classifier's margins 1e-3 of their
largest value (DESIGN.md §10), compared at the same iteration count; sweep
scores 1e-3 relative against the JAX sweep on the same folds and centers;
the port's sweep against naive per-fold refits 1e-6, at the converged
settings of tests/test_scenarios.py (lam in {1e-2, 5e-3}, 30 iterations).
Before convergence a sweep and a refit differ by design: the sweep's shared
preconditioner keeps the global n, a refit builds its own with n_f.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core as jcore
from repro.api.sweep import fold_ids as jax_fold_ids
from repro_torch import core, kernels
from repro_torch.api import (FalkonClassifier, FitConfig, KFoldResult, KFoldSweep,
                             UniformSampler)
from repro_torch.api.sweep import fold_ids
from repro_torch.interop import center_set_from_numpy


def _t(a):
    return torch.from_numpy(np.array(a))


def _carry(cs):
    return center_set_from_numpy(*map(np.asarray, cs))


def _close(out, ref, rel):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * np.abs(ref).max())


# -- falkon_fit(row_mask=) ----------------------------------------------------------


@pytest.mark.parametrize("panel", [False, True])
def test_masked_fit_through_cuda_backend_matches_reference_pallas(panel):
    # CudaBackend on CPU tensors (K7's and K3's plain versions) against the
    # reference's host CG loop on PallasBackend in interpret mode (the Pallas
    # K7), same centers, same iterations.
    rng = np.random.default_rng(20)
    x = rng.standard_normal((400, 5)).astype(np.float32)
    y = np.sin(2 * x[:, 0]) + 0.3 * x[:, 1]
    if panel:
        y = np.stack([y, np.cos(x[:, 2]), -y], axis=1)
        mask = (rng.random((400, 3)) > 0.25).astype(np.float32)
    else:
        mask = (rng.random(400) > 0.25).astype(np.float32)
    y = y.astype(np.float32)
    xte = rng.standard_normal((100, 5)).astype(np.float32)
    jm = jcore.falkon_fit(jcore.make_kernel("laplacian", sigma=2.0), jnp.asarray(x), jnp.asarray(y),
                          jnp.asarray(x[:48]), 1e-3, iters=15,
                          backend=jcore.PallasBackend(interpret=True), row_mask=jnp.asarray(mask),
                          fused=False)
    kernels.reset_launch_counts()
    tm = core.falkon_fit(core.make_kernel("laplacian", sigma=2.0), _t(x), _t(y), _t(x[:48]), 1e-3,
                         iters=15, backend=core.CudaBackend(), row_mask=_t(mask))
    assert kernels.launch_counts()["falkon_matvec_masked"] == 0  # the CPU runs the plain version
    _close(tm.predict(_t(xte)).numpy(), jm.predict(jnp.asarray(xte), backend="jnp"), 1e-3)
    with pytest.raises(ValueError, match="row_mask shape"):
        core.falkon_fit(core.make_kernel(), _t(x), _t(y), _t(x[:8]), 1e-3, iters=2,
                        backend=core.CudaBackend(), row_mask=_t(mask[:10]))


# -- FalkonClassifier ---------------------------------------------------------------


def _class_problem(n=360, d=5, classes=3, seed=0):
    """tests/test_scenarios.py's problem: Gaussian blobs, labels i mod classes."""
    kc, kx = jax.random.split(jax.random.PRNGKey(seed))
    means = jax.random.normal(kc, (classes, d)) * 3.0
    labels = np.arange(n) % classes
    return np.array(means[labels] + jax.random.normal(kx, (n, d))), labels


@pytest.mark.parametrize("classes", [3, 2])
def test_classifier_matches_reference_on_a_jax_center_set(classes):
    # 30 iterations, as the reference's test_classifier_matches_looped_per_class_krr:
    # at 15 the binary problem has not converged (squared residual 5e-6 of its
    # start) and the reference's own jnp and Pallas fits differ by 1.4e-3.
    x, labels = _class_problem(classes=classes)
    names = np.array(["ant", "bee", "cat"])[labels]
    ref = japi.FalkonClassifier(kernel="gaussian", sigma=2.0, sampler=japi.UniformSampler(m=64),
                                config=japi.FitConfig(lam=1e-4, iters=30, backend="jnp"))
    ref.fit(jnp.asarray(x), names)
    clf = FalkonClassifier(kernel="gaussian", sigma=2.0, sampler=UniformSampler(m=64),
                           config=FitConfig(lam=1e-4, iters=30, device="cpu"))
    clf.fit(x, names, center_set=_carry(ref.center_set_))
    np.testing.assert_array_equal(clf.classes_, ref.classes_)
    margins = clf.decision_function(x)
    assert margins.shape == (x.shape[0], classes)
    _close(margins.numpy(), ref.decision_function(jnp.asarray(x)), 1e-3)
    pred = clf.predict(x)
    np.testing.assert_array_equal(pred, ref.predict(jnp.asarray(x)))
    assert pred.dtype == clf.classes_.dtype
    assert clf.score(x, names) == pytest.approx(ref.score(jnp.asarray(x), names))
    proba = clf.predict_proba(x)
    torch.testing.assert_close(proba.sum(dim=1), torch.ones(x.shape[0]))
    assert torch.equal(proba.argmax(dim=1), margins.argmax(dim=1))
    labels_std, std = clf.predict(x, return_std=True)
    np.testing.assert_array_equal(labels_std, pred)
    assert std.shape == (x.shape[0],) and bool(torch.all(std >= 0))


def test_classifier_binary_margins_are_negatives_of_each_other():
    # CG is homogeneous of degree one in b: the two +-1 columns of a binary
    # problem solve for b and -b.
    x, labels = _class_problem(classes=2, seed=1)
    clf = FalkonClassifier(kernel="gaussian", sigma=2.0, sampler=UniformSampler(m=48),
                           config=FitConfig(lam=1e-4, iters=12, device="cpu")).fit(x, labels)
    m = clf.decision_function(x)
    assert m.shape == (x.shape[0], 2) and clf.score(x, labels) > 0.95
    assert float((m[:, 0] + m[:, 1]).abs().max()) <= 1e-5 * float(m.abs().max())


def test_classifier_validation_matches_reference():
    x, labels = _class_problem(n=60)
    ref = japi.FalkonClassifier(sampler=japi.UniformSampler(m=16),
                                config=japi.FitConfig(lam=1e-3, iters=5, backend="jnp"))
    clf = FalkonClassifier(sampler=UniformSampler(m=16),
                           config=FitConfig(lam=1e-3, iters=5, device="cpu"))
    cases = [((np.stack([labels, labels], axis=1),), {}),
             ((np.zeros(x.shape[0], np.int32),), {}),
             ((labels,), {"callback": lambda i, m: None})]
    for args, kw in cases:
        with pytest.raises(ValueError) as want:
            ref.fit(jnp.asarray(x), *args, **kw)
        with pytest.raises(ValueError) as got:
            clf.fit(x, *args, **kw)
        assert str(got.value) == str(want.value)


def test_classifier_takes_labels_as_a_tensor():
    x, labels = _class_problem(n=120, seed=2)
    clf = FalkonClassifier(kernel="gaussian", sigma=2.0, sampler=UniformSampler(m=32),
                           config=FitConfig(lam=1e-4, iters=10, device="cpu"))
    a = clf.fit(x, torch.from_numpy(labels)).decision_function(x)
    b = clf.fit(x, labels, key=0).decision_function(x)
    assert torch.equal(a, b) and list(clf.classes_) == [0, 1, 2]


# -- KFoldSweep ---------------------------------------------------------------------


def _cv_problem():
    """tests/test_scenarios.py's exact-CV problem (420 x 6)."""
    x = jax.random.normal(jax.random.PRNGKey(2), (420, 6))
    y = (jnp.sin(2 * x[:, 0]) + 0.3 * x[:, 1] ** 2
         + 0.05 * jax.random.normal(jax.random.PRNGKey(3), (420,)))
    return x, y


LAMS, ITERS, FOLDS = (1e-2, 5e-3), 30, 4


def _sweep(**kw):
    return KFoldSweep(kernel="gaussian", sigma=1.5, sampler=UniformSampler(m=64), lams=LAMS,
                      folds=FOLDS, iters=ITERS, device="cpu", **kw)


@pytest.mark.parametrize("n,folds", [(10, 3), (420, 4), (1001, 7), (5, 5)])
def test_fold_ids_are_balanced_and_seeded(n, folds):
    fid = fold_ids(3, n, folds)
    assert fid.dtype == torch.int32 and fid.shape == (n,)
    sizes = torch.bincount(fid.long(), minlength=folds)
    assert sizes.shape == (folds,) and int(sizes.max() - sizes.min()) <= 1
    assert torch.equal(fid, fold_ids(3, n, folds))
    # the reference deals the same way (its permutation differs: threefry)
    jsizes = np.bincount(np.asarray(jax_fold_ids(jax.random.PRNGKey(3), n, folds)),
                         minlength=folds)
    np.testing.assert_array_equal(np.sort(sizes.numpy()), np.sort(jsizes))


def test_sweep_scores_match_the_jax_sweep_on_its_folds_and_centers():
    x, y = _cv_problem()
    ref = japi.KFoldSweep(kernel="gaussian", sigma=1.5, sampler=japi.UniformSampler(m=64),
                          lams=LAMS, folds=FOLDS, iters=ITERS, backend="jnp", seed=0).run(x, y)
    scores, cs = _sweep()._scores(_t(x), _t(y), _t(ref.fold_id), _carry(ref.center_set))
    assert scores.shape == (len(LAMS), FOLDS)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref.scores), rtol=1e-3)
    np.testing.assert_array_equal(cs.idx.numpy(), np.asarray(ref.center_set.idx))


def test_sweep_repeats_with_the_same_seed_with_or_without_a_center_set():
    x, y = map(_t, _cv_problem())
    a, b = _sweep().run(x, y), _sweep().run(x, y)
    assert isinstance(a, KFoldResult) and a.lams == LAMS
    assert torch.equal(a.fold_id, b.fold_id) and torch.equal(a.scores, b.scores)
    assert torch.equal(a.center_set.idx, b.center_set.idx)
    c = _sweep().run(x, y, center_set=a.center_set)
    assert torch.equal(c.fold_id, a.fold_id) and torch.equal(c.scores, a.scores)
    other = _sweep(seed=1).run(x, y)
    assert not torch.equal(other.fold_id, a.fold_id)
    assert a.best_lam in LAMS and a.mean_scores.shape == (len(LAMS),)
    assert a.best_lam == LAMS[int(torch.argmin(a.scores.mean(dim=1)))]


def test_sweep_matches_naive_per_fold_refits_to_1e6():
    # tests/test_scenarios.py's gate on the port: each column of the masked
    # panel solve lands on a from-scratch refit on that fold's training rows.
    x, y = map(_t, _cv_problem())
    res = _sweep().run(x, y)
    kern = core.make_kernel("gaussian", sigma=1.5)
    m = int(res.center_set.count)
    centers, a_diag = x[res.center_set.idx[:m]], res.center_set.weight[:m]
    for li, lam in enumerate(LAMS):
        for f in range(FOLDS):
            train = res.fold_id != f
            model = core.falkon_fit(kern, x[train], y[train], centers, lam, a_diag=a_diag,
                                    iters=ITERS, backend="torch")
            mse = float(torch.mean((model.predict(x[~train]) - y[~train]) ** 2))
            got = float(res.scores[li, f])
            assert abs(mse - got) < 1e-6 * max(1.0, abs(mse)), (li, f, mse, got)


def test_sweep_validates_like_the_reference():
    x, y = map(_t, _cv_problem())
    with pytest.raises(ValueError, match="single-output"):
        _sweep().run(x, y[:, None])
    with pytest.raises(ValueError, match="folds must be"):
        KFoldSweep(folds=1, device="cpu").run(x, y)
    assert KFoldSweep().device == "cuda"


def test_sweep_and_classifier_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = map(_t, _cv_problem())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KFoldSweep(sampler=UniformSampler(m=8)).run(x, y)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FalkonClassifier(sampler=UniformSampler(m=8)).fit(x, (y > 0).long())


def test_api_exports_the_front_door_of_the_reference():
    # Every public name of the port's front door is one the reference's has
    # (the seed convention aside: torch generators, not PRNG keys).
    import repro_torch.api as tapi

    for name in ("FalkonClassifier", "KFoldSweep", "KFoldResult"):
        assert name in tapi.__all__ and hasattr(tapi, name)
    assert set(tapi.__all__) - set(japi.__all__) == {"as_generator"}
    assert all(hasattr(tapi, name) for name in tapi.__all__)
