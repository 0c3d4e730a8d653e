"""The five ``examples/*_torch.py`` scripts on the CPU, against the
reference where they compute what its examples compute.

Each script imports neither JAX nor the reference (checked in a clean
subprocess), raises without a card unless given ``--device cpu``, and runs
its ``main`` at a tiny size, and ``chip_smoke.py``'s examples phase runs
every gate at a tiny size. Parity on the same numpy data: quickstart's
FALKON-BLESS estimator on a fixed center set against
``repro.api.FalkonRegressor(..., center_set=...)``, both refereed by the
same fit in fp64 (ROADMAP C.2: at lam 1e-5 two fp32 solves of this problem
part by ~2e-3 of max|pred|): the port no farther from it than the
reference, plus 1e-3 of max|pred| (DESIGN.md §10); its KFoldSweep's scores, at convergence (ROADMAP C.1d),
on the reference's folds and a fixed center set within 1e-3 relative at the grid's
lam 1e-3 (at 1e-5 and 1e-7 an fp32 solve of this problem sits at its
noise floor: against fp64 naive per-fold refits both packages' fp32 sweeps
and refits read up to 1.4e-3 relative at 1e-5, ROADMAP C.2, so two fp32
orders cannot be held to 1e-3 there); serve_krr's served answers
against its model's ``predict`` within 1e-4 of max|pred| (the serving gate
of phase 12 and of tests/test_serving_krr.py); train_lm's losses equal to
a direct ``repro_torch.launch.train`` run's.
"""
import importlib.util
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
from repro_torch.api import KrrServer, make_kernel
from repro_torch.core import falkon_fit
from repro_torch.interop import center_set_from_numpy
from repro_torch.launch import train as launch_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("quickstart", "falkon_endtoend", "serve_krr", "serve_batched", "train_lm")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # one intra-op thread: these small shapes gain nothing from more, and
    # the suite runs several workers side by side on the machine's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _example(name):
    path = os.path.join(REPO, "examples", f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _carry(cs):
    return center_set_from_numpy(*map(np.asarray, cs))


def _finite(tree):
    if isinstance(tree, dict):
        return all(_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_finite(v) for v in tree)
    return not isinstance(tree, float) or np.isfinite(tree)


def test_the_examples_import_neither_jax_nor_the_reference():
    code = textwrap.dedent("""
        import importlib.util, os, sys
        for name in sys.argv[2:]:
            path = os.path.join(sys.argv[1], "examples", name + "_torch.py")
            spec = importlib.util.spec_from_file_location(name + "_torch", path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib", "repro.")) or m == "repro")
        print("BAD", bad)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code, REPO, *NAMES], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("name", NAMES)
def test_each_example_raises_without_a_card_unless_given_the_cpu(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"falkon_endtoend": ["--ckpt", str(tmp_path)],
            "train_lm": ["--ckpt-dir", str(tmp_path)]}.get(name, [])
    with pytest.raises(RuntimeError, match="(?i)no CUDA device"):
        _example(name).main(argv)


def test_quickstart_runs_on_the_cpu():
    out = _example("quickstart").main(["--n", "400", "--device", "cpu"])
    assert _finite(out) and out["bless"]["levels"] >= 2
    assert out["falkon_bless"]["r2"] > 0.5 and out["matern32_oracle"]["r2"] > 0.5
    assert out["multi_output"]["alpha_shape"][1] == 3
    assert out["kfold"]["lams"] == [1e-3, 1e-5, 1e-7]
    assert out["kfold"]["best_lam"] in out["kfold"]["lams"]


def test_falkon_endtoend_runs_on_the_cpu_and_saves_a_checkpoint(tmp_path):
    from repro_torch.checkpoint import latest_step

    out = _example("falkon_endtoend").main(["--n", "3000", "--m-cap", "200", "--device", "cpu",
                                            "--ckpt", str(tmp_path)])
    assert _finite(out) and out["world"] == 1 and out["m"] <= 200
    assert out["test_err"] < 0.2 and latest_step(str(tmp_path)) == 0


def test_serve_krr_runs_on_the_cpu():
    out = _example("serve_krr").main(["--n", "600", "--requests", "20", "--device", "cpu"])
    assert _finite(out) and out["requests"] == 20 and out["dispatches"] < 20


def test_serve_batched_runs_on_the_cpu():
    out = _example("serve_batched").main(["--steps", "3", "--device", "cpu"])
    assert _finite(out) and len(out["losses"]) == 3
    # two prompts of 2 tokens (13 tokens each: 1 + 12 steps), one joining after 4
    assert [len(t) for t in out["outputs"]] == [13, 13, 9]
    assert out["compress"]["to"][1] == 16 and out["compress"]["finite"]


def test_train_lm_losses_are_the_launchers_own(tmp_path):
    flags = ["--device", "cpu", "--steps", "3", "--seed", "1"]
    got = _example("train_lm").main(flags + ["--log-every", "1",
                                             "--ckpt-dir", str(tmp_path / "a")])
    want = launch_train.main(["--arch", "phi3-mini-3.8b", "--smoke", "--log-every", "1",
                              "--ckpt-every", "25", "--ckpt-dir", str(tmp_path / "b")] + flags)
    assert [s for s, _ in got] == [1, 2, 3] and got == want
    assert all(np.isfinite(v) for _, v in got)


# -- parity with the reference -----------------------------------------------------------------

N = 600


@pytest.fixture(scope="module")
def data():
    return _example("quickstart").clustered(N, seed=4)


def test_quickstart_falkon_bless_matches_the_reference_on_a_fixed_center_set(data):
    x, y = data
    qs = _example("quickstart")
    jkern = japi.make_kernel("gaussian", sigma=2.0)
    idx = np.random.default_rng(6).choice(N, 300, replace=False)
    cs = jcore.uniform_center_set(jnp.asarray(idx), N, 512)
    ref = japi.FalkonRegressor(kernel=jkern, config=japi.FitConfig(
        lam=qs.LAM_FALKON, iters=qs.ITERS, backend="jnp"))
    ref.fit(jnp.asarray(x), jnp.asarray(y), center_set=cs)
    kern = make_kernel("gaussian", sigma=2.0)
    est = qs.falkon_bless(kern, "cpu")
    est.fit(x, y, center_set=_carry(cs))
    want = np.asarray(ref.predict(jnp.asarray(x)))
    got = est.predict(x).numpy()
    # the referee: the same fit in fp64 (C.2's form; at lam 1e-5 two fp32
    # solves of this problem part by ~2e-3 of max|pred|)
    x64, z64 = torch.from_numpy(x).double(), torch.from_numpy(x[idx]).double()
    a64 = est.a_diag_.double()
    fit64 = falkon_fit(kern, x64, torch.from_numpy(y).double(), z64, qs.LAM_FALKON, a_diag=a64,
                       iters=qs.ITERS, backend="torch")
    ref64 = fit64.predict(x64).numpy()
    scale = np.abs(ref64).max()
    assert np.abs(got - ref64).max() <= np.abs(want - ref64).max() + 1e-3 * scale


def test_quickstart_kfold_scores_match_the_reference_at_convergence(data):
    x, y = data
    qs = _example("quickstart")
    lams = qs.SWEEP_LAMS[:1]  # 1e-3: converged in fp32 (the docstring)
    cs = jcore.uniform_center_set(jnp.asarray(np.random.default_rng(7).choice(N, 300)), N, 512)
    ref = japi.KFoldSweep(kernel="gaussian", sigma=2.0,
                          sampler=japi.BlessSampler(lam=1e-3, m_cap=400), lams=lams, folds=5,
                          iters=120, backend="jnp", seed=0).run(x, y, center_set=cs)
    kern = make_kernel("gaussian", sigma=2.0)
    args = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(np.array(ref.fold_id)),
            _carry(ref.center_set))
    got, _ = qs.kfold_sweep(kern, "cpu", lams=lams, iters=120)._scores(*args)
    more, _ = qs.kfold_sweep(kern, "cpu", lams=lams, iters=240)._scores(*args)
    np.testing.assert_allclose(got.numpy(), more.numpy(), rtol=1e-5)  # converged
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.scores), rtol=1e-3)


def test_serve_krr_answers_are_its_models_predictions(data):
    x, y = data
    sk = _example("serve_krr")
    est = sk.fitted(torch.from_numpy(x), torch.from_numpy(y), "cpu")
    server = KrrServer(est, max_wave=2048, min_bucket=64)
    reqs = sk.trace(x[:10], 30, seed=5)
    served, _ = sk.serve(server, reqs)
    assert server.stats["dispatches"] < len(reqs)
    direct = [est.model_.predict(torch.from_numpy(q)) for q in reqs]
    scale = max(float(d.abs().max()) for d in direct)
    for got, want in zip(served, direct):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-4 * scale


# -- chip_smoke.py's examples phase at a tiny size ------------------------------------------------


def test_chip_smoke_examples_phase_rehearses_on_the_cpu():
    sys.path.insert(0, REPO)
    import chip_smoke

    res = chip_smoke.examples("cpu", seed=1, flags={
        "quickstart": ["--n", "400"], "falkon_endtoend": ["--n", "3000", "--m-cap", "200"],
        "serve_krr": ["--n", "600", "--requests", "20"], "serve_batched": ["--steps", "3"],
        "serve_batched@jamba": ["--steps", "3"]})
    assert set(res["results"]) == set(chip_smoke.EXAMPLES) | {"falkon_endtoend@cpu"}
    assert res["test_err_gap"] <= chip_smoke.EXAMPLE_ERR_TOL
    assert res["results"]["falkon_endtoend@cpu"]["n"] == 3000  # the same size
    assert [s for s, _ in res["results"]["train_lm"]] == list(range(1, 9))
    assert sum(res["launches"].values()) == 0  # the CPU runs no kernel
    assert "examples" in chip_smoke.ALONE
