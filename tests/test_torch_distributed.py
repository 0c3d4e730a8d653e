"""The port's distributed FALKON (``repro_torch.core.distributed``,
``ShardedBackend``) against the local ``TorchBackend`` and the reference, on
the CPU.

The counterpart of tests/test_distributed.py: four gloo ranks, each its own
subprocess (rendezvous through a file, each with its own timeout), hold the
sharded contractions to the local ones at 1e-4 relative, the sharded fit to
the local fit and to the reference's ``falkon_fit(backend="jnp")`` at 1e-3
(alpha), the sharded Eq. 3 terms at 5e-4, and every rank's alpha to the
others' bit for bit (partials are summed in rank order). Ranks that each
pass their own data (other values, or other row counts) get a ValueError on
every rank, not a silently wrong fit or a hang. A world of one, in process,
is ``TorchBackend`` bit for bit.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core as jcore
from repro_torch.api import BlessSampler, FalkonRegressor, FitConfig
from repro_torch.core import TorchBackend, falkon_bless_fit, falkon_fit, make_kernel
from repro_torch.core.backend import ShardedBackend
from repro_torch.core.distributed import data_group, shard_rows, world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERN = make_kernel("gaussian", sigma=1.5)
N, D, M, WORLD = 1000, 6, 100, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # one intra-op thread: these small shapes gain nothing from more, and
    # the suite runs several workers side by side on the machine's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, size, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv", rank=rank,
                            world_size=size)
    from repro_torch.core import TorchBackend, falkon_fit, make_kernel
    from repro_torch.core.backend import (SHARD_MIN_ROWS, ShardedBackend, backend_for_device,
                                          default_backend)
    from repro_torch.core.distributed import (data_group, dist_knm_matvec, dist_knm_quadratic,
                                              dist_knm_t, falkon_fit_distributed, shard_rows)

    inp = {k: torch.from_numpy(v) for k, v in np.load(f"{tmp}/inputs.npz").items()}
    x, y, Y, z, v, vp, mask = (inp[k] for k in ("x", "y", "Y", "z", "v", "vp", "mask"))
    kern, tb, group = make_kernel("gaussian", sigma=1.5), TorchBackend(), data_group()

    def rel(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    # the contractions, also on 998 rows (two pad rows on the last rank)
    for n in (x.shape[0], 998):
        xs, xn = shard_rows(group, x[:n]), x[:n]
        op = dist_knm_quadratic(group, kern, xs, z, n)
        assert rel(op(v), tb.knm_quadratic(kern, xn, z)(v)) < 1e-4
        assert op(vp).shape == vp.shape
        assert rel(op(vp), tb.knm_quadratic(kern, xn, z)(vp)) < 1e-4
        mop = dist_knm_quadratic(group, kern, xs, z, n, mask=shard_rows(group, mask[:n]))
        assert rel(mop(vp), tb.knm_quadratic(kern, xn, z, mask=mask[:n])(vp)) < 1e-4
        kt = dist_knm_t(group, kern, xs, shard_rows(group, Y[:n]), z, n)
        assert rel(kt, tb.knm_t(kern, xn, z, Y[:n])) < 1e-4
        mv = dist_knm_matvec(group, kern, xs, z, vp, n)
        assert mv.shape == (n, 3) and rel(mv, tb.knm_matvec(kern, xn, z, vp)) < 1e-4

    # the Eq. 3 terms on a padded center buffer (the last 10 slots invalid)
    sb = ShardedBackend()
    m = z.shape[0]
    zmask = torch.arange(m) < m - 10
    reg = torch.where(zmask, torch.tensor(1e-3 * x.shape[0]), torch.tensor(1.0))
    q = sb.masked_quadform(kern, x, z, zmask, reg)
    q0 = tb.masked_quadform(kern, x, z, zmask, reg)
    s, s0 = sb.rls_scores(kern, x, z, zmask, reg, 1.0), tb.rls_scores(kern, x, z, zmask, reg, 1.0)
    assert float(((q - q0).abs() / (q0.abs() + 1e-6)).max()) < 5e-4
    assert float(((s - s0).abs() / (s0.abs() + 1e-6)).max()) < 5e-4

    # the fits
    fd = falkon_fit_distributed(group, kern, x, y, z, 1e-3, iters=20)
    fdm = falkon_fit_distributed(group, kern, x, Y, z, 1e-3, iters=20)
    fl = falkon_fit(kern, x, y, z, 1e-3, iters=20, backend="torch")
    flm = falkon_fit(kern, x, Y, z, 1e-3, iters=20, backend="torch")
    assert rel(fd.alpha, fl.alpha) < 1e-3 and rel(fdm.alpha, flm.alpha) < 1e-3
    assert fdm.alpha.shape == (m, 3)

    # the selection: sharded from SHARD_MIN_ROWS rows in a group of four;
    # data on the CPU still needs the caller to name the CPU
    picked = backend_for_device("cpu", n=SHARD_MIN_ROWS)
    assert isinstance(picked, ShardedBackend) and picked.inner == tb
    assert backend_for_device("cpu", n=SHARD_MIN_ROWS - 1) == tb
    try:
        default_backend("cpu", n=SHARD_MIN_ROWS)
        raise AssertionError("default_backend took data on the CPU")
    except RuntimeError:
        pass
    assert ShardedBackend.collectives > 0

    # ranks that each pass their own data: other values (rank r adds r), then
    # other row counts (rank r drops r rows)
    errors = []
    for xr in (x + rank, x[: x.shape[0] - rank]):
        try:
            falkon_fit(kern, xr, y[: xr.shape[0]], z, 1e-3, iters=3, backend=ShardedBackend())
            errors.append("")
        except ValueError as e:
            errors.append(str(e))
    np.savez(f"{tmp}/rank{rank}.npz", alpha=fd.alpha.numpy(), alpha3=fdm.alpha.numpy(),
             pred=fd.predict(x).numpy(), collectives=ShardedBackend.collectives,
             errors=np.array(errors))
    dist.destroy_process_group()
    print("RANK_OK")
""")


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = np.sin(2 * x[:, 0])
    Y = np.stack([y, np.cos(x[:, 1]), 0.3 * x[:, 2] ** 2], axis=1)
    return {"x": x, "y": y.astype(np.float32), "Y": Y.astype(np.float32), "z": x[:M],
            "v": rng.standard_normal(M).astype(np.float32),
            "vp": rng.standard_normal((M, 3)).astype(np.float32),
            "mask": (rng.random((N, 3)) > 0.3).astype(np.float32)}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """(inputs, each rank's results) of one run of the rank script."""
    tmp_path = tmp_path_factory.mktemp("ranks")
    inp = _inputs()
    np.savez(tmp_path / "inputs.npz", **inp)
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(WORLD), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "RANK_OK" in out, f"rank {r}:\n{out}"
    return inp, [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]


def test_distributed_matches_local_and_reference_on_4_gloo_ranks(four_ranks):
    inp, ranks = four_ranks
    for res in ranks[1:]:  # the same bits on every rank
        for key in ("alpha", "alpha3", "pred"):
            np.testing.assert_array_equal(res[key], ranks[0][key])
    assert all(int(res["collectives"]) > 0 for res in ranks)
    x, z = jnp.asarray(inp["x"]), jnp.asarray(inp["z"])
    jk = jcore.make_kernel("gaussian", sigma=1.5)
    for key, y in (("alpha", inp["y"]), ("alpha3", inp["Y"])):
        want = np.asarray(jcore.falkon_fit(jk, x, jnp.asarray(y), z, 1e-3, iters=20,
                                           backend="jnp").alpha)
        assert np.linalg.norm(ranks[0][key] - want) / np.linalg.norm(want) < 1e-3


def test_sharded_ranks_holding_different_data_raise(four_ranks):
    _, ranks = four_ranks
    for r, res in enumerate(ranks):
        values, rows = (str(e) for e in res["errors"])
        assert "ranks [1, 2, 3] hold other rows or values" in values, (r, values)
        assert "ranks [1, 2, 3] hold other rows or values" in rows, (r, rows)


def _cpu_problem(n=600, d=5, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    return x, torch.sin(2 * x[:, 0]) + 0.3 * x[:, 1] ** 2


def _backend_outputs(be, x, y):
    z = x[:40]
    zmask = torch.arange(40) < 35
    reg = torch.where(zmask, torch.tensor(0.6), torch.tensor(1.0))
    mask = (torch.arange(x.shape[0]) % 3 != 0).float()
    vp = torch.linspace(-1, 1, 80).reshape(40, 2)
    quad, kty = be.knm_operators(KERN, x, z, y, mask=mask)
    return [be.gram_block(KERN, x, z), be.masked_quadform(KERN, x, z, zmask, reg),
            be.rls_scores(KERN, x, z, zmask, reg, 0.6), be.knm_quadratic(KERN, x, z)(vp[:, 0]),
            be.knm_quadratic(KERN, x, z, mask=mask)(vp), quad(vp[:, 1]), kty,
            be.knm_t(KERN, x, z, y), be.knm_matvec(KERN, x, z, vp)]


def test_sharded_world_of_one_is_torch_backend_bitwise():
    assert data_group() is None and world(None) == (0, 1)
    x, y = _cpu_problem()
    assert shard_rows(None, x) is x
    before = ShardedBackend.collectives
    for got, want in zip(_backend_outputs(ShardedBackend(), x, y),
                         _backend_outputs(TorchBackend(), x, y)):
        assert torch.equal(got, want)
    assert ShardedBackend.collectives == before  # no group, no collective
    fit = falkon_fit(KERN, x, y, x[:40], 1e-3, iters=10, backend="sharded")
    host = falkon_fit(KERN, x, y, x[:40], 1e-3, iters=10, backend="torch", fused=False)
    assert torch.equal(fit.alpha, host.alpha)


def test_sharded_group_of_one_rank_is_torch_backend_bitwise(tmp_path):
    # an initialized group of one rank: every method issues its collectives
    # and still gives TorchBackend's bits
    x, y = _cpu_problem(seed=1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0, world_size=1)
    try:
        before = ShardedBackend.collectives
        got = _backend_outputs(ShardedBackend(), x, y)
        assert ShardedBackend.collectives > before
    finally:
        dist.destroy_process_group()
    for g, w in zip(got, _backend_outputs(TorchBackend(), x, y)):
        assert torch.equal(g, w)


def test_sharded_regressor_reproduces_falkon_bless_fit_bitwise():
    # the port's side of the reference's red test_api.py::...bitwise[sharded]
    x, y = _cpu_problem(n=400, d=6, seed=2)
    est = FalkonRegressor(kernel=KERN, sampler=BlessSampler(lam=1e-3, q2=3.0, m_cap=200),
                          config=FitConfig(lam=1e-5, iters=15, backend="sharded", device="cpu"))
    est.fit(x, y, key=11)
    ref = falkon_bless_fit(11, KERN, x, y, 1e-3, 1e-5, iters=15, q2=3.0, m_cap=200,
                           backend="sharded", device="cpu")
    assert torch.equal(est.model_.centers, ref.centers)
    assert torch.equal(est.model_.alpha, ref.alpha)
    assert isinstance(est.model_.backend, ShardedBackend)


def test_jax_reference_single_device_sharded_matches_port_sharded():
    # the reference's ShardedBackend on its 1-device mesh against the port's
    # world of one, on the same numpy data and centers (1e-3, alpha)
    x, y = _cpu_problem(n=500, d=6, seed=3)
    want = jcore.falkon_fit(jcore.make_kernel("gaussian", sigma=1.5), jnp.asarray(x.numpy()),
                            jnp.asarray(y.numpy()), jnp.asarray(x[:50].numpy()), 1e-3, iters=20,
                            backend=jcore.ShardedBackend()).alpha
    assert len(jax.devices()) == 1
    got = falkon_fit(KERN, x, y, x[:50], 1e-3, iters=20, backend="sharded").alpha
    want = torch.from_numpy(np.asarray(want))
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) < 1e-3


def test_chip_smoke_phase_13_rehearses_on_the_cpu():
    # phase 13 at a tiny size on phase 4's and phase 5's tiny outputs, with
    # phase 12's fp64 referee built the same way: every gate runs, the two
    # ranks of (b) in their own processes
    sys.path.insert(0, REPO)
    import chip_smoke
    from repro_torch.core import FalkonModel

    res = chip_smoke.end_to_end("cpu", n_train=1536, n_test=512, m=120, iters=10,
                                refit_rows=1024, referee_rows=256)
    tensors = res.pop("tensors")
    fb = chip_smoke.bless_end_to_end("cpu", tensors, lam_bless=1e-2, m_cap=400, score_rows=256,
                                     iters=10)
    bless_t = fb.pop("tensors")
    kern = make_kernel("gaussian", sigma=4.0)
    ref64 = chip_smoke.fp64_referee(kern, tensors["x"], tensors["y"], bless_t["z"],
                                    bless_t["a_diag"], 1e-6, 10, tensors["xte"])
    scale64 = float(ref64.abs().max())
    pred = FalkonModel(centers=bless_t["z"], alpha=bless_t["alpha"], kernel=kern).predict(
        tensors["xte"], backend="torch")
    referee = {"ref64": ref64, "scale64": scale64,
               "k2_fit": float((pred.double() - ref64).abs().max()) / scale64}
    rest = chip_smoke.core_rest("cpu", tensors, bless_t, referee, fb["test_error"], iters=10,
                                fused_rows=1536, timeout=120)
    assert rest["a"]["bit_identical"] and rest["a"]["collectives"] > 0
    assert rest["b"]["ranks_bit_identical"] and rest["b"]["picked"] == ["TorchBackend"] * 2  # < 2^15 rows
    assert rest["c"]["events"] == ["knm_quadratic"] and rest["c"]["happy_events"] == 0
    assert rest["c"]["event_fallbacks"] == ["torch"] and rest["c"]["raised"] is None  # the CPU
    # on the CPU the fused fit is the host loop: no plan
    assert rest["d"]["first"]["plans_built"] == 0 and rest["d"]["second"]["plans_built"] == 0
    assert sum(rest["launches"].values()) == 0  # the CPU runs no kernel
