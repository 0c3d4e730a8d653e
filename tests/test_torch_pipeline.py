"""The port's GPipe schedule (``repro_torch.training.pipeline``) against the
reference on the CPU.

The reference's problem (tests/test_pipeline.py): 8 tanh layers of d 16, 8
microbatches of 2, the weights and inputs made with numpy from a seed.
Four gloo ranks, each its own subprocess (rendezvous through a file, each
with its own timeout), run the pipelined forward and the gradient of
loss = sum(out^2); the output is held to the reference's sequential ``scan``
at 1e-5 and every stage's gradient to ``jax.grad`` of it at 1e-4 (absolute,
as the reference's test holds its pipelined run; that run itself is red,
ROADMAP C.4, so the port is held to the function it computes). Every rank's
``CollectiveMeter`` bytes equal the count from the shapes: (S + M - 1)
activations handed on forward and again backward, one (M, mb, d) buffer
summed. In-process: a world of one, ``stack_stages`` against the
reference's, and the meter outside any group. Last, ``chip_smoke.py``'s
phase 16 (the launcher killed and relaunched, GPipe on two ranks) at a tiny
size on the CPU.
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

from repro.training.pipeline import stack_stages as jstack_stages
from repro_torch.launch.roofline import CollectiveMeter
from repro_torch.training import pipeline_apply, stack_stages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STAGES, N_MB, MB, D, N_LAYERS = 4, 8, 2, 16, 8

_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, size, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv", rank=rank,
                            world_size=size)
    from repro_torch.launch.roofline import CollectiveMeter
    from repro_torch.training import pipeline_apply, stack_stages

    inp = np.load(f"{tmp}/inputs.npz")
    w = stack_stages(torch.from_numpy(inp["w"]), size)[rank].clone().requires_grad_(True)
    x = torch.from_numpy(inp["x"])

    def stage_fn(ws, xm):
        for wl in ws:
            xm = torch.tanh(xm @ wl)
        return xm

    run = pipeline_apply(stage_fn, size, x.shape[0], dist.group.WORLD)
    with CollectiveMeter() as meter:
        out = run(w, x)
        torch.sum(out ** 2).backward()
    np.savez(f"{tmp}/rank{rank}.npz", out=out.detach().numpy(), grad=w.grad.numpy(),
             **{f"bytes_{k}": v for k, v in meter.bytes.items()},
             **{f"calls_{k}": v for k, v in meter.calls.items()})
    dist.destroy_process_group()
    print("RANK_OK")
""")


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((N_LAYERS, D, D)) * (0.5 / D ** 0.5)).astype(np.float32)
    x = rng.standard_normal((N_MB, MB, D)).astype(np.float32)
    return w, x


def _seq(w, x):
    """The reference test's sequential ``scan`` over the layer stack."""
    def body(xc, wl):
        return jnp.tanh(xc @ wl), None
    out, _ = jax.lax.scan(body, x.reshape(-1, D), w)
    return out.reshape(x.shape)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gpipe")
    w, x = _problem()
    np.savez(tmp / "inputs.npz", w=w, x=x)
    script = tmp / "rank.py"
    script.write_text(_RANK)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(N_STAGES), str(tmp)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(N_STAGES)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "RANK_OK" in out, f"rank {r}:\n{out[-3000:]}"
    return w, x, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N_STAGES)]


def test_gpipe_on_4_gloo_ranks_matches_the_reference_sequential_scan_and_its_grad(four_ranks):
    w, x, ranks = four_ranks
    want = np.asarray(_seq(jnp.asarray(w), jnp.asarray(x)))
    for r in ranks:  # every rank holds the last stage's output
        assert float(np.max(np.abs(r["out"] - want))) < 1e-5
        np.testing.assert_array_equal(r["out"], ranks[-1]["out"])
    gs = np.asarray(jax.grad(lambda w_, x_: jnp.sum(_seq(w_, x_) ** 2))(jnp.asarray(w),
                                                                           jnp.asarray(x)))
    # rank s holds stage s: the reference's stack_stages slice s of the layers
    gstages = np.asarray(jstack_stages(jnp.asarray(gs), N_STAGES))
    for s, r in enumerate(ranks):
        assert float(np.max(np.abs(r["grad"] - gstages[s]))) < 1e-4


def test_collective_meter_counts_the_pipeline_bytes_from_the_shapes(four_ranks):
    _, x, ranks = four_ranks
    act = MB * D * x.itemsize
    steps = N_STAGES + N_MB - 1
    for r in ranks:
        got = {k[len("bytes_"):]: int(v) for k, v in r.items() if k.startswith("bytes_")}
        assert got == {"all-gather": 0, "all-reduce": N_MB * act, "reduce-scatter": 0,
                       "all-to-all": 0, "collective-permute": 2 * steps * act, "broadcast": 0}
        calls = {k[len("calls_"):]: int(v) for k, v in r.items() if k.startswith("calls_")}
        # one batch_isend_irecv per step and direction, one sum
        assert calls["collective-permute"] == 2 * steps and calls["all-reduce"] == 1


def test_a_world_of_one_runs_the_microbatches_in_order():
    w, x = _problem(1)
    wt = torch.from_numpy(w).requires_grad_(True)

    def stage_fn(ws, xm):
        for wl in ws:
            xm = torch.tanh(xm @ wl)
        return xm

    with CollectiveMeter() as meter:
        out = pipeline_apply(stage_fn, 1, N_MB)(wt, torch.from_numpy(x))
        torch.sum(out ** 2).backward()
    assert meter.total == 0
    want = np.asarray(_seq(jnp.asarray(w), jnp.asarray(x)))
    assert float(np.max(np.abs(out.detach().numpy() - want))) < 1e-5
    gs = np.asarray(jax.grad(lambda w_, x_: jnp.sum(_seq(w_, x_) ** 2))(jnp.asarray(w),
                                                                           jnp.asarray(x)))
    assert float(np.max(np.abs(wt.grad.numpy() - gs))) < 1e-4
    with pytest.raises(ValueError, match="2 stages"):
        pipeline_apply(stage_fn, 2, N_MB)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(stage_fn, 1, N_MB)(wt, torch.from_numpy(x[:3]))


@pytest.mark.parametrize("n_stages", [1, 2, 4, 8])
def test_stack_stages_matches_the_reference(n_stages):
    w, _ = _problem(2)
    tree = {"w": w, "b": [w[:, 0]]}
    got = stack_stages({"w": torch.from_numpy(w), "b": [torch.from_numpy(w[:, 0])]}, n_stages)
    want = jstack_stages(jax.tree.map(jnp.asarray, tree), n_stages)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["b"][0].numpy(), np.asarray(want["b"][0]))
    with pytest.raises(ValueError, match="stages"):
        stack_stages(torch.zeros(6, 2), 4)


def test_collective_meter_restores_torch_distributed_and_refuses_nesting():
    import torch.distributed as dist

    before = dist.all_reduce
    with CollectiveMeter():
        assert dist.all_reduce is not before
        with pytest.raises(RuntimeError, match="already active"):
            CollectiveMeter().__enter__()
    assert dist.all_reduce is before


def test_chip_smoke_phase_16_rehearses_on_the_cpu():
    """Phase 16 at a tiny size: the launcher killed after a checkpoint and
    relaunched to the same bits, GPipe over two gloo ranks against the
    blocks in sequence, the collective bytes from the shapes."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from repro_torch.configs import get_config, smoke

    res = chip_smoke.launch("cpu", cfg=smoke(get_config("mamba2-370m")), smoke=True, steps=4,
                            batch=2, seq=32, ckpt_every=2, pipe_mb=(1, 32),
                            pipe_overrides=dict(n_layers=2, d_model=128, ssm_state=16,
                                                ssm_headdim=32, vocab_size=512))
    la, gp = res["launcher"], res["gpipe"]
    assert la["bit_identical"] and la["runs"]["relaunched"]["restored"] == 2
    assert la["runs"]["killed"]["latest_at_kill"] == 2
    assert la["losses_relaunched"] == la["losses"][2:]
    assert gp["out_err"] == 0.0 and gp["grad_worst"] <= chip_smoke.PIPE_GRAD_TOL
    assert gp["bytes"][0] == {**gp["bytes"][0], **gp["expected_bytes"]}
    assert res["launches"] == {"flash_attention": 0, "ssd": 0}  # plain on the CPU
    assert chip_smoke.LAUNCH_ARCH == "mamba2-370m" and "launch" in chip_smoke.ALONE
