"""The LM's train step sharded across ranks (FSDP over ``data``, tensor
parallelism over ``model``) against the reference on the CPU.

For each mesh, four gloo ranks (subprocesses, a ``file://`` rendezvous, a
timeout each) compute every configuration in one spawn; the parent asserts.
The weights are the reference's ``init_params`` carried across by
``interop`` and cut to each rank's blocks by ``distribute_state``; each rank
takes its rows of the same batches. Held, in fp32, to the reference's
``make_train_step`` run unsharded (JAX on the CPU; its first step's loss,
and its gradient from AdamW's first moment) and to the port's one-rank
step: the loss within 1e-5 relative, every gradient (gathered to rank 0 by
``gather_state``) within 1e-4 of its max (a gradient 0 in exact arithmetic,
the top_k = 1 router's, within 1e-6 of the model's largest), three steps'
losses within 1e-4 relative (one at top_k = 1) and the params after them
within 1e-2 of the steps' movement from the one-rank run's (a MoE case's
over the entries whose first gradient lies beyond the leaf's rounding, its
largest sharded-against-one-rank distance). Meshes (4, 1), (2, 2) and
(1, 4); configurations: qwen3-32b's smoke (GQA, qk-norm), the same with a
width and an ff that do not divide (padded blocks), gemma-2b's (one kv
head, tied embedding), mamba2-370m's, and MoE in each of the reference's
layouts: Jamba's (``auto``: ``replicate`` at smoke size; its drops at
S = 32 counted from ``route_group``'s slots on every rank), Jamba's with
``moe_sharding="ep"`` (experts over ``model``), granite-moe-3b-a800m's with
``"tp"`` (each expert's ff columns over ``model``) and top_k 4 (a combine
of four choices split across ranks), and llama4-scout's with ``"ep"``
(top_k 1, a shared expert). Each rank's
state bytes equal the dry run's for its ``MeshShape``; ``gather_state``
inverts ``distribute_state`` bit for bit; each rank's ``CollectiveMeter``
bytes equal ``chip_smoke.shard_step_bytes``, the closed form of the scheme;
a one-rank checkpoint (gemma-2b's) restores onto each mesh and back. Last, the launcher
under ``torchrun`` on four ranks, SIGKILLed after a checkpoint and
relaunched, ends in the bits of an uninterrupted run (``chip_smoke.py``'s
phase 17 (a) at a tiny size).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.optim import OptConfig as JOptConfig
from repro.training import make_train_step as jmake_train_step
from repro.training import train_state_init as jtrain_state_init
from repro_torch import configs
from repro_torch.data import SyntheticLM
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import LM
from repro_torch.optim import OptConfig
from repro_torch.sharding import (MeshShape, PartitionSpec, activate_mesh, block, collectives,
                                  distribute_state, gather_state, shard)
from repro_torch.training import loss_and_grads, make_train_step, train_state_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
MESHES = [(4, 1), (2, 2), (1, 4)]
# name -> (arch, overrides of its smoke config)
CONFIGS = {"qwen3": ("qwen3-32b", {}),
           "qwen3-uneven": ("qwen3-32b", {"d_model": 126, "d_ff": 250}),
           "gemma": ("gemma-2b", {}),
           "mamba2": ("mamba2-370m", {}),
           "jamba": ("jamba-v0.1-52b", {}),
           "jamba-ep": ("jamba-v0.1-52b", {"moe_sharding": "ep"}),
           "granite-tp": ("granite-moe-3b-a800m", {"moe_sharding": "tp", "top_k": 4}),
           "llama4-ep": ("llama4-scout-17b-a16e", {"moe_sharding": "ep"})}
#: the MoE cases, and the one that must drop choices at S = SEQ
MOE = ("jamba", "jamba-ep", "granite-tp", "llama4-ep")
DROPS = "jamba-ep"
ROWS, SEQ, CHUNKS, STEPS = 4, 32, 4, 3
#: a gradient that is 0 in exact arithmetic, against the model's largest
#: (fp32 rounding leaves ~1e-8 of it)
ZERO_TOL = 1e-6
OPT = dict(peak_lr=3e-3, warmup=2, total_steps=10)


def _cfgs(name):
    arch, kw = CONFIGS[name]
    kw = dict(dtype="float32", **kw)
    return (dataclasses.replace(jconfigs.smoke(jconfigs.get_config(arch)), **kw),
            dataclasses.replace(configs.smoke(configs.get_config(arch)), **kw))


def _batch(cfg, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (ROWS, SEQ + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


_RANK = textwrap.dedent("""
    import sys, traceback
    import torch
    import torch.distributed as dist

    rank, world, tmp, dp, mp = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                int(sys.argv[4]), int(sys.argv[5]))
    sys.path.insert(0, sys.argv[6])
    import chip_smoke
    # placed as chip_smoke.py places its ranks: on the CPU, gloo
    chip_smoke.rank_setup(rank, world, tmp, *chip_smoke.rank_route(rank, world, "cpu", 1))
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.checkpoint.ckpt import _leaves
    from repro_torch.launch.roofline import CollectiveMeter
    from repro_torch.models import LM, param_specs
    from repro_torch.optim import OptConfig, adamw_init, opt_state_specs
    from repro_torch.sharding import (MeshCtx, collectives, distribute_state, gather_state,
                                      set_mesh_ctx)
    from repro_torch.training import TrainState, loss_and_grads, make_train_step
    from repro_torch.training import train

    mesh = init_device_mesh("cpu", (dp, mp), mesh_dim_names=("data", "model"))
    ctx = MeshCtx(mesh=mesh)
    set_mesh_ctx(ctx)
    plan = collectives.active()
    inp = torch.load(f"{tmp}/inputs.pt", weights_only=False)

    def rows(batch):
        per = batch["tokens"].shape[0] // plan.batch_ways
        return {k: v[plan.batch_index * per:(plan.batch_index + 1) * per]
                for k, v in batch.items()}

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for _, t in _leaves(tree))

    out = {}
    for name, case in inp["cases"].items():
        cfg, params = case["cfg"], case["params"]
        pspecs = param_specs(cfg, ctx)
        sspecs = TrainState(pspecs, opt_state_specs(pspecs))
        lm = LM(cfg, device="meta")
        res = {}
        local = distribute_state(params, pspecs, mesh)
        with chip_smoke.moe_drops() as calls:
            loss, grads = loss_and_grads(lm, local, rows(case["batches"][0]),
                                         loss_chunks=inp["chunks"])
        res["drops"] = [d for d, _ in calls]
        res["loss"] = float(loss)
        res["grads"] = gather_state(grads, pspecs, mesh, params)
        # the backward with no mesh ctx on its thread (on the card it runs on
        # the autograd engine's device thread): the remat recompute must run
        # under the forward's
        def forward(self, batch, wrt):
            loss = train.loss_fn(self.lm, batch, n_chunks=self.n_chunks)
            set_mesh_ctx(None)
            try:
                return loss.detach(), torch.autograd.grad(loss, wrt)
            finally:
                set_mesh_ctx(ctx)

        plain, train._Objective.forward = train._Objective.forward, forward
        try:
            _, again = loss_and_grads(lm, local, rows(case["batches"][0]),
                                      loss_chunks=inp["chunks"])
        finally:
            train._Objective.forward = plain
        res["other_thread"] = all(torch.equal(again[k], grads[k]) for k in grads)
        full = TrainState(params, adamw_init(params))
        state = distribute_state(full, sspecs, mesh)
        res["state_bytes"] = (nbytes(state.params), nbytes(state.opt))
        back = gather_state(state, sspecs, mesh, full)
        if rank == 0:
            res["identity"] = all(
                a.dtype == b.dtype and a.shape == b.shape
                and a.reshape(-1).view(torch.uint8).equal(b.reshape(-1).view(torch.uint8))
                for (_, a), (_, b) in zip(_leaves(back), _leaves(full), strict=True))
        step = make_train_step(cfg, OptConfig(**inp["opt"]), loss_chunks=inp["chunks"])
        for p in state.params.values():
            p.requires_grad_(True)
        res["losses"] = []
        for i, batch in enumerate(case["batches"]):
            if i == 0:
                with CollectiveMeter() as meter:
                    state, m = step(state, rows(batch))
                res["bytes"] = dict(meter.bytes)
            else:
                state, m = step(state, rows(batch))
            res["losses"].append(float(m["loss"]))
            if i == 0 and case["first_params"]:
                res["params1"] = gather_state(state.params, pspecs, mesh, params)
        res["params"] = gather_state(state.params, pspecs, mesh, params)
        res["expected_bytes"] = chip_smoke.shard_step_bytes(
            cfg, dp, mp, case["batches"][0]["tokens"].shape[0] // plan.batch_ways,
            case["batches"][0]["tokens"].shape[1], inp["chunks"])
        out[name] = res
    if "ckpt" in inp:  # a one-rank checkpoint onto this mesh
        case = inp["cases"][inp["ckpt"]["case"]]
        pspecs = param_specs(case["cfg"], ctx)
        want = distribute_state(case["params"], pspecs, mesh)
        _, got = restore_checkpoint(inp["ckpt"]["dir"], {k: 0 for k in want}, specs=pspecs,
                                    mesh=mesh)
        out["_ckpt"] = {"equal": all(torch.equal(got[k], want[k]) for k in want),
                        "shapes": all(got[k].shape == want[k].shape for k in want),
                        "back": gather_state(got, pspecs, mesh, case["params"])}
    if rank == 0:
        torch.save(out, f"{tmp}/out.pt")
    set_mesh_ctx(None)
    dist.destroy_process_group()
    print("RANK_OK")
""")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cases():
    """Per configuration: the carried weights, the batches, and the
    reference's and the port's unsharded loss, gradient and steps."""
    out, seen = {}, {}
    for name in CONFIGS:
        jcfg, tcfg = _cfgs(name)
        # the layout changes nothing on one rank: a case that differs from an
        # earlier one in it alone shares that case's unsharded results
        plain = dataclasses.replace(tcfg, moe_sharding="auto")
        if plain in seen:
            out[name] = {**out[seen[plain]], "cfg": tcfg}
            continue
        seen[plain] = name
        jstate = jtrain_state_init(jcfg, jax.random.PRNGKey(0))
        params = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jstate.params))
        batches = [_batch(tcfg, 10 + i) for i in range(STEPS)]
        tb = [{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
              for b in batches]
        jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
        jopt = JOptConfig(**OPT)
        jstep = jax.jit(jmake_train_step(jcfg, jopt, loss_chunks=CHUNKS))
        jlosses = []
        for b in jb:
            jstate, jm = jstep(jstate, b)
            jlosses.append(float(jm["loss"]))
            if len(jlosses) == 1:
                # the reference's value_and_grad(loss_fn) at the initial params:
                # the first step's loss, and its gradient from AdamW's first mu,
                # (1 - b1) g min(1, clip / |g|)
                scale = min(1.0, jopt.clip_norm / max(float(jm["grad_norm"]), 1e-9))
                jg = jax.tree.map(lambda m: np.asarray(m) / ((1 - jopt.b1) * scale),
                                  jstate.opt["mu"])
        jl = jlosses[0]
        lm = LM(tcfg, device="cpu")
        lm.load_state_dict(params, strict=True)
        state = train_state_init(lm)
        with chip_smoke.moe_drops() as calls:
            loss, grads = loss_and_grads(lm, state.params, tb[0], loss_chunks=CHUNKS)
        drops = [d for d, _ in calls]
        step = make_train_step(tcfg, OptConfig(**OPT), loss_chunks=CHUNKS)
        losses = []
        for b in tb:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            if len(losses) == 1:
                first = {k: v.detach().clone() for k, v in state.params.items()}
        out[name] = {"cfg": tcfg, "params": params, "batches": tb,
                     "jax_loss": float(jl),
                     "jax_grads": lm_params_from_numpy(tcfg, jg),
                     "jax_losses": jlosses, "loss": float(loss), "grads": grads,
                     "losses": losses, "drops": drops, "first": first,
                     "final": {k: v.detach().clone() for k, v in state.params.items()}}
    return out


def _spawn(tmp, dp, mp, inputs):
    torch.save(inputs, tmp / "inputs.pt")
    script = tmp / "rank.py"
    script.write_text(_RANK)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "4", str(tmp), str(dp),
                               str(mp), REPO], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(4)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "RANK_OK" in out, f"rank {r}:\n{out[-3000:]}"
    return torch.load(tmp / "out.pt")


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def mesh_run(request, cases, tmp_path_factory):
    dp, mp = request.param
    tmp = tmp_path_factory.mktemp(f"mesh{dp}x{mp}")
    inputs = {"chunks": CHUNKS, "opt": OPT,
              "cases": {k: {"cfg": c["cfg"], "params": c["params"], "batches": c["batches"],
                            "first_params": bool(_zero_leaves(c["cfg"]))}
                        for k, c in cases.items()}}
    from repro_torch.checkpoint import save_checkpoint

    save_checkpoint(str(tmp / "ckpt"), 0, cases["gemma"]["params"])
    inputs["ckpt"] = {"case": "gemma", "dir": str(tmp / "ckpt")}
    return (dp, mp), _spawn(tmp, dp, mp, inputs)


def _sharded(mesh_run, cases, name):
    """(mesh, rank 0's results, the unsharded ones)."""
    (dp, mp), out = mesh_run
    return (dp, mp), out[name], cases[name]


def _zero_leaves(cfg) -> set:
    """The leaves whose gradient is 0 in exact arithmetic: the router at
    top_k = 1, whose one choice's gate is renormalised to p / p = 1."""
    if cfg.top_k != 1:
        return set()
    return {f"layers.{i}.moe.router" for i in range(cfg.n_layers) if cfg.mlp_kind(i) == "moe"}


def _close(got: dict, want: dict, tol: float, zero: set = frozenset()):
    """Each leaf within ``tol`` of its own max|g|; a leaf in ``zero`` (its
    exact gradient 0, both sides fp32 rounding) is 0 on both sides to
    within ZERO_TOL of the largest gradient of the model."""
    assert set(got) == set(want)
    top = max(float(v.abs().max()) for v in want.values())
    bad = {}
    for k, v in got.items():
        assert v.shape == want[k].shape and v.dtype == want[k].dtype, k
        if k in zero:
            if not max(float(v.abs().max()), float(want[k].abs().max())) <= ZERO_TOL * top:
                bad[k] = (float(v.abs().max()), float(want[k].abs().max()), top)
            continue
        scale = float(want[k].abs().max())
        err = float((v - want[k]).abs().max())
        if not err <= tol * scale:
            bad[k] = (err, scale)
    assert not bad, bad


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_loss_and_gradient_match_the_reference_and_one_rank(mesh_run, cases, name):
    _, res, case = _sharded(mesh_run, cases, name)
    for want in (case["jax_loss"], case["loss"]):
        assert abs(res["loss"] - want) <= 1e-5 * abs(want)
    assert res["other_thread"]
    zero = _zero_leaves(case["cfg"])
    _close(res["grads"], case["jax_grads"], 1e-4, zero)
    _close(res["grads"], case["grads"], 1e-4, zero)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_three_sharded_steps_match_the_reference_and_one_rank(mesh_run, cases, name):
    _, res, case = _sharded(mesh_run, cases, name)
    zero = _zero_leaves(case["cfg"])
    # at top_k = 1 each side's router moves by its own rounding (a zero
    # gradient through Adam's normalised update), so the routing of step 2
    # on is each side's own: one step is held there
    steps, params, final = ((1, res["params1"], case["first"]) if zero
                            else (STEPS, res["params"], case["final"]))
    assert len(res["losses"]) == STEPS
    for got, jl, tl in zip(res["losses"][:steps], case["jax_losses"][:steps],
                           case["losses"][:steps], strict=True):
        assert abs(got - jl) <= 1e-4 * abs(jl)
        assert abs(got - tl) <= 1e-4 * abs(tl)
    # AdamW on each rank's blocks with the global norm's clip: the one-rank
    # params, relative to the steps' movement (Adam's normalised update
    # turns a gradient entry near 0 into +-lr whatever its rounding). A MoE
    # case holds the entries whose first gradient lies beyond the leaf's
    # rounding, the largest distance of its sharded first gradient from the
    # one-rank one: there both sides' first update, sign(g) lr, is the same,
    # and an entry within it moves +-lr whichever its rounding gives (the
    # zero leaves are all such entries)
    worst = (0.0, None)
    for k, v in params.items():
        held = torch.ones(v.shape, dtype=torch.bool)
        if name in MOE:
            g = case["grads"][k]
            held = (g.abs() > float((res["grads"][k] - g).abs().max())) & (k not in zero)
        if held.any():
            err = float(torch.linalg.vector_norm((v - final[k])[held]))
            moved = float(torch.linalg.vector_norm((final[k] - case["params"][k])[held]))
            worst = max(worst, (err / moved, k))
    assert worst[0] <= 1e-2, worst


@pytest.mark.parametrize("name", list(CONFIGS))
def test_state_bytes_identity_and_collective_bytes(mesh_run, cases, name):
    from repro_torch.launch.dryrun import state_bytes
    from repro_torch.launch.specs import train_specs
    from repro_torch.sharding import MeshCtx

    (dp, mp), res, case = _sharded(mesh_run, cases, name)
    _, args = train_specs(case["cfg"], ROWS, SEQ,
                          MeshCtx(mesh=MeshShape(("data", "model"), (dp, mp))))
    dry = state_bytes(args, "train")
    assert res["state_bytes"] == (dry["params"], dry["opt"])
    assert res["identity"]  # gather_state(distribute_state(s)) is s, bit for bit
    assert res["bytes"] == {**res["bytes"], **res["expected_bytes"]}
    assert sum(res["bytes"].values()) == sum(res["expected_bytes"].values()) > 0


@pytest.mark.parametrize("name", MOE)
def test_moe_routes_and_drops_alike_on_every_rank(mesh_run, cases, name):
    """Every rank routes its rows as the one-rank step does: the same
    choices dropped at capacity (counted from ``route_group``'s slots, once
    per MoE layer and pass), whatever the layout splits over ``model``."""
    (dp, mp), res, case = _sharded(mesh_run, cases, name)
    # per call, each row's dropped choices: rank 0 holds the first ROWS / dp rows
    assert res["drops"] == [per_row[:ROWS // dp] for per_row in case["drops"]]
    if name == DROPS:
        assert sum(map(sum, res["drops"])) > 0


def test_a_one_rank_checkpoint_restores_onto_the_mesh_and_back(mesh_run, cases):
    ck = mesh_run[1]["_ckpt"]
    assert ck["equal"] and ck["shapes"]
    want = cases["gemma"]["params"]
    assert all(torch.equal(ck["back"][k], want[k]) for k in want)


# -- in one process ------------------------------------------------------------------------


def test_block_pads_the_last_pieces_and_a_mesh_shape_of_more_ranks_raises():
    full = torch.arange(10 * 6, dtype=torch.float32).reshape(10, 6)
    m = MeshShape(("data", "model"), (4, 2))
    spec = PartitionSpec("data", "model")
    # ceil(10 / 4) = 3 rows a rank: the last holds row 9 and two rows of zeros
    got = block(full, spec, m, {"data": 3, "model": 1})
    assert got.shape == (3, 3)
    assert torch.equal(got[0], full[9, 3:]) and not got[1:].any()
    assert torch.equal(block(full, spec, m, {"data": 1, "model": 0}), full[3:6, :3])
    assert torch.equal(block(full.numpy(), spec, m, {"data": 1, "model": 0}), full[3:6, :3])
    x = torch.ones(2, 3)
    with activate_mesh(m):
        with pytest.raises(NotImplementedError, match="has no ranks to run one"):
            shard(x, "batch", None)
        with pytest.raises(NotImplementedError, match="has no ranks to run one"):
            collectives.active()
    with activate_mesh(MeshShape(("data", "model"), (1, 1))):
        assert collectives.active() is None and shard(x, "batch", None) is x
        assert collectives.model_part(6, "heads") == (0, 6)
        one = {"w": full}
        lone = MeshShape(("data",), (1,))
        back = gather_state(distribute_state(one, {"w": PartitionSpec("data")}, lone),
                            {"w": PartitionSpec("data")}, lone, one)
        assert torch.equal(back["w"], full)
    with pytest.raises(KeyError, match="no PartitionSpec"):
        distribute_state({"w": full}, {}, m)


@pytest.mark.parametrize("name", ["qwen3-uneven", "gemma", "mamba2", "jamba"])
def test_init_blocks_draws_one_leaf_at_a_time_to_the_blocks_of_the_whole_model(
        monkeypatch, name):
    """The launcher's init under a mesh: each rank's blocks, bit for bit
    those ``distribute_state`` cuts from the whole seeded model, with every
    whole leaf dropped before the next is drawn (peak: one leaf beside the
    blocks)."""
    import weakref

    from repro_torch.models import init_blocks, param_specs
    from repro_torch.sharding import MeshCtx, rules

    cfg = _cfgs(name)[1]
    shape = MeshShape(("data", "model"), (2, 2))
    specs = param_specs(cfg, MeshCtx(mesh=shape))
    whole = dict(LM(cfg, seed=5, device="cpu").named_parameters())
    cut, drawn = rules.block, []

    def spy(full, spec, mesh, coords=None):
        assert all(r() is None for r in drawn), "an earlier whole leaf is still held"
        drawn.append(weakref.ref(full))
        return cut(full, spec, mesh, coords)

    monkeypatch.setattr(rules, "block", spy)
    for coords in ({"data": 0, "model": 0}, {"data": 1, "model": 1}, {"data": 1, "model": 0}):
        drawn.clear()
        got = init_blocks(cfg, specs, shape, seed=5, device="cpu", coords=coords)
        assert list(got) == list(whole) and len(drawn) == len(whole)
        for k, p in whole.items():
            want = cut(p.detach(), specs[k], shape, coords)
            assert got[k].shape == want.shape and got[k].is_contiguous(), k
            assert got[k].view(-1).view(torch.uint8).equal(want.reshape(-1).view(torch.uint8)), k


def test_each_data_rank_takes_its_rows_of_the_one_rank_batch():
    full = SyntheticLM(512, 8, 16, seed=3, device="cpu").batch_at(5)
    parts = [SyntheticLM(512, 8, 16, seed=3, device="cpu", shard=(i, 4)).batch_at(5)
             for i in range(4)]
    for k in full:
        assert torch.equal(torch.cat([p[k] for p in parts]), full[k])
    with pytest.raises(ValueError, match="does not split"):
        SyntheticLM(512, 6, 16, device="cpu", shard=(0, 4)).batch_at(0)


def test_launcher_on_4_ranks_killed_and_relaunched_ends_in_the_same_bits(caplog):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh
    local``: chip_smoke.py's phase 17 (a) at a tiny size (gloo on the CPU),
    step 1's loss against the one-rank launcher's."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from repro_torch.launch import train as launch_train

    caplog.set_level("INFO", logger="repro_torch.train")
    args = ["--arch", "mamba2-370m", "--smoke", "--device", "cpu", "--batch", "4", "--seq",
            "32", "--log-every", "1"]
    launch_train.main(args + ["--steps", "1"])
    one = chip_smoke._launcher_log(caplog.text)["steps"][0]["loss"]
    cfg = configs.smoke(configs.get_config("mamba2-370m"))
    res = chip_smoke.shard_launcher("cpu", cfg, smoke=True, steps=4, batch=4, seq=32,
                                    ckpt_every=2, one_rank_loss=one)
    assert res["bit_identical"] and res["runs"]["relaunched"]["restored"] == 2
    assert res["runs"]["killed"]["latest_at_kill"] == 2
    assert res["losses_relaunched"] == res["losses"][2:] and len(res["losses"]) == 4
    assert res["loss_rel"] <= chip_smoke.SHARD_LOSS_RTOL
    assert res["rank_state_bytes"] == [res["dryrun_bytes_per_rank"]["params"]
                                       + res["dryrun_bytes_per_rank"]["opt"]] * 4
    assert res["launches"] == {"flash_attention": 0, "ssd": 0}  # plain on the CPU
    assert "shard" in chip_smoke.ALONE
