"""Decode, prefill and ``ServeEngine`` of the LM under a serving mesh
(``sharding.serve_ctx``) against the reference and the one-rank port on
the CPU.

Four gloo ranks (subprocesses, a ``file://`` rendezvous, a timeout each)
run every case of a mesh in one spawn; the parent asserts. Meshes and
layouts: (data 2, model 2) with four slots, the batch over ``data`` and the
cache's sequence over ``model`` ("seq_model", decode_32k's layout), and with
one sequence whose cache is split over all four ranks ("seq_shard_wide",
long_500k's); (1, 4) "seq_model". Configurations, fp32, the weights the
reference's ``init_params`` carried across by ``interop``: qwen3-32b's smoke
at 16 q and 2 kv heads (GQA, qk-norm), gemma-2b's (one kv head), mamba2-370m's
and Jamba's with ``moe_sharding="ep"`` (experts over ``model``, Mamba-2 and
attention). Each case: ``prefill`` of a 12-token prompt into a cache of 32
rows, then 8 decode steps fed the same tokens as the one-rank run. Gates:
the logits of every step within 1e-5 x max|logits| of the one-rank
``decode_step`` and within 1e-4 x max of the reference's
``repro.models.decode_step`` (the one-rank port too); every cache leaf,
gathered to rank 0, within 1e-5 of its max of the one-rank cache; each
rank's cache bytes the dry run's for its ``MeshShape``; each rank's
``CollectiveMeter`` bytes for one step ``chip_smoke.decode_step_bytes``;
``prefill_logits`` within 1e-5 of the one-rank one. ``ServeEngine`` on the
mesh with ``test_torch_lm``'s script (a request joining mid-flight) gives
the reference engine's tokens on every rank.
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
import repro.serving.engine as jengine
from repro.models import decode_step as jdecode_step
from repro.models import init_cache as jinit_cache
from repro.models import init_params
from repro_torch import configs
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import LM
from repro_torch.serving import ServeEngine, prefill, prefill_logits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> (arch, overrides of its smoke config)
CONFIGS = {"qwen3": ("qwen3-32b", {"n_heads": 16, "n_kv_heads": 2}),
           "gemma": ("gemma-2b", {}),
           "mamba2": ("mamba2-370m", {}),
           "jamba-ep": ("jamba-v0.1-52b", {"moe_sharding": "ep"})}
#: (mesh, layout, batch) of each spawn's runs
SPAWNS = {"2x2": [((2, 2), "seq_model", 4), ((2, 2), "seq_shard_wide", 1)],
          "1x4": [((1, 4), "seq_model", 4)]}
PROMPT, MAX_LEN, STEPS = 12, 32, 8
#: test_torch_lm's engine script: two requests, a third joining after two steps
ENGINE_PROMPTS = [[5, 17, 300, 42], [7, 8, 9], [101]]
ENGINE_CASE = "jamba-ep"


def _cfgs(name):
    arch, kw = CONFIGS[name]
    kw = dict(dtype="float32", **kw)
    return (dataclasses.replace(jconfigs.smoke(jconfigs.get_config(arch)), **kw),
            dataclasses.replace(configs.smoke(configs.get_config(arch)), **kw))


def _engine_ops(slots):
    """test_torch_lm's script on ``slots`` slots (one: its first request
    alone), as (slot, prompt) requests and None steps."""
    ops = [(0, ENGINE_PROMPTS[0])] + ([(1, ENGINE_PROMPTS[1])] if slots > 1 else [])
    for i in range(6):
        if i == 2 and slots > 2:  # a request joins mid-flight
            ops.append((2, ENGINE_PROMPTS[2]))
        ops.append(None)
    return ops


def _engine_script(eng, slots):
    for op in _engine_ops(slots):
        eng.step() if op is None else eng.add_request(*op)
    return [eng.finish(s) for s in range(min(slots, 3))]


def _run(lm, prompt, steps):
    """(the logits of ``prefill`` and of each decode step fed ``steps``, the
    cache, ``prefill_logits``) of the port on ``prompt`` (B, S)."""
    logits, cache = prefill(lm, prompt, MAX_LEN)
    out = [logits]
    for t in range(steps.shape[1]):
        out.append(lm.decode_step(cache, steps[:, t], PROMPT + t, length=PROMPT + t + 1).float())
    return out, cache, prefill_logits(lm, {"tokens": prompt}).float()


_RANK = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist

    rank, world, tmp, dp, mp = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                int(sys.argv[4]), int(sys.argv[5]))
    sys.path.insert(0, sys.argv[6])
    import chip_smoke
    # placed as chip_smoke.py places its ranks: on the CPU, gloo
    chip_smoke.rank_setup(rank, world, tmp, *chip_smoke.rank_route(rank, world, "cpu", 1))
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint.ckpt import _leaves
    from repro_torch.launch.roofline import CollectiveMeter
    from repro_torch.models import LM, cache_specs, param_specs
    from repro_torch.serving import ServeEngine, prefill, prefill_logits
    from repro_torch.sharding import (collectives, distribute_state, gather_state, serve_ctx,
                                      set_mesh_ctx)

    mesh = init_device_mesh("cpu", (dp, mp), mesh_dim_names=("data", "model"))
    inp = torch.load(f"{tmp}/inputs.pt", weights_only=False)

    def whole(logits):  # the rank's rows and vocabulary block -> every row and column
        rows = logits.shape[0]
        return collectives.gather_batch(collectives.model_blocks(logits)[0].reshape(rows, -1)[:, :vp])

    out = {}
    for layout, batch in inp["runs"]:
        ctx = serve_ctx(mesh, batch)
        set_mesh_ctx(ctx)
        plan = collectives.active()
        per = batch // plan.batch_ways
        mine = slice(plan.batch_index * per, (plan.batch_index + 1) * per)
        for name, case in inp["cases"].items():
            cfg = case["cfg"]
            lm = LM(cfg, device="meta").load_blocks(
                distribute_state(case["params"], param_specs(cfg, ctx), mesh))
            vp = lm.head().shape[1] * mp
            prompt, steps = case["prompt"][:batch], case["steps"][:batch]
            logits, cache = prefill(lm, prompt[mine], inp["max_len"])
            res = {"logits": [whole(logits)], "cache_bytes": sum(
                t.numel() * t.element_size() for _, t in _leaves(cache))}
            for t in range(steps.shape[1]):
                args = (cache, steps[mine, t], inp["prompt"] + t)
                kw = dict(length=inp["prompt"] + t + 1)
                if t == 0:
                    with CollectiveMeter() as meter:
                        got = lm.decode_step(*args, **kw)
                    res["bytes"] = dict(meter.bytes)
                else:
                    got = lm.decode_step(*args, **kw)
                res["logits"].append(whole(got.float()))
            set_mesh_ctx(None)  # the one-rank cache's shapes
            like = LM(cfg, device="meta").init_cache(batch, inp["max_len"])
            set_mesh_ctx(ctx)
            res["cache"] = gather_state(cache, cache_specs(cfg, ctx, seq_logical=ctx.kv_seq),
                                        mesh, like)
            res["prefill_logits"] = whole(prefill_logits(lm, {"tokens": prompt[mine]}).float())
            res["expected_bytes"] = chip_smoke.decode_step_bytes(cfg, dp, mp, batch,
                                                                 inp["max_len"], layout)
            if name == inp["engine_case"]:
                eng = ServeEngine(lm, max_len=inp["max_len"], batch_slots=batch, device="cpu")
                for op in inp["engine_ops"][batch]:
                    eng.step() if op is None else eng.add_request(*op)
                res["engine"] = [eng.finish(s) for s in range(min(batch, 3))]
            out[(layout, batch, name, rank)] = res
    set_mesh_ctx(None)
    torch.save(out, f"{tmp}/out{rank}.pt")
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
    """Per configuration: the carried weights, the tokens, the reference's
    logits at every step, the port's one-rank runs at 4 slots and at 1
    (the first slot's tokens), and for ENGINE_CASE the reference engine's
    tokens on 4 slots and on 1."""
    out = {}
    rng = np.random.default_rng(0)
    for name in CONFIGS:
        jcfg, tcfg = _cfgs(name)
        jparams = init_params(jcfg, jax.random.PRNGKey(0))
        params = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams))
        prompt = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (4, PROMPT)))
        steps = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (4, STEPS)))
        # the reference, unsharded: every prompt and step token through decode_step
        jstep = jax.jit(lambda c, t, p: jdecode_step(jparams, jcfg, c, t, p, length=p + 1))
        jcache = jinit_cache(jcfg, 4, MAX_LEN)
        ref = []
        toks = torch.cat([prompt, steps], dim=1).numpy()
        for t in range(PROMPT + STEPS):
            logits, jcache = jstep(jcache, jnp.asarray(toks[:, t], jnp.int32), jnp.int32(t))
            if t >= PROMPT - 1:
                ref.append(np.asarray(logits, np.float32))
        lm = LM(tcfg, device="cpu")
        lm.load_state_dict(params, strict=True)
        one = {b: _run(lm, prompt[:b], steps[:b]) for b in (4, 1)}
        out[name] = {"cfg": tcfg, "params": params, "prompt": prompt, "steps": steps,
                     "ref": ref, "one": one}
        if name == ENGINE_CASE:
            out[name]["engine"] = {
                b: _engine_script(jengine.ServeEngine(params=jparams, cfg=jcfg, max_len=MAX_LEN,
                                                      batch_slots=b), b) for b in (4, 1)}
            out[name]["engine_port"] = {
                b: _engine_script(ServeEngine(lm, max_len=MAX_LEN, batch_slots=b, device="cpu"), b)
                for b in (4, 1)}
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
    got = {}
    for r in range(4):
        got.update(torch.load(tmp / f"out{r}.pt", weights_only=False))
    return got


@pytest.fixture(scope="module", params=list(SPAWNS))
def spawn_run(request, cases, tmp_path_factory):
    runs = SPAWNS[request.param]
    (dp, mp), _, _ = runs[0]
    tmp = tmp_path_factory.mktemp(f"decode{request.param}")
    inputs = {"runs": [(layout, b) for _, layout, b in runs], "max_len": MAX_LEN,
              "prompt": PROMPT, "engine_case": ENGINE_CASE,
              "engine_ops": {b: _engine_ops(b) for _, _, b in runs},
              "cases": {k: {"cfg": c["cfg"], "params": c["params"], "prompt": c["prompt"],
                            "steps": c["steps"]} for k, c in cases.items()}}
    return runs, _spawn(tmp, dp, mp, inputs)


def _each(spawn_run, name):
    """(mesh, layout, batch, every rank's results) of each run of the spawn."""
    runs, out = spawn_run
    for mesh, layout, b in runs:
        yield mesh, layout, b, [out[(layout, b, name, r)] for r in range(4)]


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale, (float(np.abs(got - want).max()),
                                                           scale)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_one_rank_decode_matches_the_reference_at_every_step(cases, name):
    case = cases[name]
    logits = case["one"][4][0]
    assert len(logits) == len(case["ref"]) == STEPS + 1
    for got, want in zip(logits, case["ref"]):
        _close(got, want, 1e-4)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_decode_matches_one_rank_and_the_reference(spawn_run, cases, name):
    case = cases[name]
    for mesh, layout, b, ranks in _each(spawn_run, name):
        want, _, want_prefill = case["one"][b]
        for res in ranks:  # every rank gathers every row and column
            for got, one, ref in zip(res["logits"], want, case["ref"], strict=True):
                _close(got, one, 1e-5)
                _close(got, ref[:b], 1e-4)
            _close(res["prefill_logits"], want_prefill, 1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_cache_matches_one_rank_leaf_by_leaf(spawn_run, cases, name):
    case = cases[name]
    for mesh, layout, b, ranks in _each(spawn_run, name):
        want = case["one"][b][1]
        got = ranks[0]["cache"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, (layout, k)
                _close(g[k], w[k], 1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_cache_and_collective_bytes_match_the_dry_run_and_the_closed_form(
        spawn_run, cases, name):
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.specs import cache_sds
    from repro_torch.sharding import MeshCtx, MeshShape, serve_ctx

    cfg = cases[name]["cfg"]
    for (dp, mp), layout, b, ranks in _each(spawn_run, name):
        shape = MeshShape(("data", "model"), (dp, mp))
        assert serve_ctx(shape, b).kv_seq == layout
        dry = tree_bytes(cache_sds(cfg, b, MAX_LEN, MeshCtx(mesh=shape)))
        for res in ranks:
            assert res["cache_bytes"] == dry
            assert res["bytes"] == {**res["bytes"], **res["expected_bytes"]}
            assert sum(res["bytes"].values()) == sum(res["expected_bytes"].values())
        if layout == "seq_shard_wide" or mp > 1:
            assert sum(ranks[0]["bytes"].values()) > 0


def test_sharded_serve_engine_gives_the_reference_tokens_on_every_rank(spawn_run, cases):
    case = cases[ENGINE_CASE]
    assert case["engine_port"] == case["engine"]
    assert [len(o) for o in case["engine"][4]] == [7, 7, 5]
    for mesh, layout, b, ranks in _each(spawn_run, ENGINE_CASE):
        for res in ranks:
            assert res["engine"] == case["engine"][b], (mesh, layout)
