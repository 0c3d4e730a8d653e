"""The reference's padded attention heads in the port, and BLESS cache
compression under a serving mesh, against the reference on the CPU.

The reference builds every attention layer with ``padded_heads(16)`` q
heads (under MHA the kv heads with them), masks the padded heads before
``wo`` and sends q head h to kv head ``h // (padded q heads // kv heads)``;
for granite-moe-3b-a800m (24 / 8 heads), llama4-scout-17b-a16e (40 / 8) and
qwen2-vl-2b (12 / 2) that regroups the real heads. The port builds the same
layout (ROADMAP C.2c), so these configurations carry across too.

Held here, fp32: smoke configurations that keep each of the three's head
counts (``d_model`` 128, ``head_dim`` 16 or 32; the reference's ``smoke()``
sets 4 heads, which hides the regrouping), the reference's ``init_params``
carried across by ``interop``, against ``jax.jit(forward)``,
``prefill_logits`` and ``decode_step`` at 2e-4 x max, and one loss and
gradient (granite-moe's) against ``jax.grad`` at ``test_torch_train.py``'s
tolerances (1e-5 relative, 1e-4 x the largest gradient), the padded heads'
``wo`` rows and ``wq`` columns taking exactly 0 on both sides. For every
configuration: each q head of the port's attention reads the kv head of the
reference's brute-force map and each padded head gives exactly 0 (forward
and decode), and ``head_share`` splits the padded heads evenly over every
``model`` axis that divides 16. On gloo ranks (subprocesses, a ``file://``
rendezvous, a timeout each): 12 / 2 heads on (data 1, model 4), where rank
3 holds only padded heads, and 36 / 36 (minicpm-2b's, padded to 48 / 48)
on (1, 8): the forward and decode within 1e-5 x max of the one-rank port;
``bless_compress_cache`` of rank-split caches, the sequence over ``model``
(seq_model on (1, 4) and (2, 2), the batch over ``data`` on the latter)
and over ``data`` x ``model`` (seq_shard_wide on (2, 2)), bit for bit the
unsharded call's.
Last, ``chip_smoke.py``'s phase 20 at a tiny size.
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
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params, logits_fn
from repro.models import loss_fn as jloss_fn
from repro_torch import configs
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import LM
from repro_torch.models.attention import bless_compress_cache
from repro_torch.models.config import TP
from repro_torch.models.model import Attention, head_share
from repro_torch.serving import prefill_logits
from repro_torch.training import loss_and_grads, train_state_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the script at the repo root)

#: name -> (arch, overrides of its smoke config): the full configuration's head counts
CONFIGS = {"granite": ("granite-moe-3b-a800m", dict(n_heads=24, n_kv_heads=8, head_dim=16)),
           "llama4": ("llama4-scout-17b-a16e", dict(n_heads=40, n_kv_heads=8, head_dim=16)),
           "qwen2-vl": ("qwen2-vl-2b", dict(n_heads=12, n_kv_heads=2, head_dim=32))}
#: the sharded cases: name -> (arch, overrides of its smoke config)
SHARDED = {"qwen2-vl": CONFIGS["qwen2-vl"],
           "minicpm": ("minicpm-2b", dict(n_heads=36, n_kv_heads=36, head_dim=16))}
#: (mesh, the cases it runs forward and decode on, the compression layouts (layout, batch))
SPAWNS = {"1x4": ((1, 4), ["qwen2-vl"], [("seq_model", 2)]),
          "1x8": ((1, 8), ["minicpm"], []),
          "2x2": ((2, 2), ["qwen2-vl"], [("seq_model", 2), ("seq_shard_wide", 1)])}
B, S, STEPS, MAX_LEN = 2, 24, 4, 32
#: the compressed cache: (B, CACHE_ROWS, kv heads, head dim) to COMPRESS_M rows
CACHE_ROWS, COMPRESS_M = 32, 8


def _cfgs(arch, **kw):
    kw = dict(dtype="float32", **kw)
    return (dataclasses.replace(jconfigs.smoke(jconfigs.get_config(arch)), **kw),
            dataclasses.replace(configs.smoke(configs.get_config(arch)), **kw))


def _carried(arch, **kw):
    """(reference cfg, params, port cfg, port LM on the CPU with the same weights)."""
    jcfg, tcfg = _cfgs(arch, **kw)
    params = init_params(jcfg, jax.random.PRNGKey(0))
    lm = LM(tcfg, device="cpu")
    lm.load_state_dict(lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params)), strict=True)
    return jcfg, params, tcfg, lm


def _batch(cfg, b, s, seed=1):
    """tokens, and the vision model's M-RoPE positions and patch embeddings."""
    r = np.random.default_rng(seed)
    bat = {"tokens": r.integers(0, cfg.vocab_size, (b, s))}
    if cfg.pos == "mrope":
        p = np.broadcast_to(np.arange(s), (b, s))
        bat["mrope_positions"] = np.stack([p, p, p], axis=1)
    if cfg.extra_image_tokens:
        bat["pixel_embeds"] = r.standard_normal(
            (b, cfg.extra_image_tokens, cfg.d_model)).astype(np.float32)
    return bat


def _tb(bat):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in bat.items()}


def _close(out, ref, tol):
    out = np.asarray(torch.as_tensor(out).float()) if isinstance(out, torch.Tensor) else out
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert out.shape == ref.shape, (out.shape, ref.shape)
    assert np.all(np.isfinite(out))
    err, scale = float(np.abs(out - ref).max()), float(np.abs(ref).max())
    assert err <= tol * max(scale, 1e-30), (err, tol * scale)


def _mrope(cfg, b, t):
    """The decode step's M-RoPE positions (B, 3, 1) at position t (None without)."""
    return np.full((b, 3, 1), t) if cfg.pos == "mrope" else None


# -- the three regrouping configurations against the reference ---------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_padded_forward_and_prefill_logits_match_the_reference(name):
    jcfg, params, tcfg, lm = _carried(CONFIGS[name][0], **CONFIGS[name][1])
    assert tcfg.padded_heads(TP) != tcfg.n_heads  # padded, and regrouped:
    assert (np.arange(tcfg.n_heads) // (tcfg.padded_heads(TP) // tcfg.n_kv_heads)
            != np.arange(tcfg.n_heads) // (tcfg.n_heads // tcfg.n_kv_heads)).any()
    bat = _batch(jcfg, 2, 32)
    want = jax.jit(jforward, static_argnums=1)(params, jcfg,
                                               {k: jnp.asarray(v) for k, v in bat.items()})
    _close(lm(_tb(bat)), want, 2e-4)
    _close(prefill_logits(lm, _tb(bat)), logits_fn(params, jcfg, want[:, -1]), 2e-4)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_padded_decode_matches_the_reference_at_every_step(name):
    jcfg, params, tcfg, lm = _carried(CONFIGS[name][0], **CONFIGS[name][1])
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 10))
    jstep = jax.jit(lambda c, t, p, mp: jdecode_step(params, jcfg, c, t, p, length=p + 1,
                                                     mrope_pos=mp))
    jcache = jinit_cache(jcfg, 2, 16)
    cache = lm.init_cache(2, 16)
    for t in range(toks.shape[1]):
        mp = _mrope(tcfg, 2, t)
        want, jcache = jstep(jcache, jnp.asarray(toks[:, t], jnp.int32), jnp.int32(t),
                             None if mp is None else jnp.asarray(mp, jnp.int32))
        got = lm.decode_step(cache, torch.from_numpy(toks[:, t]), t, length=t + 1,
                             mrope_pos=None if mp is None else torch.from_numpy(mp))
        _close(got, want, 2e-4)
    # the padded layout's kv heads, the reference's stacked over groups
    assert cache[0]["k"].shape == tuple(jcache["blk0"]["k"].shape[1:])


def test_padded_train_step_gradients_match_jax_grad_and_padded_heads_take_none():
    arch, kw = CONFIGS["granite"]
    jcfg, params, tcfg, lm = _carried(arch, **kw)
    batch = _batch(tcfg, 2, 32)
    batch["labels"] = np.roll(batch["tokens"], -1, 1)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jloss_fn(
        p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, n_chunks=4)))(params)
    want = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jg))
    loss, got = loss_and_grads(lm, train_state_init(lm).params, _tb(batch), loss_chunks=4)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert set(got) == set(want)
    gmax = max(float(g.abs().max()) for g in want.values())
    for k, g in got.items():
        assert g.shape == want[k].shape, k
        assert float((g - want[k]).abs().max()) <= 1e-4 * gmax, k
    real = tcfg.n_heads * tcfg.head_dim
    wo = [k for k in got if k.endswith("attn.wo")]
    assert wo
    for k in wo:  # the masked heads: exactly 0 on both sides
        assert float(got[k][real:].abs().max()) == 0.0 == float(want[k][real:].abs().max())
        wq = k.removesuffix("wo") + "wq"
        assert float(got[wq][:, real:].abs().max()) == 0.0 == float(want[wq][:, real:].abs().max())
        assert float(got[k][:real].abs().max()) > 0.0


# -- every configuration's head map --------------------------------------------------------------


def _probe(name):
    """An attention layer of ``name``'s heads (``d_model`` 64, ``head_dim`` 4)
    whose output column h holds what padded q head h read: q = 0 (uniform
    weights over the keys), v of kv head j equal to j everywhere, ``wo``
    mapping head h's first channel to column h."""
    cfg = dataclasses.replace(configs.get_config(name), d_model=64, head_dim=4, dtype="float32",
                              qk_norm=False, pos="rope", attention_impl="full", attn_chunk=64)
    hp, kvp, hd = cfg.padded_heads(TP), cfg.padded_kv_heads(TP), cfg.head_dim
    attn = Attention(cfg, generator=torch.Generator().manual_seed(0), dtype=torch.float32,
                     device="cpu")
    with torch.no_grad():
        attn.wq.zero_()
        attn.wv.copy_((torch.arange(kvp, dtype=torch.float32) / 64).repeat_interleave(hd)
                      .expand(64, kvp * hd))
        attn.wo.zero_()
        attn.wo[torch.arange(hp) * hd, torch.arange(hp)] = 1.0
    return cfg, attn


@pytest.mark.parametrize("name", configs.list_archs())
def test_each_q_head_reads_its_reference_kv_head_and_padded_heads_give_zero(name):
    jcfg = jconfigs.get_config(name)
    hp = jcfg.padded_heads(16)
    hkv = hp if jcfg.n_kv_heads == jcfg.n_heads else jcfg.n_kv_heads
    ref_map = np.repeat(np.arange(hkv), hp // hkv)  # the reference's _repeat_kv
    want = np.where(np.arange(hp) < jcfg.n_heads, ref_map, 0).astype(np.float32)
    cfg, attn = _probe(name)
    s = 6
    x = torch.ones((1, s, 64))
    with torch.no_grad():
        out = attn(x, torch.arange(s)[None], None)
        np.testing.assert_allclose(out[0, :, :hp].numpy(), np.broadcast_to(want, (s, hp)),
                                   rtol=1e-6, atol=1e-6)
        assert not out[..., hp:].any()
        cache = {n: torch.zeros((1, 8, cfg.padded_kv_heads(TP), cfg.head_dim)) for n in "kv"}
        for t in range(3):
            got = attn.decode(x[:, :1], cache, torch.tensor([t]), torch.tensor([t + 1]), None)
            np.testing.assert_allclose(got[0, 0, :hp].numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", configs.list_archs())
def test_padded_heads_split_evenly_over_every_model_axis_that_divides_16(name):
    cfg = configs.get_config(name)
    hp, kvp = cfg.padded_heads(TP), cfg.padded_kv_heads(TP)
    ref_map = np.arange(hp) // (hp // kvp)
    for ways in (1, 2, 4, 8, 16):
        seen = []
        for rank in range(ways):
            q_lo, q_hi, kv_lo, kv_hi = head_share(cfg, ways, rank)
            hq, kv = q_hi - q_lo, kv_hi - kv_lo
            np.testing.assert_array_equal(kv_lo + np.arange(hq) // (hq // kv),
                                          ref_map[q_lo:q_hi])
            seen += range(q_lo, q_hi)
        assert seen == list(range(hp))
    with pytest.raises(NotImplementedError, match="split evenly"):
        head_share(cfg, 5, 0)
    # a share straddling kv heads unevenly raises (12 heads over 8 + 4 here);
    # no configuration of the repo has one on an axis that divides 16
    with pytest.raises(NotImplementedError, match="split evenly"):
        head_share(dataclasses.replace(cfg, n_heads=48, n_kv_heads=6), 4, 0)


# -- on gloo ranks ---------------------------------------------------------------------------------


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
    from repro_torch.models import LM, param_specs
    from repro_torch.models.attention import bless_compress_cache
    from repro_torch.sharding import (MeshCtx, collectives, distribute_state, serve_ctx,
                                      set_mesh_ctx)

    mesh = init_device_mesh("cpu", (dp, mp), mesh_dim_names=("data", "model"))
    inp = torch.load(f"{tmp}/inputs.pt", weights_only=False)
    out = {}

    def whole(logits):  # the rank's rows and vocabulary block -> every row and column
        rows = logits.shape[0]
        vp = logits.shape[1] * mp
        blocks = collectives.model_blocks(logits)[0].reshape(rows, -1)[:, :vp]
        return collectives.gather_batch(blocks)

    for name, case in inp["cases"].items():
        cfg = case["cfg"]
        res = {}
        if dp == 1:  # the forward under the training layout: every row on every rank
            ctx = MeshCtx(mesh=mesh)
            set_mesh_ctx(ctx)
            lm = LM(cfg, device="meta").load_blocks(
                distribute_state(case["params"], param_specs(cfg, ctx), mesh))
            with torch.no_grad():
                res["hidden"] = lm(case["batch"])
        ctx = serve_ctx(mesh, case["tokens"].shape[0])
        set_mesh_ctx(ctx)
        plan = collectives.active()
        per = case["tokens"].shape[0] // plan.batch_ways
        mine = slice(plan.batch_index * per, (plan.batch_index + 1) * per)
        lm = LM(cfg, device="meta").load_blocks(
            distribute_state(case["params"], param_specs(cfg, ctx), mesh))
        cache = lm.init_cache(case["tokens"].shape[0], inp["max_len"])
        res["logits"] = []
        for t in range(case["tokens"].shape[1]):
            mrope = case["mrope"][t]
            res["logits"].append(whole(lm.decode_step(
                cache, case["tokens"][mine, t], t, length=t + 1,
                mrope_pos=None if mrope is None else mrope[mine]).float()))
        out[name] = res
    for layout, batch in inp["compress_runs"]:
        ctx = serve_ctx(mesh, batch)
        assert ctx.kv_seq == layout
        set_mesh_ctx(ctx)
        plan = collectives.active()
        per = batch // plan.batch_ways
        mine = slice(plan.batch_index * per, (plan.batch_index + 1) * per)
        k, v = inp["cache"][0][:batch], inp["cache"][1][:batch]
        n = k.shape[1] // plan.kv_ways
        at = slice(plan.kv_index * n, (plan.kv_index + 1) * n)
        kc, vc = bless_compress_cache(k[mine, at].contiguous(), v[mine, at].contiguous(),
                                      inp["m"], m_pilot=inp["m_pilot"])
        m = inp["m"] // plan.kv_ways
        blk = slice(plan.kv_index * m, (plan.kv_index + 1) * m)
        want_k, want_v = inp["packed"][batch]
        refused = False
        try:
            bless_compress_cache(k[mine, at], v[mine, at], inp["m"] + 1)
        except ValueError as e:
            refused = "ranks" in str(e)
        out[layout, batch] = {"equal": torch.equal(kc, want_k[mine, blk])
                                       and torch.equal(vc, want_v[mine, blk]),
                              "shape": tuple(kc.shape), "refused": refused}
    set_mesh_ctx(None)
    torch.save(out, f"{tmp}/out{rank}.pt")
    dist.destroy_process_group()
    print("RANK_OK")
""")


def _one_rank(name):
    """The sharded case ``name``: its port cfg and params (the reference's,
    carried across), inputs, and the one-rank port's hidden states and
    decode logits."""
    arch, kw = SHARDED[name]
    _, _, tcfg, lm = _carried(arch, **kw)
    bat = _tb(_batch(tcfg, B, S))
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, tcfg.vocab_size, (B, STEPS)))
    mrope = [None if _mrope(tcfg, B, t) is None else torch.from_numpy(_mrope(tcfg, B, t))
             for t in range(STEPS)]
    with torch.no_grad():
        hidden = lm(bat)
    cache = lm.init_cache(B, MAX_LEN)
    logits = [lm.decode_step(cache, toks[:, t], t, length=t + 1, mrope_pos=mrope[t]).float()
              for t in range(STEPS)]
    return {"cfg": tcfg, "params": lm.state_dict(), "batch": bat, "tokens": toks,
            "mrope": mrope, "hidden": hidden, "logits": logits}


@pytest.fixture(scope="module")
def one_rank():
    return {name: _one_rank(name) for name in SHARDED}


@pytest.fixture(scope="module")
def caches():
    """A random cache (B, CACHE_ROWS, 2, 32) and its unsharded compression
    at 2 rows and at 1."""
    g = torch.Generator().manual_seed(7)
    k, v = (torch.randn((B, CACHE_ROWS, 2, 32), generator=g) for _ in range(2))
    packed = {b: bless_compress_cache(k[:b], v[:b], COMPRESS_M, m_pilot=16) for b in (1, 2)}
    return (k, v), packed


def _spawn(tmp, dp, mp, inputs):
    torch.save(inputs, tmp / "inputs.pt")
    script = tmp / "rank.py"
    script.write_text(_RANK)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    world = dp * mp
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), str(tmp),
                               str(dp), str(mp), REPO], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "RANK_OK" in out, f"rank {r}:\n{out[-3000:]}"
    return [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module", params=list(SPAWNS))
def spawn_run(request, one_rank, caches, tmp_path_factory):
    mesh, names, runs = SPAWNS[request.param]
    (k, v), packed = caches
    cases = {n: {key: one_rank[n][key] for key in ("cfg", "params", "batch", "tokens", "mrope")}
             for n in names}
    inputs = {"cases": cases, "max_len": MAX_LEN, "compress_runs": runs, "cache": (k, v),
              "packed": packed, "m": COMPRESS_M, "m_pilot": 16}
    return mesh, names, runs, _spawn(tmp_path_factory.mktemp(f"padded{request.param}"), *mesh,
                                     inputs)


def test_sharded_padded_heads_match_the_one_rank_port(spawn_run, one_rank):
    (dp, mp), names, _, ranks = spawn_run
    for name in names:
        want = one_rank[name]
        for res in (rk[name] for rk in ranks):
            if dp == 1:
                _close(res["hidden"], want["hidden"].numpy(), 1e-5)
            assert len(res["logits"]) == STEPS
            for got, one in zip(res["logits"], want["logits"]):
                _close(got, one.numpy(), 1e-5)


def test_sharded_bless_compress_cache_is_the_unsharded_call_bit_for_bit(spawn_run):
    (dp, mp), _, runs, ranks = spawn_run
    for layout, batch in runs:
        for rk in ranks:
            res = rk[layout, batch]
            assert res["equal"], (layout, batch)
            assert res["refused"]  # m that does not divide over the sequence's ranks
            assert res["shape"][1] == COMPRESS_M // (mp if layout == "seq_model" else dp * mp)


# -- chip_smoke.py's phase 20 at a tiny size -------------------------------------------------------


def test_chip_smoke_padded_heads_phase_rehearses_on_the_cpu():
    tiny = dict(n_layers=2, d_model=128, head_dim=16, d_ff=64, vocab_size=512)
    res = chip_smoke.padded_heads(
        "cpu", timeout=240.0,
        overrides={"a": dict(tiny, n_experts=8, top_k=2),
                   "b": dict(tiny, head_dim=32, d_ff=128, extra_image_tokens=8)},
        a=dict(batch=2, prompt=16, serve_prompt=4, steps=3),
        b=dict(batch=2, prompt=24, max_len=64, steps=3, m=16))
    a, b = res["a"], res["b"]
    assert (a["heads"], a["group"]) == ([24, 8, 32], 4)
    assert a["prefill_err"] <= chip_smoke.PADDED_TOL and a["outputs_same"]
    assert a["calls"] == 2 * 4 + 3 and a["step_err_worst"] <= chip_smoke.PADDED_TOL
    assert (b["heads"], b["group"], b["backend"]) == ([12, 2, 16], 8, "gloo")
    assert all(b["compress_equal"]) and b["step_err_worst"] <= chip_smoke.PADDED_TOL
    assert b["bytes"][0] == {**b["bytes"][0], **b["expected_bytes"]}
    assert res["launches"] == {"flash_attention": 0, "ssd": 0}  # plain versions on the CPU
    full = chip_smoke.padded_config("b")
    assert (full.n_layers, full.d_model, full.padded_heads(TP), full.dtype) == (4, 1536, 16,
                                                                               "float32")
