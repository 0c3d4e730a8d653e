"""The port's sharding rules and specs and its ``launch`` package against the
reference on the CPU.

Held equal to the reference: ``logical_to_spec`` on a ("data", "model") and a
("pod", "data", "model") mesh; ``param_specs`` (through ``interop``'s name
mapping, minus the stacked layer axis: the port's layers are not stacked),
``cache_specs`` and ``opt_state_specs`` for every architecture, shapes from
``jax.eval_shape`` alone; ``SHAPES`` and ``cell_supported``;
``cost_model.forward_flops`` and ``step_costs`` (the reference's padded
heads, which the port computes) for every architecture and shape.
``flop_count`` on the meta device lands within the reference's band
(tests/test_roofline.py: 0.5-1.5) of the analytic model, and counts K9
through its plain version. The launcher on the CPU:
a run with checkpoints, and its resume from one, end in the same bits; the
production meshes raise on a world of one. The dry run sizes a full-size
cell (qwen3-32b train_4k, 16x16) on the meta device: per-rank bytes the
specs' shard sum, collective bytes null, never 0. ``uniform_centers``
defaults to the card.
"""
import dataclasses
import json
import math
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.launch.cost_model as jcost
import repro.launch.specs as jspecs
from repro.configs import get_config as jget_config
from repro.models import cache_specs as jcache_specs
from repro.models import param_specs as jparam_specs
from repro.optim import opt_state_specs as jopt_state_specs
from repro.sharding.rules import MeshCtx as JMeshCtx
from repro.sharding.rules import logical_to_spec as jlogical_to_spec
from repro_torch import core
from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_config, list_archs, smoke
from repro_torch.interop import lm_param_names
from repro_torch.kernels import ssd_ops
from repro_torch.launch import cost_model, dryrun, mesh, specs
from repro_torch.launch import train as launch_train
from repro_torch.launch.roofline import HBM_BW, NVLINK_BW, PEAK_FLOPS, Roofline
from repro_torch.models import LM, cache_specs, padded_vocab, param_specs
from repro_torch.optim import opt_state_specs
from repro_torch.sharding import (MeshCtx, MeshShape, PartitionSpec, activate_mesh, get_mesh_ctx,
                                  local_shape, logical_to_spec, placements, shard)

MESHES = [MeshShape(("data", "model"), (16, 16)), MeshShape(("pod", "data", "model"), (2, 16, 16))]
ARCHS = list_archs()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jctx(m: MeshShape, **kw) -> JMeshCtx:
    # the reference's rules read only the mesh's axis names
    return JMeshCtx(mesh=types.SimpleNamespace(axis_names=m.axis_names), **kw)


def _flat(tree) -> list[tuple[tuple[str, ...], JP]]:
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return [(tuple(p.key for p in path), spec) for path, spec in leaves]


# -- sharding rules -------------------------------------------------------------------------


@pytest.mark.parametrize("m", MESHES, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("fsdp", [True, False])
def test_logical_to_spec_matches_the_reference(m, fsdp):
    names = [None, "batch", "fsdp", "model", "seq_shard", "seq_shard_wide", "none"]
    for a in names:
        for b in names:
            got = logical_to_spec(a, b, ctx=MeshCtx(mesh=m, fsdp=fsdp))
            want = jlogical_to_spec(a, b, ctx=_jctx(m, fsdp=fsdp))
            assert isinstance(got, PartitionSpec) and tuple(got) == tuple(want), (a, b)
    assert tuple(logical_to_spec("batch", ctx=MeshCtx())) == tuple(JP())


def test_local_shape_and_placements_follow_dtensor_split():
    m = MESHES[1]
    spec = PartitionSpec(("pod", "data"), "model", None)
    assert local_shape((100, 33, 7), spec, m) == (4, 3, 7)  # ceil(100/32), ceil(33/16)
    assert local_shape((5,), PartitionSpec(), m) == (5,)
    from torch.distributed.tensor import Replicate, Shard

    assert placements(spec, m) == [Shard(0), Shard(0), Shard(1)]
    assert placements(PartitionSpec(None, "data"), MESHES[0]) == [Shard(1), Replicate()]


def test_shard_is_a_no_op_on_one_rank_and_raises_on_more():
    x = torch.ones(4, 3)
    assert shard(x, "batch", None) is x  # no mesh
    with activate_mesh(MeshShape(("data", "model"), (1, 1))) as ctx:
        assert get_mesh_ctx() is ctx
        assert shard(x, "batch", None) is x
        with pytest.raises(ValueError, match="logical axes"):
            shard(x, "batch")
    assert get_mesh_ctx() is None
    with activate_mesh(MESHES[0]):
        with pytest.raises(NotImplementedError, match="has no ranks to run one"):
            shard(x, "batch", None)


# -- param, cache and optimizer specs ------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch):
    # every configuration, granite-moe, llama4-scout and qwen2-vl too (their
    # padded heads regroup, C.2c), maps by the same leaf rule
    cfg = get_config(arch)
    for m in MESHES:
        got = param_specs(cfg, MeshCtx(mesh=m))
        mapped = set()
        for path, spec in _flat(jparam_specs(jget_config(arch), _jctx(m))):
            want = tuple(spec)[1:] if path[0] == "blocks" else tuple(spec)
            for name in lm_param_names(cfg, path):
                assert tuple(got[name]) == want, (name, got[name], spec)
                mapped.add(name)
        assert mapped == set(got) == set(LM(cfg, device="meta").state_dict())


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_opt_state_specs_match_the_reference(arch):
    cfg = get_config(arch)
    for m in MESHES:
        for seq in ("none", "seq_shard", "seq_shard_wide"):
            got = cache_specs(cfg, MeshCtx(mesh=m), seq_logical=seq)
            assert len(got) == cfg.n_layers
            for path, spec in _flat(jcache_specs(jget_config(arch), _jctx(m), seq_logical=seq)):
                j = int(path[0].removeprefix("blk"))
                for g in range(cfg.n_groups):
                    assert tuple(got[g * cfg.layer_period + j][path[1]]) == tuple(spec)[1:]
    pspecs = param_specs(cfg, MeshCtx(mesh=MESHES[0]))
    ospecs = opt_state_specs(pspecs)
    jo = jopt_state_specs({"w": JP("data")})
    assert set(ospecs) == set(jo) and tuple(ospecs["step"]) == tuple(jo["step"]) == ()
    assert all(ospecs[k] is pspecs for k in ("master", "mu", "nu"))


# -- specs, cost model, flop counter ---------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_and_cost_model_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert specs.SHAPES == jspecs.SHAPES
    assert specs.FULL_ATTENTION_FAMILIES == jspecs.FULL_ATTENTION_FAMILIES
    assert padded_vocab(cfg) == padded_vocab(jcfg)
    for name, info in specs.SHAPES.items():
        assert specs.cell_supported(cfg, name) == jspecs.cell_supported(jcfg, name)
        decode = info["kind"] == "decode"
        seq = 1 if decode else info["seq"]
        s_kv = info["seq"] if decode else None
        for chips in (256, 512):
            got = cost_model.step_costs(cfg, info["kind"], info["batch"], seq, chips, s_kv=s_kv)
            assert got == jcost.step_costs(jcfg, info["kind"], info["batch"], seq, chips,
                                           s_kv=s_kv)
        fb = cost_model.forward_flops(cfg, info["batch"], seq, s_kv=s_kv, decode=decode)
        jfb = jcost.forward_flops(jcfg, info["batch"], seq, s_kv=s_kv, decode=decode)
        assert (fb.flops_fwd, fb.breakdown) == (jfb.flops_fwd, jfb.breakdown)
    # the padded heads the port computes are counted: the attention projections
    # of one layer scale with the padded q and kv heads, whatever the published ones
    one = dataclasses.replace(cfg, n_layers=1, n_experts=0, d_ff=0, family="dense",
                              attn_period=0, attention_impl="full")
    attn = cost_model.forward_flops(one, 2, 64).breakdown["attn"]
    hp, kvp = cfg.padded_heads(16), cfg.padded_kv_heads(16)
    proj = 2 * 128 * cfg.d_model * cfg.head_dim * (2 * hp + 2 * kvp)
    core = 2 * 2 * 128 * 64 * hp * cfg.head_dim  # B S tokens against S keys: no causal half
    assert attn == proj + core


def test_flop_count_on_the_meta_device_matches_the_analytic_model():
    """1-group smoke phi3, remat off, a forward without the logits
    (tests/test_roofline.py's band)."""
    cfg = dataclasses.replace(smoke(get_config("phi3-mini-3.8b")), n_layers=1, remat=False,
                              attn_chunk=64)
    b, s = 2, 64
    lm = LM(cfg, device="meta")
    counted = cost_model.flop_count(lm, {"tokens": torch.zeros((b, s), dtype=torch.int64,
                                                               device="meta")})["flops"]
    ana = cost_model.forward_flops(cfg, b, s).flops_fwd - 2 * b * s * cfg.d_model * padded_vocab(cfg)
    assert 0.5 < ana / counted < 1.5, (ana, counted)


def test_flop_count_sees_k9_through_its_plain_version():
    shapes = [(2, 96, 3, 16), (2, 96, 3), (3,), (2, 96, 8), (2, 96, 8)]
    meta = [torch.empty(sh, device="meta") for sh in shapes]
    cpu = [torch.randn(sh) for sh in shapes]
    on_meta = cost_model.flop_count(lambda *a: ssd_ops.ssd(*a, chunk=32), *meta)
    on_cpu = cost_model.flop_count(lambda *a: ssd_ops.ssd(*a, chunk=32), *cpu)
    assert on_meta == on_cpu and on_meta["flops"] > 0


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "qwen2-vl-2b", "hubert-xlarge"])
def test_every_cell_step_runs_on_the_meta_device_on_one_rank(arch, monkeypatch):
    cfg = smoke(get_config(arch))
    monkeypatch.setattr(specs, "SHAPES", {k: dict(v, seq=64, batch=2)
                                          for k, v in specs.SHAPES.items()})
    ctx = MeshCtx(mesh=MeshShape(("data", "model"), (1, 1)))
    for name, info in specs.SHAPES.items():
        if not specs.cell_supported(cfg, name)[0]:
            continue
        fn, args = specs.input_specs(cfg, name, ctx, loss_chunks=4)
        out = fn(*args)
        if info["kind"] == "train":
            state, metrics = out
            assert metrics["loss"].device.type == "meta" and state.opt["step"] == 1
        else:
            assert out.shape == (2, padded_vocab(cfg))


# -- roofline, dry run, meshes ---------------------------------------------------------------


def test_roofline_on_the_h100_and_unmeasured_collectives():
    kw = dict(arch="a", shape="s", mesh="16x16", chips=256, flops_per_device=989e12,
              bytes_per_device=6.7e12, peak_memory_per_device=2**30, model_flops=0.5 * 989e12 * 256)
    r = Roofline(coll_bytes_per_device=900e9, coll_breakdown={"all-reduce": 900e9}, **kw)
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 2.0, 2.0)
    assert r.bottleneck == "memory" and r.roofline_fraction == 0.25
    assert (PEAK_FLOPS, HBM_BW, NVLINK_BW) == (989e12, 3.35e12, 450e9)
    none = Roofline(coll_bytes_per_device=None, coll_breakdown=None, **kw).row()
    assert none["t_collective_s"] is None and none["coll_gb"] is None
    assert none["bottleneck"] == "memory"


def test_dry_run_of_a_full_size_cell_on_the_meta_device():
    row = dryrun.run_cell("qwen3-32b", "train_4k", multi_pod=False)
    assert row["status"] == "ok" and row["mesh"] == "16x16"
    cfg = get_config("qwen3-32b")
    m = MESHES[0]
    shapes = LM(cfg, device="meta").state_dict()

    def shard_bytes(ctx, itemsize=None):
        return sum(math.prod(local_shape(t.shape, spec, m)) * (itemsize or t.element_size())
                   for (k, t), spec in zip(shapes.items(), param_specs(cfg, ctx).values()))

    params = shard_bytes(MeshCtx(mesh=m))
    opt = 3 * shard_bytes(MeshCtx(mesh=m), 4) + 8  # master, mu, nu; the int64 step
    batch = 2 * (256 // 16) * 4096 * 8  # tokens and labels, batch over data
    assert row["bytes_per_rank"] == {"params": params, "opt": opt, "cache": 0, "batch": batch,
                                     "total": params + opt + batch}
    assert row["t_collective_s"] is None and row["coll_gb"] is None
    assert row["coll_bytes"] == dryrun.COLL_NOTE
    jc = jcost.step_costs(jget_config("qwen3-32b"), "train", 256, 4096, 256)
    assert row["hlo_flops_per_dev"] == jc["flops_per_device"]
    assert 0.5 < row["flops_check"]["ratio"] < 1.5


def test_dry_run_cli_caches_its_rows(tmp_path, capsys):
    argv = ["--arch", "mamba2-370m", "--shape", "long_500k", "--mesh", "multi",
            "--out", str(tmp_path)]
    dryrun.main(argv)
    row = json.loads((tmp_path / "mamba2-370m__long_500k__2x16x16.json").read_text())
    assert row["status"] == "ok" and row["bytes_per_rank"]["cache"] > 0
    dryrun.main(argv)
    assert "cached: mamba2-370m__long_500k__2x16x16" in capsys.readouterr().out
    skipped = dryrun.run_cell("qwen3-32b", "long_500k", multi_pod=True)
    assert skipped["status"] == "skipped"


def test_production_meshes_need_their_ranks():
    assert mesh.production_mesh_shape().sizes == (16, 16)
    assert mesh.production_mesh_shape(multi_pod=True).axis_names == ("pod", "data", "model")
    assert mesh.pipeline_mesh_shape().size == 512
    for build in (mesh.make_production_mesh, mesh.make_pipeline_mesh):
        with pytest.raises(ValueError, match="the process group has 1"):
            build()
    assert mesh.make_local_mesh(("data", "model")) == MeshShape(("data", "model"), (1, 1))


# -- the launcher ------------------------------------------------------------------------------


def _leaves(step_dir):
    man = json.loads((step_dir / "manifest.json").read_text())["leaves"]
    return {k: np.load(step_dir / v["file"]) for k, v in man.items()}


def test_launcher_resumes_from_a_checkpoint_to_the_same_bits(tmp_path, caplog):
    caplog.set_level("INFO", logger="repro_torch.train")
    args = ["--arch", "mamba2-370m", "--smoke", "--device", "cpu", "--steps", "4",
            "--batch", "2", "--seq", "32", "--ckpt-every", "2", "--log-every", "1"]
    d1, d2 = tmp_path / "d1", tmp_path / "d2"
    launch_train.main(args + ["--ckpt-dir", str(d1)])
    assert latest_step(str(d1)) == 4
    launch_train.main(args + ["--ckpt-dir", str(d2)])
    # a run killed after its step-2 checkpoint: drop what came after it
    import shutil

    shutil.rmtree(d2 / "step_00000004")
    caplog.clear()
    launch_train.main(args + ["--ckpt-dir", str(d2)])
    assert "restored checkpoint at step 2" in caplog.text
    assert [r.getMessage().split()[1] for r in caplog.records
            if r.getMessage().startswith("step ")] == ["3", "4"]
    a, b = _leaves(d1 / "step_00000004"), _leaves(d2 / "step_00000004")
    assert a.keys() == b.keys() and len(a) > 10
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    assert "done:" in caplog.text and "checkpoints:" in caplog.text


def test_launcher_refuses_production_meshes_and_a_missing_card(monkeypatch):
    with pytest.raises(ValueError, match="256 ranks"):
        launch_train.main(["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
                           "--mesh", "single"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "mamba2-370m", "--smoke", "--steps", "1"])
    assert get_mesh_ctx() is None


# -- the repair of uniform_centers -------------------------------------------------------------


def test_uniform_centers_defaults_to_the_card(monkeypatch):
    cs = core.uniform_centers(3, 1000, 40, device="cpu")
    want = torch.randint(0, 1000, (40,), generator=torch.Generator().manual_seed(3))
    assert torch.equal(cs.idx[:40], want) and int(cs.count) == 40
    assert cs.idx.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        core.uniform_centers(3, 1000, 40)
