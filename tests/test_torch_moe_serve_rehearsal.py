"""``chip_smoke.py``'s phases 18 (MoE across the ``model`` axis) and 19
(decode and ``ServeEngine`` under a serving mesh) rehearsed on the CPU at a
tiny size: four gloo ranks in their own processes, every gate of the
phase run (the kernels' launch gates are the card's alone)."""
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

#: the full models' shapes cut to a few columns (every layout kept: Jamba's
#: 16 experts over ``model``, granite-moe's 40 experts' ff split over it)
TINY = dict(d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=512,
            ssm_state=16, ssm_headdim=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_chip_smoke_phase_18_rehearses_on_the_cpu():
    res = chip_smoke.moe_shard("cpu", seq=32, overrides=TINY, timeout=170)
    for arch, (_, mode) in chip_smoke.MOE_SHARD.items():
        r = res[arch]
        assert r["moe_mode"] == mode and r["mesh"] == list(chip_smoke.TP_MESH)
        assert r["loss_rel"] <= chip_smoke.TP_LOSS_RTOL and not r["over"]
        assert all(b == r["expected_bytes"] for b in
                   ({k: rb[k] for k in r["expected_bytes"]} for rb in r["bytes"]))
        assert all(0.0 <= d < 1.0 for d in r["dropped_share"])
    assert res["launches"] == {"flash_attention": 0, "ssd": 0}  # plain on the CPU


def test_chip_smoke_phase_19_rehearses_on_the_cpu():
    gemma = dict(TINY, n_kv_heads=1, n_layers=2)
    res = chip_smoke.serve_shard(
        "cpu", overrides={"a": TINY, "b": gemma},
        a=dict(prompt=8, max_len=32, steps=6, join_at=2), b=dict(prompt=8, max_len=64, steps=4))
    a, b = res["a"], res["b"]
    assert a["layout"] == "seq_model" and b["layout"] == "seq_shard_wide"
    assert a["n_layers"] == chip_smoke.SERVE_JAMBA_LAYERS
    assert a["calls"] == 3 * 8 + 6 and b["calls"] == 8 + 4
    for part in (a, b):
        assert part["dtype"] == "float32" and part["tol"] == chip_smoke.SERVE_FP32_TOL
        assert max(part["prefill_err"]) <= part["tol"] and part["step_err_worst"] <= part["tol"]
        assert part["fed_alike"] == [True] * 4 and part["outputs_same"] == [True] * 4
        assert part["rank_cache_bytes"] == [part["dryrun_cache_bytes"]] * 4
        assert all({k: rb[k] for k in part["expected_bytes"]} == part["expected_bytes"]
                   for rb in part["bytes"])
    assert list(map(len, a["outputs"])) == [7, 7, 5, 0] and len(b["outputs"]) == 4
    assert res["launches"] == {"flash_attention": 0, "ssd": 0}
    assert {"moe_shard", "serve_shard"} <= set(chip_smoke.ALONE)


def test_moe_drops_counts_every_call_and_restores_the_router():
    """``chip_smoke.moe_drops``: per MoE call, each row's dropped choices
    (the slots at E * C) and the call's choices; ``route_group`` is the
    module's own again after the block, also when the block raised."""
    import repro_torch.models.moe as moe

    route = moe.route_group
    g = torch.Generator().manual_seed(0)
    x, router = torch.randn(3, 8, 16, generator=g), torch.randn(16, 4, generator=g)
    with chip_smoke.moe_drops() as calls:
        got = moe.route_group(x, router, 2, 2, 4)  # 16 choices a row into 4 x 2 slots
        moe.route_group(x[:1], router, 1, 8, 4)
    assert moe.route_group is route
    slot, gate = route(x, router, 2, 2, 4)
    assert torch.equal(got[0], slot) and torch.equal(got[1], gate)
    assert calls == [((slot == 8).sum(dim=1).tolist(), 48), ([0], 8)]
    assert all(n >= 8 for n in calls[0][0])  # at most 8 of a row's 16 choices fit
    with pytest.raises(RuntimeError, match="inside"):
        with chip_smoke.moe_drops():
            raise RuntimeError("inside")
    assert moe.route_group is route
