"""How ``chip_smoke.py`` places the ranks of its multi-rank phases (13 (b),
16 (b), 17 (b), 18, 19 and 20 (b)), on the CPU.

One rule, ``rank_route``: a rank on its own card over NCCL when the device
is a card and the machine has a card for every rank, else the shared
device over gloo. ``rank_setup`` starts each rank's process by it and
``run_ranks`` spawns, waits and collects, ending a phase whose ranks fail
or overrun with a ``PhaseError`` that names them. Then phase 18's
per-card case, llama4-scout in ``ep``, rehearsed at a small width on
(data 2, model 2) gloo ranks through ``moe_shard``: the loss and every
gradient against the unsharded ones, the top_k = 1 router's gradient 0 on
both sides (ROADMAP C.1f)."""
import os
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("device,cards,world,want", [
    ("cpu", 1, 4, [("cpu", "gloo")] * 4),
    ("cpu", 8, 2, [("cpu", "gloo")] * 2),  # the CPU has no NCCL, whatever the cards
    ("cuda", 1, 2, [("cuda", "gloo")] * 2),  # ranks share the one card
    ("cuda", 2, 4, [("cuda", "gloo")] * 4),  # fewer cards than ranks
    ("cuda", 4, 4, [(f"cuda:{r}", "nccl") for r in range(4)]),
    ("cuda", 4, 2, [("cuda:0", "nccl"), ("cuda:1", "nccl")]),  # GPipe's two stages
    ("cuda", 8, 4, [(f"cuda:{r}", "nccl") for r in range(4)]),
])
def test_rank_route_is_a_pure_function_of_rank_world_device_and_cards(device, cards, world,
                                                                        want):
    assert [chip_smoke.rank_route(r, world, device, cards) for r in range(world)] == want
    backend = want[0][1]
    assert chip_smoke.route_name(backend) == ("nccl per card" if backend == "nccl"
                                              else "gloo shared")


def test_cards_of_the_cpu_is_one():
    assert chip_smoke.cards_of("cpu") == 1


def _gpipe_inputs(tmp, overrides):
    from repro_torch.models import LM

    cfg = chip_smoke.pipeline_config(**overrides)
    lm = LM(cfg, seed=0, device="cpu")
    with torch.no_grad():
        x = lm.embed[torch.zeros((2, 1, 8), dtype=torch.int64)]
    torch.save({"x": x}, f"{tmp}/inputs.pt")


TINY_PIPE = dict(n_layers=2, d_model=64, ssm_state=16, ssm_headdim=32, vocab_size=128)


def test_run_ranks_names_the_failed_ranks_and_shows_their_output(tmp_path):
    # no inputs: every rank raises once its group is up
    t0 = time.perf_counter()
    with pytest.raises(chip_smoke.PhaseError,
                       match=r"rehearsal: ranks \[[01](, 1)?\] failed \(gloo shared;") as e:
        chip_smoke.run_ranks("gpipe_rank", 2, str(tmp_path), "cpu", (TINY_PIPE, 0),
                             phase="rehearsal", timeout=120)
    assert "inputs.pt" in str(e.value) and time.perf_counter() - t0 < 100


def test_run_ranks_ends_ranks_that_overrun_with_a_phase_error(tmp_path):
    # a time limit shorter than the ranks' start: the phase ends at the limit,
    # every rank killed, none left running
    _gpipe_inputs(tmp_path, TINY_PIPE)
    t0 = time.perf_counter()
    with pytest.raises(chip_smoke.PhaseError, match=r"did not finish in 0.5 s \(ranks "):
        chip_smoke.run_ranks("gpipe_rank", 2, str(tmp_path), "cpu", (TINY_PIPE, 0),
                             phase="rehearsal", timeout=0.5)
    assert time.perf_counter() - t0 < 30
    assert not list(tmp_path.glob("rank*.pt"))


#: llama4-scout's layer cut to a few columns: 16 experts over ``model`` (8 a
#: rank), top_k 1, the shared expert, 40 q heads padded to 48 over 8 kv heads
TINY_LLAMA4 = dict(d_model=128, head_dim=16, d_ff=64, shared_expert_ff=64, vocab_size=512)


def test_phase_18s_llama4_scout_case_rehearses_on_gloo_ranks():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = chip_smoke.moe_shard("cpu", seq=16, overrides=TINY_LLAMA4,
                                   cases=chip_smoke.MOE_PER_CARD, timeout=170)
    finally:
        torch.set_num_threads(threads)
    (arch,) = chip_smoke.MOE_PER_CARD
    r = res[arch]
    assert arch == "llama4-scout-17b-a16e" and r["n_layers"] == 1 and r["moe_mode"] == "ep"
    assert r["route"] == "gloo shared" and r["world"] == 4 and r["mesh"] == [2, 2]
    assert r["loss_rel"] <= chip_smoke.TP_LOSS_RTOL and not r["over"]
    assert r["grad_worst"] <= chip_smoke.TP_GRAD_TOL
    # the top_k = 1 router: 0 in exact arithmetic, 0 to its rounding on both sides
    assert list(r["zero_leaves"]) == ["layers.0.moe.router"]
    assert r["zero_leaves"]["layers.0.moe.router"] <= chip_smoke.TP_ZERO_TOL
    assert all({k: b[k] for k in r["expected_bytes"]} == r["expected_bytes"] for b in r["bytes"])
    assert res["launches"] == {"flash_attention": 0, "ssd": 0}  # plain on the CPU


def test_the_full_llama4_scout_case_is_one_full_width_layer_in_ep():
    from repro_torch.models.config import TP

    (arch, (cut, mode)), = chip_smoke.MOE_PER_CARD.items()
    cfg = chip_smoke.tp_config(arch, **cut)
    assert (cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.top_k, cfg.d_ff) == (1, 5120, 16, 1,
                                                                               8192)
    assert (cfg.padded_heads(TP), cfg.padded_kv_heads(TP), cfg.moe_mode(TP)) == (48, 8, mode)
    assert chip_smoke.zero_grad_leaves(cfg) == {"layers.0.moe.router"}
    assert cfg.dtype == "float32" and "examples" in chip_smoke.ALONE
