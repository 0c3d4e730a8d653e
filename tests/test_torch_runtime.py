"""The port's runtime (gradient compression, the fault-tolerant loop) and the
backend's environment knobs, against the reference.

int8 compression is the reference's bit for bit on the same numpy input
(same rounding, same clip, same residual). The compressed all-reduces run in
two gloo ranks, each its own subprocess (a ``file://`` rendezvous in
``tmp_path``, 120 s timeout each): bf16 sums within bf16's rounding of each
term (2 x 2^-8 of the sum of |terms|), int8 sums within half a quantisation
step of each rank (0.5 x the sum of the ranks' scales), the same bits on both
ranks. The reference's tests of the error feedback, the quantisation bound
and the monitor (tests/test_checkpoint_runtime.py) are ported beside them.
``REPRO_BACKEND`` and ``REPRO_SHARD_MIN_ROWS`` select as the reference's do.
"""
import os
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.runtime import compress as jcompress
from repro_torch import core
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.core import CudaBackend, TorchBackend
from repro_torch.core.backend import SHARD_MIN_ROWS, GuardedBackend, _plain, _sharded
from repro_torch.runtime import (FaultTolerantLoop, HeartbeatMonitor, compressed_allreduce_int8,
                                 compressed_psum_bf16, ef_state_init, int8_compress,
                                 int8_decompress)
from repro_torch.stream import StreamBackend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- int8 compression against the reference ------------------------------------------------


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 250.0), (3, 1e-7)])
def test_int8_compress_is_the_reference_bit_for_bit(seed, scale):
    r = np.random.default_rng(seed)
    g = (r.standard_normal((97,)) * scale).astype(np.float32)
    err = (r.standard_normal((97,)) * scale * 0.01).astype(np.float32)
    jq, js, je = jcompress.int8_compress(jnp.asarray(g), jnp.asarray(err))
    tq, ts, te = int8_compress(torch.from_numpy(g), torch.from_numpy(err))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and te.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(int8_decompress(tq, ts).numpy(),
                                  np.asarray(jcompress.int8_decompress(jq, js)))


def test_int8_compress_of_bf16_gradients_matches_reference():
    g = np.random.default_rng(5).standard_normal((64,)).astype(np.float32)
    jq, js, je = jcompress.int8_compress(jnp.asarray(g).astype(jnp.bfloat16), jnp.zeros(64))
    tq, ts, te = int8_compress(torch.from_numpy(g).to(torch.bfloat16), torch.zeros(64))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_ef_state_init_and_a_world_of_one():
    grads = {"a": torch.ones(3, dtype=torch.bfloat16), "b": [torch.full((2, 2), 0.3)]}
    ef = ef_state_init(grads)
    assert ef["a"].dtype == torch.float32 and ef["b"][0].shape == (2, 2)
    assert float(ef["a"].abs().sum()) == 0.0
    # no process group: a one-rank reduction (the compressed round trip)
    out = compressed_psum_bf16(grads)
    assert out["a"].dtype == torch.bfloat16 and torch.equal(out["a"], grads["a"])
    assert torch.equal(out["b"][0], grads["b"][0].to(torch.bfloat16).float())
    summed, new_ef = compressed_allreduce_int8(grads, ef)
    q, s, e = int8_compress(grads["b"][0], ef["b"][0])
    assert torch.equal(summed["b"][0], int8_decompress(q, s)) and torch.equal(new_ef["b"][0], e)
    assert summed["a"].dtype == torch.bfloat16


# -- the reference's compression tests (tests/test_checkpoint_runtime.py), ported ----------


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 1000), scale=st.floats(1e-4, 1e3))
def test_int8_quantization_error_bound(seed, scale):
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(64).astype(np.float32)) * scale
    q, s, err = int8_compress(g, torch.zeros_like(g))
    deq = int8_decompress(q, s)
    assert float((deq - g).abs().max()) <= float(s) * 0.5 + 1e-6
    # error feedback: the residual is the quantisation error
    np.testing.assert_allclose(err.numpy(), (g - deq).numpy(), rtol=1e-5, atol=1e-7 * scale)


def test_error_feedback_reduces_bias():
    """Repeated EF-compressed sums drift less than naive quantisation."""
    gq = torch.full((32,), 0.004)  # well below one int8 step at scale ~0.03
    gq[0] = 4.0  # forces a coarse scale
    err = torch.zeros_like(gq)
    acc_ef, acc_naive = torch.zeros_like(gq), torch.zeros_like(gq)
    for _ in range(50):
        q, s, err = int8_compress(gq, err)
        acc_ef += int8_decompress(q, s)
        q2, s2, _ = int8_compress(gq, torch.zeros_like(gq))
        acc_naive += int8_decompress(q2, s2)
    true = gq * 50
    assert float((acc_ef - true)[1:].abs().max()) < float((acc_naive - true)[1:].abs().max()) + 1e-5


# -- the monitor (tests/test_checkpoint_runtime.py), ported -----------------------------


def test_heartbeat_straggler_detection():
    mon = HeartbeatMonitor(threshold=2.0, window=16)
    for i in range(20):
        mon.record(i, 0.1)
    assert mon.record(20, 0.5) is True
    assert mon.record(21, 0.11) is False
    assert len(mon.stragglers) == 1
    assert mon.median == pytest.approx(0.1)


def test_fault_tolerant_loop_recovers(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path))
    state0 = {"x": torch.zeros(())}
    ck.save(0, state0)
    ck.wait()
    fails = {7, 13}

    def inject(step):
        if step in fails:
            fails.discard(step)
            raise RuntimeError("boom")

    def step_fn(st_, step):
        return {"x": st_["x"] + 1}, {}

    def restore():
        s = latest_step(str(tmp_path))
        _, st_ = restore_checkpoint(str(tmp_path), state0, step=s)
        return s, st_

    loop = FaultTolerantLoop(step_fn, ck, ckpt_every=5, failure_injector=inject)
    final, end = loop.run(state0, 0, 20, restore)
    assert end == 20 and loop.restarts == 2
    assert float(final["x"]) >= 15  # replayed segments re-executed


def test_too_many_failures_raises(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(0, {"x": torch.zeros(())})
    ck.wait()

    def inject(step):
        raise RuntimeError("always")

    loop = FaultTolerantLoop(lambda s, i: (s, {}), ck, max_restarts=2, failure_injector=inject)
    with pytest.raises(RuntimeError):
        loop.run({"x": torch.zeros(())}, 0, 5, lambda: (0, {"x": torch.zeros(())}))


def test_monitor_flags_an_injected_slow_step_in_the_loop(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path))

    def step_fn(st_, step):
        time.sleep(0.3 if step == 12 else 0.002)
        return st_, {}

    loop = FaultTolerantLoop(step_fn, ck, ckpt_every=100,
                             monitor=HeartbeatMonitor(threshold=3.0, window=8))
    loop.run({"x": torch.zeros(())}, 0, 14, lambda: (0, {"x": torch.zeros(())}))
    # step 12 is flagged (a loaded machine may flag a fast step too)
    assert 12 in [s for s, _ in loop.monitor.stragglers]


# -- the compressed all-reduces in two gloo ranks ------------------------------------------

_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, size, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv", rank=rank,
                            world_size=size)
    from repro_torch.runtime import (compressed_allreduce_int8, compressed_psum_bf16,
                                     ef_state_init)

    inp = np.load(f"{tmp}/inputs.npz")
    grads = {"w": torch.from_numpy(inp[f"w{rank}"]), "b": [torch.from_numpy(inp[f"b{rank}"])]}
    bf = compressed_psum_bf16(grads)
    ef = ef_state_init(grads)
    q1, ef = compressed_allreduce_int8(grads, ef)
    q2, ef = compressed_allreduce_int8(grads, ef)
    np.savez(f"{tmp}/rank{rank}.npz", bf_w=bf["w"].numpy(), bf_b=bf["b"][0].numpy(),
             q_w=q1["w"].numpy(), q_b=q1["b"][0].numpy(), q2_w=q2["w"].numpy(),
             ef_w=ef["w"].numpy())
    dist.destroy_process_group()
    print("RANK_OK")
""")


def test_compressed_allreduces_on_two_gloo_ranks(tmp_path):
    world = 2
    r = np.random.default_rng(0)
    inp = {f"{name}{k}": (r.standard_normal(shape) * (k + 1)).astype(np.float32)
           for k in range(world) for name, shape in (("w", (33, 5)), ("b", (7,)))}
    np.savez(tmp_path / "inputs.npz", **inp)
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(k), str(world), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k in range(world)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for k, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "RANK_OK" in out, f"rank {k}:\n{out}"
    res = [dict(np.load(tmp_path / f"rank{k}.npz")) for k in range(world)]
    for key in res[0]:  # the same bits on both ranks (but the residuals, which are each rank's)
        if key != "ef_w":
            np.testing.assert_array_equal(res[0][key], res[1][key])
    for name in ("w", "b"):
        terms = [inp[f"{name}{k}"] for k in range(world)]
        exact = sum(t.astype(np.float64) for t in terms)
        mag = sum(np.abs(t.astype(np.float64)) for t in terms)
        assert np.all(np.abs(res[0][f"bf_{name}"] - exact) <= 2 * 2 ** -8 * mag + 1e-30)
        scales = sum(np.abs(t).max() / 127.0 for t in terms)
        assert np.abs(res[0][f"q_{name}"] - exact).max() <= 0.5 * scales * (1 + 1e-5)
    # error feedback: two steps' sums together are within one step of twice the sum
    w2 = 2 * sum(inp[f"w{k}"].astype(np.float64) for k in range(world))
    scales = sum(np.abs(inp[f"w{k}"]).max() / 127.0 for k in range(world))
    assert np.abs(res[0]["q_w"] + res[0]["q2_w"] - w2).max() <= 1.5 * scales


# -- REPRO_BACKEND and REPRO_SHARD_MIN_ROWS ---------------------------------------------------


@pytest.mark.parametrize("value,kind", [("torch", TorchBackend), ("cuda", CudaBackend),
                                        ("guarded", GuardedBackend), ("stream", StreamBackend),
                                        ("  Torch ", TorchBackend)])
def test_repro_backend_names_a_registered_backend(monkeypatch, value, kind):
    monkeypatch.setenv("REPRO_BACKEND", value)
    assert isinstance(core.default_backend("cpu"), kind)
    assert isinstance(core.resolve_backend(None, device="cpu"), kind)
    # a backend the caller passes still wins over the variable
    assert isinstance(core.resolve_backend("torch"), TorchBackend)


def test_repro_backend_takes_a_composite_spec(monkeypatch):
    monkeypatch.setenv("REPRO_BACKEND", "stream:torch")
    be = core.default_backend("cpu", n=10)
    assert isinstance(be, StreamBackend) and isinstance(be.inner, TorchBackend)


@pytest.mark.parametrize("value", ["torch", "stream:torch", " Stream:Torch"])
@pytest.mark.parametrize("device", [None, "cuda"])
def test_repro_backend_never_puts_the_plain_backend_under_card_data(monkeypatch, value, device):
    monkeypatch.setenv("REPRO_BACKEND", value)
    with pytest.raises(ValueError, match="REPRO_BACKEND.*plain TorchBackend"):
        core.default_backend(device)
    with pytest.raises(ValueError, match="REPRO_BACKEND"):
        core.resolve_backend(None, device=device, n=10)
    # the CPU's data still takes it, and the card's takes the kernels' backends
    assert _plain(core.default_backend("cpu"))
    for kernels in ("cuda", "stream", "stream:cuda", "guarded", "sharded"):
        monkeypatch.setenv("REPRO_BACKEND", kernels)
        assert not _plain(core.default_backend(device))


@pytest.mark.parametrize("value", ["", "auto", "AUTO"])
def test_repro_backend_auto_or_empty_falls_through_to_the_rules(monkeypatch, value):
    monkeypatch.setenv("REPRO_BACKEND", value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        core.default_backend()
    with pytest.raises(RuntimeError, match="backend='torch'"):
        core.default_backend("cpu")


@pytest.mark.parametrize("value", ["nope", "stream:nope", "torch:cuda"])
def test_a_bad_repro_backend_raises_naming_the_variable(monkeypatch, value):
    monkeypatch.setenv("REPRO_BACKEND", value)
    with pytest.raises(ValueError, match="REPRO_BACKEND"):
        core.default_backend("cpu")


def test_unset_repro_backend_keeps_the_defaults(monkeypatch):
    monkeypatch.delenv("REPRO_BACKEND", raising=False)
    with pytest.raises(RuntimeError, match="backend='torch'"):
        core.default_backend("cpu")  # data off the card still raises
    # GuardedBackend is picked by no rule: only by the variable or by name
    assert isinstance(core.resolve_backend("guarded"), GuardedBackend)


def test_repro_shard_min_rows_is_honoured(monkeypatch):
    import torch.distributed as dist

    from repro_torch.core import distributed

    monkeypatch.setattr(distributed, "world", lambda group: (0, 4))  # a group of four
    monkeypatch.delenv("REPRO_SHARD_MIN_ROWS", raising=False)
    assert _sharded(SHARD_MIN_ROWS) and not _sharded(SHARD_MIN_ROWS - 1)
    monkeypatch.setenv("REPRO_SHARD_MIN_ROWS", "100")
    assert _sharded(100) and not _sharded(99)
    monkeypatch.setenv("REPRO_SHARD_MIN_ROWS", " ")
    assert not _sharded(SHARD_MIN_ROWS - 1)
    assert not dist.is_initialized()
