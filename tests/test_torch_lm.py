"""The port's LM stack and Jamba serving path (slice 4) against the JAX reference.

Inputs come from numpy seeds and go through both packages in one process;
the JAX side runs on the CPU (Pallas kernels in interpret mode). On the CPU
the port's wrappers run the plain versions of K8 (flash attention) and K9
(the SSD chunk scan); tests/test_torch_cuda.py holds the kernels to those
plain versions on the card.

Tolerances are the reference tests' own: K8 2e-5 (bf16 2e-2) and K9 2e-4
(bf16 3e-2) (tests/test_kernels.py); whole models 2e-4 * max|ref| in fp32;
decode against forward 5e-3 (tests/test_models.py). The SSD decay uses
softplus without torch's identity cut-off above 20 (jax.nn.softplus's form),
so no tolerance covers a difference there.
"""
import dataclasses
import math
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.kernels.flash_attention import ops as jax_fa
from repro.kernels.ssd import ops as jax_ssd
from repro.models import attention as jattn
from repro.models import forward as jforward
from repro.models import init_params, logits_fn
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba
from repro.models import moe as jmoe
from repro.serving import engine as jengine
from repro_torch import configs, kernels
from repro_torch.interop import lm_params_from_numpy
from repro_torch.kernels import flash_attention_ops as fa
from repro_torch.kernels import ssd_ops as so
from repro_torch.models import LM, layers
from repro_torch.models.config import TP
from repro_torch.models import attention as tattn
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.serving import ServeEngine, prefill, prefill_logits

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the script at the repo root)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(out, ref, tol):
    out = np.asarray(torch.as_tensor(out).float()) if isinstance(out, torch.Tensor) else out
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert out.shape == ref.shape, (out.shape, ref.shape)
    assert np.all(np.isfinite(out))
    err, scale = float(np.abs(out - ref).max()), float(np.abs(ref).max())
    assert err <= tol * max(scale, 1e-30), (err, tol * scale)


def _cfg(name, layers_=None, **kw):
    """The reference's smoke config and the port's copy of it, both fp32."""
    kw = dict(dtype="float32", **kw)
    if layers_:
        kw["n_layers"] = layers_
    return (dataclasses.replace(jconfigs.smoke(jconfigs.get_config(name)), **kw),
            dataclasses.replace(configs.smoke(configs.get_config(name)), **kw))


def _carried(name, layers_=None, **kw):
    """(reference cfg, params, port cfg, port LM on the CPU with the same weights)."""
    jcfg, tcfg = _cfg(name, layers_, **kw)
    params = init_params(jcfg, jax.random.PRNGKey(0))
    lm = LM(tcfg, device="cpu")
    lm.load_state_dict(lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params)), strict=True)
    return jcfg, params, tcfg, lm


# -- K8 and K9: the plain versions against the reference kernels --------------------------


ATTN_SHAPES = [(4, 4, 256, 128, True), (8, 2, 300, 64, True), (8, 1, 512, 80, True),
               (4, 4, 300, 64, False), (2, 2, 128, 128, False), (8, 1, 200, 256, True),
               (2, 2, 130, 256, False), (4, 2, 150, 200, True)]


@pytest.mark.parametrize("hq,hkv,s,d,causal", ATTN_SHAPES)
def test_plain_flash_attention_matches_reference_kernel(hq, hkv, s, d, causal):
    r = _rng(s + d)
    q, k, v = (r.standard_normal((2, h, s, d)).astype(np.float32) for h in (hq, hkv, hkv))
    out = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(out, jax_fa.flash_attention(jq, jk, jv, causal=causal, bq=128, bk=128,
                                       interpret=True), 2e-5)
    _close(out, jax_fa.flash_attention_reference(jq, jk, jv, causal=causal), 2e-5)


def test_k8_takes_head_dims_up_to_256():
    # gemma-2b's heads are 256 wide (the reference's wrapper takes any D)
    assert fa.MAX_D == 256 == configs.get_config("gemma-2b").head_dim
    src = (REPO / "src/repro_torch/kernels/flash_attention/flash_attention.cu").read_text()
    # each dispatch has a 256-wide tile and refuses (throws) past it
    assert "launch<16>" in src and "launch_mma<256>" in src
    assert src.count("default: throw std::invalid_argument") == 2
    assert "q.size(3) <= 256" in (REPO / "src/repro_torch/kernels/csrc/binding.cpp").read_text()


def test_plain_flash_attention_bf16_matches_reference_kernel():
    r = _rng(1)
    q, k, v = (r.standard_normal((1, h, 256, 128)).astype(np.float32) for h in (4, 2, 2))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    _close(out, jax_fa.flash_attention(jq, jk, jv, interpret=True), 2e-2)


def _attention_with_k8_mma_rounding(q, k, v, causal, bk=64):
    """The bf16 tensor-core K8's arithmetic, tile by tile on the CPU: bf16 q,
    k, v; fp32 scores scaled by 1/sqrt(D), the reference's -1e30 mask; an
    online softmax over 64-key tiles whose row sum l adds the unrounded fp32
    p, while P is rounded to bf16 before P V; fp32 accumulation; O / l
    rounded to bf16."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(group, dim=1) for t in (k, v))
    m = torch.full((b, hq, s), -1e30)
    l = torch.zeros((b, hq, s))
    o = torch.zeros((b, hq, s, d))
    qpos = torch.arange(s)
    for k0 in range(0, s, bk):
        sc = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + bk]) * (1.0 / math.sqrt(d))
        if causal:
            kpos = torch.arange(k0, min(k0 + bk, s))
            sc = torch.where(qpos[:, None] >= kpos[None, :], sc, sc.new_full((), -1e30))
        m_new = torch.maximum(m, sc.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = corr * l + p.sum(-1)
        o = o * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vf[:, :, k0:k0 + bk])
        m = m_new
    return (o / l.clamp_min(1e-30)[..., None]).to(torch.bfloat16)


@pytest.mark.parametrize("hq,hkv,s,d,causal", ATTN_SHAPES + [(4, 2, 200, 17, True)])
def test_k8_tensor_core_rounding_stays_within_the_bf16_tolerance(hq, hkv, s, d, causal):
    # Rounding P to bf16 before P V is the one step where the bf16 kernel
    # departs from the reference, which keeps p in fp32; the bf16 tolerance
    # (tests/test_kernels.py) still holds with it.
    r = _rng(s + d + 1)
    q, k, v = (r.standard_normal((2, h, s, d)).astype(np.float32) for h in (hq, hkv, hkv))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = _attention_with_k8_mma_rounding(tq, tk, tv, causal)
    assert out.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    ref = jax_fa.flash_attention(jq, jk, jv, causal=causal, bq=128, bk=128, interpret=True)
    _close(out, ref, 2e-2)
    # and per query row, as chip_smoke.py and the card's test hold the kernel
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    row_err = (out.float() - ref).abs().amax(-1) / ref.abs().amax(-1)
    assert float(row_err.max()) <= 2e-2, float(row_err.max())


def _ssd_inputs(b, s, h, p, n, seed):
    r = _rng(seed)
    x = r.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.3 * r.standard_normal(h)).astype(np.float32)
    bm = (0.5 * r.standard_normal((b, s, n))).astype(np.float32)
    cm = (0.5 * r.standard_normal((b, s, n))).astype(np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("s,chunk,h,p,n", [(96, 32, 4, 8, 16), (80, 32, 2, 16, 8),
                                           (100, 64, 3, 16, 8)])
def test_plain_ssd_matches_reference_kernel(s, chunk, h, p, n):
    args = _ssd_inputs(2, s, h, p, n, s + h)
    y, st = so.ssd(*map(torch.from_numpy, args), chunk=chunk)
    jy, jst = jax_ssd.ssd(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    _close(y, jy, 2e-4)
    _close(st, jst, 2e-4)
    # the oracle at a chunk that divides S
    ry, rst = jax_ssd.ssd_reference(*map(jnp.asarray, args), chunk=16 if s % 16 == 0 else s)
    _close(y, ry, 2e-4)
    _close(st, rst, 2e-4)


def test_plain_ssd_bf16_matches_reference_kernel():
    x, dt, a, bm, cm = _ssd_inputs(1, 64, 4, 8, 16, 7)
    tx, tdt, tb, tc = (torch.from_numpy(t).to(torch.bfloat16) for t in (x, dt, bm, cm))
    y, _ = so.ssd(tx, tdt, torch.from_numpy(a), tb, tc, chunk=32)
    assert y.dtype == torch.bfloat16
    jx, jdt, jb, jc = (jnp.asarray(t).astype(jnp.bfloat16) for t in (x, dt, bm, cm))
    jy, _ = jax_ssd.ssd(jx, jdt, jnp.asarray(a), jb, jc, chunk=32, interpret=True)
    _close(y, jy, 3e-2)


def test_plain_ssd_matches_the_recurrence_at_any_chunk():
    # padding with dt = 0 is an identity step: y[:S] and the state do not
    # depend on the chunk
    args = [torch.from_numpy(t) for t in _ssd_inputs(2, 77, 3, 8, 5, 3)]
    x, dt, a, bm, cm = args
    st = torch.zeros(2, 3, 8, 5)
    ys = []
    for t in range(77):
        yt, st = tmamba.ssd_decode_step(st, x[:, t], dt[:, t], a, bm[:, t], cm[:, t])
        ys.append(yt)
    for chunk in (8, 64, 128):
        y, fin = so.ssd(*args, chunk=chunk)
        torch.testing.assert_close(y, torch.stack(ys, 1), rtol=0, atol=2e-4 * 12)
        torch.testing.assert_close(fin, st, rtol=0, atol=2e-4 * float(st.abs().max()))


@pytest.mark.parametrize("s,chunk", [(200, 32), (333, 64)])
def test_plain_ssd_carries_the_state_over_many_chunks(s, chunk):
    # more than four chunks, each starting from the state the ones before it
    # carried: the port's plain version against the Pallas K9 in interpret mode
    args = _ssd_inputs(2, s, 3, 16, 8, s + chunk)
    y, st = so.ssd(*map(torch.from_numpy, args), chunk=chunk)
    jy, jst = jax_ssd.ssd(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    assert -(-s // chunk) > 4
    _close(y, jy, 2e-4)
    _close(st, jst, 2e-4)


@pytest.mark.parametrize("s,h,p,n,chunk", [(2048, 128, 64, 16, 64), (2048, 128, 64, 16, 128),
                                           (4100, 12, 64, 16, 64), (2053, 4, 32, 8, 128),
                                           (5, 2, 8, 4, 64), (777, 3, 17, 5, 32),
                                           (100, 70, 1, 1, 4), (64, 1, 512, 16, 16)])
def test_ssd_plan_covers_every_row_and_head_once(s, h, p, n, chunk):
    plan = so.ssd_plan(s, h, p, n, chunk)
    assert plan == so.ssd_plan(s, h, p, n, chunk)  # a pure function of the shape
    assert (plan.n_chunks - 1) * chunk < s <= plan.n_chunks * chunk
    for heads in (plan.state_heads, plan.scan_heads):  # head groups cover every head once
        groups = -(-h // heads)
        assert 1 <= heads <= h and (groups - 1) * heads < h <= groups * heads
    assert plan.scan_heads <= so.SCAN_HEADS
    assert plan.state_heads <= so.STATE_MAX_HEADS
    assert plan.state_heads == 1 or plan.state_heads * p <= so.STATE_COLS
    assert plan.smem == so.smem_bytes(p, n, chunk) <= so.MAX_SMEM


def test_ssd_plan_at_jambas_layer_and_the_kernels_constants():
    # Jamba's Mamba layer at chunk 64: 32 chunks, 8 heads per block in both
    # chunk kernels (16 x 32 x 4 = 2 048 blocks each), 82 176 bytes a block
    assert so.ssd_plan(2048, 128, 64, 16, 64) == so.SsdPlan(32, 8, 8, 82_176)
    assert so.ssd_plan(2048, 128, 64, 16, 128).smem <= so.MAX_SMEM
    text = (REPO / "src" / "repro_torch" / "kernels" / "ssd" / "ssd.cu").read_text()
    const = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    assert const["SCAN_HEADS_MAX"] == so.SCAN_HEADS and const["SCOLS"] == so.STATE_COLS
    assert const["SHG_MAX"] == so.STATE_MAX_HEADS and const["RS"] == so.STATE_ROWS
    # three launches, no float atomics, C B^T formed once per block before its heads
    scan = text[text.index("ssd_chunk_scan_kernel(const T*"):text.index("template <typename T>\nvoid launch_state(")]
    assert scan.index("C B^T once for the block's heads") < scan.index("for (int hl = 0; hl < nh; ++hl)")
    assert "atomicAdd" not in text and ".tf32" not in text


# -- the modules against the reference functions --------------------------------------------


@pytest.mark.parametrize("causal,softcap,hkv", [(True, 0.0, 2), (False, 0.0, 4), (True, 30.0, 1)])
def test_attention_and_decode_attention_match_reference(causal, softcap, hkv):
    r = _rng(11)
    q = r.standard_normal((2, 150, 4, 32)).astype(np.float32)
    k, v = (r.standard_normal((2, 150, hkv, 32)).astype(np.float32) for _ in range(2))
    out = tattn.attention(*map(torch.from_numpy, (q, k, v)), causal=causal, chunk=64,
                          softcap=softcap)
    _close(out, jattn.attention(*map(jnp.asarray, (q, k, v)), causal=causal, chunk=64,
                                softcap=softcap), 2e-5)
    length = np.array([37, 150], np.int32)
    out = tattn.decode_attention(torch.from_numpy(q[:, :1]), torch.from_numpy(k),
                                 torch.from_numpy(v), softcap=softcap,
                                 length=torch.from_numpy(length))
    _close(out, jattn.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k), jnp.asarray(v),
                                       softcap=softcap, length=jnp.asarray(length)), 2e-5)


@pytest.mark.parametrize("chunk,init", [(32, False), (16, True)])
def test_ssd_chunked_and_decode_step_match_reference(chunk, init):
    x, dt, a, bm, cm = _ssd_inputs(2, 64, 4, 8, 16, 5)
    s0 = _rng(6).standard_normal((2, 4, 8, 16)).astype(np.float32) if init else None
    tb, tc = torch.from_numpy(bm)[:, :, None], torch.from_numpy(cm)[:, :, None]
    y, st = tmamba.ssd_chunked(torch.from_numpy(x), torch.from_numpy(dt), torch.from_numpy(a),
                               tb, tc, chunk=chunk,
                               init_state=None if s0 is None else torch.from_numpy(s0))
    jy, jst = jmamba.ssd_chunked(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a),
                                 jnp.asarray(bm)[:, :, None], jnp.asarray(cm)[:, :, None],
                                 chunk=chunk, init_state=None if s0 is None else jnp.asarray(s0))
    _close(y, jy, 2e-4)
    _close(st, jst, 2e-4)
    s1 = _rng(8).standard_normal((2, 4, 8, 16)).astype(np.float32)
    y1, n1 = tmamba.ssd_decode_step(torch.from_numpy(s1), torch.from_numpy(x[:, 0]),
                                    torch.from_numpy(dt[:, 0]), torch.from_numpy(a),
                                    torch.from_numpy(bm[:, 0]), torch.from_numpy(cm[:, 0]))
    jy1, jn1 = jmamba.ssd_decode_step(jnp.asarray(s1), jnp.asarray(x[:, 0]),
                                      jnp.asarray(dt[:, 0]), jnp.asarray(a),
                                      jnp.asarray(bm[:, 0]), jnp.asarray(cm[:, 0]))
    _close(y1, jy1, 2e-5)
    _close(n1, jn1, 2e-5)


@pytest.mark.parametrize("capacity_factor,act,shared", [(1.25, "swiglu", 0), (16.0, "gelu", 0),
                                                        (1.0, "swiglu", 48)])
def test_moe_matches_reference_including_drops(capacity_factor, act, shared):
    d, ff, e, k = 32, 64, 8, 2
    p = jmoe.moe_init(jax.random.PRNGKey(3), d, ff, e, act, shared_ff=shared, dtype=jnp.float32)
    x = _rng(4).standard_normal((3, 40, d)).astype(np.float32)
    want = jax.jit(lambda p, x: jmoe.moe_apply(p, x, top_k=k, n_experts=e, act=act,
                                               capacity_factor=capacity_factor))(p, jnp.asarray(x))
    m = tmoe.MoE(d, ff, e, k, act, capacity_factor=capacity_factor, shared_ff=shared,
                 generator=torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")
    flat = {key: np.asarray(val) for key, val in p.items() if key != "shared"}
    flat.update({f"shared.{key}": np.asarray(val) for key, val in p.get("shared", {}).items()})
    m.load_state_dict({key: torch.from_numpy(np.array(val)) for key, val in flat.items()},
                      strict=True)
    _close(m(torch.from_numpy(x)), want, 2e-5)
    # the routing itself: slots (drops included) equal the reference's
    cap = tmoe.capacity(40, k, capacity_factor, e)
    slot, gate = tmoe.route_group(torch.from_numpy(x), m.router, k, cap, e)
    js, jg, _ = jax.jit(jmoe._route_group, static_argnums=(2, 3, 4))(
        jnp.asarray(x[2]), p["router"], k, cap, e)
    np.testing.assert_array_equal(slot[2].numpy(), np.asarray(js))
    np.testing.assert_allclose(gate[2].numpy(), np.asarray(jg), rtol=1e-6)
    if capacity_factor == 1.0:
        assert int((slot == e * cap).sum()) > 0  # the case drops tokens


def test_layers_match_reference():
    r = _rng(9)
    x = r.standard_normal((2, 10, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(10, dtype=np.int32), (2, 1)) + 5
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), 1e-6)
    p3 = np.stack([pos, pos * 2, pos + 3], axis=1)
    _close(layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(p3), 1e6, (16, 24, 24)),
           jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(p3), 1e6, (16, 24, 24)), 1e-6)
    g = r.standard_normal(16).astype(np.float32)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-6),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-6), 1e-6)
    _close(layers.sinusoidal_pos(12, 8, torch.float32),
           jlayers.sinusoidal_pos(12, 8, jnp.float32), 1e-6)
    for act in ("swiglu", "gelu"):
        _close(layers.act_fn(act, torch.from_numpy(x)), jlayers.act_fn(act, jnp.asarray(x)), 1e-6)
    big = np.array([-30.0, -1.0, 0.0, 19.0, 25.0, 60.0], np.float32)
    _close(tmamba.softplus(torch.from_numpy(big)), jax.nn.softplus(jnp.asarray(big)), 1e-7)


def test_ninit_keeps_the_reference_fan_in_rule():
    gen = torch.Generator().manual_seed(0)
    w = layers.ninit((256, 64), generator=gen, dtype=torch.float32, device="cpu")
    assert float(w.abs().max()) <= 2.0 / 16 + 1e-7
    assert abs(float(w.std()) - 0.88 / 16) < 0.004  # truncated at 2 sigma: std 0.88
    # stacked experts (E, d, ff): the fan-in is E, as in the reference
    ex = layers.ninit((8, 256, 64), generator=gen, dtype=torch.bfloat16, device="cpu")
    assert ex.dtype == torch.bfloat16 and abs(float(ex.float().std()) - 0.88 / 8 ** 0.5) < 0.01


def test_configs_are_copies_of_the_reference():
    assert configs.list_archs() == jconfigs.list_archs()
    for name in configs.list_archs():
        c, j = configs.get_config(name), jconfigs.get_config(name)
        assert dataclasses.asdict(c) == dataclasses.asdict(j)
        assert dataclasses.asdict(configs.smoke(c)) == dataclasses.asdict(jconfigs.smoke(j))
        assert c.param_count() == j.param_count() and c.layer_period == j.layer_period


# -- whole models, weights carried across -------------------------------------------------


def _tokens(cfg, b, s, seed=1):
    return _rng(seed).integers(0, cfg.vocab_size, (b, s))


def _batch(cfg, b, s, seed=1):
    """The reference test's batch (tests/test_models.py), from numpy: tokens or
    frames, and the vision model's M-RoPE positions and patch embeddings."""
    r = _rng(seed)
    bat = ({"tokens": r.integers(0, cfg.vocab_size, (b, s))} if cfg.embed_inputs else
           {"frames": r.standard_normal((b, s, cfg.d_model)).astype(np.float32)})
    if cfg.pos == "mrope":
        p = np.broadcast_to(np.arange(s), (b, s))
        bat["mrope_positions"] = np.stack([p, p, p], axis=1)
    if cfg.extra_image_tokens:
        bat["pixel_embeds"] = r.standard_normal(
            (b, cfg.extra_image_tokens, cfg.d_model)).astype(np.float32)
    return bat


@pytest.mark.parametrize("name,layers_", [("jamba-v0.1-52b", None), ("jamba-v0.1-52b", 16),
                                          ("mamba2-370m", None), ("phi3-mini-3.8b", None),
                                          ("gemma-2b", None), ("granite-moe-3b-a800m", None),
                                          ("llama4-scout-17b-a16e", None), ("minicpm-2b", None),
                                          ("qwen3-32b", None), ("hubert-xlarge", None),
                                          ("qwen2-vl-2b", None)])
def test_smoke_forward_and_prefill_logits_match_reference(name, layers_):
    jcfg, params, tcfg, lm = _carried(name, layers_)
    bat = _batch(jcfg, 2, 32)
    want = jax.jit(jforward, static_argnums=1)(params, jcfg,
                                               {k: jnp.asarray(v) for k, v in bat.items()})
    tbat = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in bat.items()}
    _close(lm(tbat), want, 2e-4)
    # the reference's prefill_logits is logits_fn of the forward's last position
    _close(prefill_logits(lm, tbat), logits_fn(params, jcfg, want[:, -1]), 2e-4)


def test_padded_head_guard_refuses_exactly_the_regrouping_configs():
    # every full configuration against a brute-force head map: the reference
    # replicates each of its kv heads over hq // hkv padded q heads
    # (attention._repeat_kv); the port builds the same padded heads and its
    # attention reads kv head h // (hp // kvp) for q head h; nothing is refused
    regrouping = set()
    for name in configs.list_archs():
        cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
        hp = jcfg.padded_heads(16)
        hkv = hp if jcfg.n_kv_heads == jcfg.n_heads else jcfg.n_kv_heads
        ref_map = np.repeat(np.arange(hkv), hp // hkv)
        assert (cfg.padded_heads(TP), cfg.padded_kv_heads(TP)) == (hp, hkv), name
        port_map = np.arange(hp) // (hp // cfg.padded_kv_heads(TP))
        np.testing.assert_array_equal(port_map, ref_map, err_msg=name)
        lm = LM(cfg, device="meta")
        for attn in (b.attn for b in lm.layers if b.mixer_kind == "attn"):  # none in mamba2
            assert attn.wq.shape[1] == attn.wo.shape[0] == hp * cfg.head_dim, name
            assert attn.wk.shape[1] == attn.wv.shape[1] == hkv * cfg.head_dim, name
        published = np.repeat(np.arange(cfg.n_kv_heads), cfg.n_heads // cfg.n_kv_heads)
        if not np.array_equal(ref_map[:cfg.n_heads], published):
            regrouping.add(name)
    # the configurations whose padded grouping is not the published one: kept for parity
    assert regrouping == {"granite-moe-3b-a800m", "llama4-scout-17b-a16e", "qwen2-vl-2b"}
    gemma = configs.get_config("gemma-2b")
    assert gemma.n_kv_heads == 1 and gemma.padded_heads(16) != gemma.n_heads


def test_interop_unstacks_groups_and_strips_padded_heads():
    # the padded leaves come across one to one (the port builds them too)
    jcfg, params, tcfg, lm = _carried("jamba-v0.1-52b", 16)
    sd = lm.state_dict()
    assert tcfg.padded_heads(16) == 16 and tcfg.n_heads == 4  # the smoke model is padded
    attn = params["blocks"]["blk4"]["attn"]
    assert attn["wq"].shape == (2, 128, 16 * 32)
    for g in range(2):
        for leaf in ("wq", "wk", "wv", "wo"):
            got = sd[f"layers.{8 * g + 4}.attn.{leaf}"]
            assert got.shape == attn[leaf].shape[1:]
            np.testing.assert_array_equal(got.numpy(), np.asarray(attn[leaf][g]))
    # a regrouping configuration carries across too, at its padded shapes
    granite = dataclasses.replace(configs.smoke(configs.get_config("granite-moe-3b-a800m")),
                                  n_heads=24, n_kv_heads=8, head_dim=16)
    jgranite = dataclasses.replace(jconfigs.smoke(jconfigs.get_config("granite-moe-3b-a800m")),
                                   n_heads=24, n_kv_heads=8, head_dim=16)
    gsd = lm_params_from_numpy(granite, jax.tree.map(
        np.asarray, init_params(jgranite, jax.random.PRNGKey(0))))
    LM(granite, device="cpu").load_state_dict(gsd, strict=True)
    assert gsd["layers.0.attn.wq"].shape == (128, 32 * 16)
    assert gsd["layers.0.attn.wk"].shape == (128, 8 * 16)
    # dtypes are kept (bf16 arrays of the reference come across as bf16)
    bf = init_params(jconfigs.smoke(jconfigs.get_config("phi3-mini-3.8b")),
                     jax.random.PRNGKey(0))
    sd = lm_params_from_numpy(configs.smoke(configs.get_config("phi3-mini-3.8b")),
                              jax.tree.map(np.asarray, bf))
    assert sd["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(sd["embed"].float().numpy(),
                                  np.asarray(bf["embed"].astype(jnp.float32)))


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "phi3-mini-3.8b", "mamba2-370m"])
def test_decode_reproduces_forward(name):
    # fp32 and no drops (decode groups are single tokens and never drop), as
    # the reference's own test; the reference's decode itself is held to the
    # port's in test_serve_engine_gives_the_reference_greedy_tokens
    _, tcfg = _cfg(name, capacity_factor=16.0)
    lm = LM(tcfg, seed=3, device="cpu")
    s = 12
    toks = torch.from_numpy(_tokens(tcfg, 2, s))
    want = prefill_logits(lm, {"tokens": toks})
    logits, cache = prefill(lm, toks, s)
    _close(logits, want.numpy(), 5e-3)
    assert len(cache) == tcfg.n_layers


def test_serve_engine_gives_the_reference_greedy_tokens():
    jcfg, params, tcfg, lm = _carried("jamba-v0.1-52b")
    prompts = [[5, 17, 300, 42], [7, 8, 9], [101]]

    def run(eng):
        eng.add_request(0, prompts[0])
        eng.add_request(1, prompts[1])
        for i in range(6):
            if i == 2:  # a request joins mid-flight
                eng.add_request(2, prompts[2])
            eng.step()
        return [eng.finish(s) for s in range(3)]

    want = run(jengine.ServeEngine(params=params, cfg=jcfg, max_len=32, batch_slots=3))
    got = run(ServeEngine(lm, max_len=32, batch_slots=3, device="cpu"))
    assert got == want
    assert [len(o) for o in got] == [7, 7, 5]
    with pytest.raises(ValueError, match="at least one"):
        ServeEngine(lm, max_len=8, batch_slots=1, device="cpu").add_request(0, [])


def test_sample_greedy_masks_the_padded_vocabulary():
    from repro_torch.serving import sample_greedy

    logits = torch.tensor([[0.0, 1.0, 5.0, 9.0], [3.0, 1.0, 0.0, 9.0]])
    assert sample_greedy(logits, 3).tolist() == [2, 0]


# -- devices, kernels' absence on the CPU, and imports -------------------------------------


def test_lm_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfg("jamba-v0.1-52b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(tcfg)
    lm = LM(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(lm, max_len=8, batch_slots=1)
    # BLESS-Nystrom attention builds and runs (it raised NotImplementedError
    # before the port had it): on the CPU when asked, and it too needs a card
    # by default
    nys = dataclasses.replace(tcfg, attention_impl="bless_nystrom")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(nys)
    toks = torch.from_numpy(_tokens(nys, 1, 2 * nys.nystrom_landmarks))
    assert bool(torch.all(torch.isfinite(prefill_logits(LM(nys, device="cpu"),
                                                        {"tokens": toks}))))


def test_cpu_forward_launches_no_kernel():
    _, _, _, lm = _carried("jamba-v0.1-52b")
    kernels.reset_launch_counts()
    prefill_logits(lm, {"tokens": torch.from_numpy(_tokens(lm.cfg, 1, 20))})
    assert all(n == 0 for n in kernels.launch_counts().values())


def test_lm_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        fa.flash_attention(q, q[:, :3], q[:, :3])
    with pytest.raises(ValueError, match="need x"):
        so.ssd(torch.zeros(1, 8, 2, 4), torch.zeros(1, 8, 3), torch.zeros(2),
               torch.zeros(1, 8, 3), torch.zeros(1, 8, 3))
    # the chunk scan's C B^T, L * C B^T, dt x, C^T, B^T (then 8 heads' dt and
    # cum), the padded state, and the next head's x and state
    assert so.smem_bytes(64, 16, 64) == 4 * (2 * 64 * 64 + 64 * 64 + 2 * 16 * 64 + 16 * 68
                                             + 64 * 64 + 64 * 16)
    assert so.smem_bytes(64, 16, 128) <= so.MAX_SMEM < so.smem_bytes(64, 128, 128)


def test_new_modules_import_neither_jax_nor_the_reference():
    # a source grep over the slice's modules (test_torch_core imports every
    # module of the package in a subprocess and checks sys.modules)
    pkg = REPO / "src" / "repro_torch"
    files = [*(pkg / "models").glob("*.py"), *(pkg / "configs").glob("*.py"),
             *(pkg / "serving").glob("*.py"), pkg / "interop.py",
             *(pkg / "kernels" / "flash_attention").glob("*.py"),
             *(pkg / "kernels" / "ssd").glob("*.py"), REPO / "chip_smoke.py"]
    assert len(files) >= 25
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    for f in files:
        assert not pat.search(f.read_text()), f


# -- chip_smoke.py's LM phases rehearsed on the CPU -------------------------------------------


def test_chip_smoke_lm_phases_rehearse_on_the_cpu():
    worst = chip_smoke.lm_kernel_parity("cpu", attn_cases=[(1, 4, 2, 70, 32, True),
                                                          (1, 4, 1, 70, 80, False)],
                                        ssd_cases=[(1, 70, 3, 16, 8, 32)])
    assert set(worst) == set(chip_smoke.LM_KERNELS)
    _, tcfg = _cfg("jamba-v0.1-52b", capacity_factor=16.0)
    dvf = chip_smoke.decode_vs_forward("cpu", tcfg, prompt=16)
    assert dvf["delta_over_max"] <= chip_smoke.DECODE_TOL
    assert dvf["forward_launches"] == {"flash_attention": 0, "ssd": 0}  # plain on the CPU
    cfg = configs.smoke(configs.get_config("jamba-v0.1-52b"))  # bf16, as phase 11
    srv = chip_smoke.serve("cpu", cfg, batch=2, prompt=48, repeats=1, max_len=64,
                           serve_prompt=5, steps=6, join_at=2)
    assert srv["output_lengths"] == [7, 7, 7, 5] and srv["logits_finite"]
    # the shape the prefill gives K8: the smoke's 4 / 4 heads padded to 16 / 16
    assert srv["kernels"]["flash_attention"]["shape"] == [2, 16, 16, 48, 32]
    assert srv["kernels"]["flash_attention"]["design"] == "mma.sync bf16"
    assert srv["kernels"]["ssd"]["shape"] == [2, 48, 8, 32, 16]
    assert srv["kernels"]["ssd"]["library_ms"] is None
    assert srv["kernels"]["ssd"]["design_bound_ms"] > srv["kernels"]["ssd"]["bound_ms"]
    assert (srv["kernels"]["ssd"]["chunk"], srv["kernels"]["ssd_chunk128"]["chunk"]) == (64, 128)
    full = chip_smoke.lm_config()
    assert (full.n_layers, full.d_model, full.n_experts, full.dtype) == (8, 4096, 16, "bfloat16")


def test_chip_smoke_lm_bounds():
    # K8 at Jamba's layer in bf16: 4 D contraction operations per unmasked
    # pair over the bf16 tensor-core peak, 4 softmax operations over the
    # fp32 peak; the bytes are far below, and SDPA's 0.30 ms is above it
    ms, by = chip_smoke.attention_bound(4, 32, 8, 2048, 128, True, 2)
    pairs = 2048 * 2049 // 2
    assert by == "operations"
    assert ms == pytest.approx(4 * 32 * pairs * (512 / 989e12 + 4 / 67e12) * 1e3)
    assert 0.15 < ms < 0.16
    # in fp32, or bf16 priced off the tensor cores: all (4 D + 4) over the fp32 peak
    fp32 = 4 * 32 * pairs * 516 / 67e12 * 1e3
    assert chip_smoke.attention_bound(4, 32, 8, 2048, 128, True, 4)[0] == pytest.approx(fp32)
    assert chip_smoke.attention_bound(4, 32, 8, 2048, 128, True, 2,
                                      tensor_cores=False)[0] == pytest.approx(fp32)
    assert 2.0 < fp32 < 2.1
    ms, by = chip_smoke.attention_bound(1, 1, 1, 4, 8, False, 4)
    assert by == "bytes" and ms == pytest.approx(4 * 4 * 4 * 8 / 3.35e12 * 1e3)  # 4 tensors
    # K9 at Jamba's layer, chunk 64, bf16: the bytes bound it (x and y
    # 2 bytes each, B and C in bf16, dt and the state in fp32)
    ms, by = chip_smoke.ssd_bound(4, 2048, 128, 64, 16, 64, 2)
    nbytes = 2 * (2 * 4 * 2048 * 128 * 64 + 2 * 4 * 2048 * 16) + 4 * (4 * 2048 * 128 + 128
                                                                    + 4 * 128 * 64 * 16)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    # priced off the tensor cores the operations bound it; a longer chunk does more
    ms, by = chip_smoke.ssd_bound(4, 2048, 128, 64, 16, 64, 2, tensor_cores=False)
    assert by == "operations" and 0.12 < ms < 0.14
    assert chip_smoke.ssd_bound(4, 2048, 128, 64, 16, 128, 2, tensor_cores=False)[0] > ms
    # a ragged tail chunk counts only its rows
    ms1, _ = chip_smoke.ssd_bound(1, 65, 1, 1, 1, 64, 4)
    ms2, _ = chip_smoke.ssd_bound(1, 64, 1, 1, 1, 64, 4)
    assert ms1 > ms2
    # the design's bound adds the chunk states (67 MB at chunk 64) written,
    # read, rewritten and read, their decays, and a second read of x, B and dt
    one, _ = chip_smoke.ssd_bound(4, 2048, 128, 64, 16, 64, 2)
    states = chip_smoke.ssd_states_bytes(4, 2048, 128, 64, 16, 64)
    assert states == 4 * 4 * 32 * 128 * 64 * 16
    ms, by = chip_smoke.ssd_bound(4, 2048, 128, 64, 16, 64, 2, design=True)
    extra = 4 * states + 8 * 4 * 32 * 128 + 2 * (4 * 2048 * 128 * 64 + 4 * 2048 * 16) + 4 * 4 * 2048 * 128
    assert by == "bytes" and ms == pytest.approx(one + extra / 3.35e12 * 1e3) and ms > one


@pytest.mark.parametrize("name,disturbed", [("jamba-v0.1-52b", True), ("phi3-mini-3.8b", False)])
def test_a_joining_request_disturbs_running_ssm_slots(name, disturbed):
    # Documents a fault the port shares with the reference (ROADMAP C; the
    # engines give equal tokens, test_serve_engine_gives_the_reference_greedy_tokens):
    # add_request feeds its prompt through decode steps of every slot, which
    # advances the other slots' Mamba states (attention rows are rewritten
    # at the same position, so an attention-only model is not disturbed).
    _, tcfg = _cfg(name)
    lm = LM(tcfg, seed=0, device="cpu")

    def slot0(join):
        eng = ServeEngine(lm, max_len=32, batch_slots=2, device="cpu")
        eng.add_request(0, [5, 17, 300, 42])
        for i in range(6):
            if join and i == 2:
                eng.add_request(1, [7, 8, 9])
            eng.step()
        return eng.finish(0)

    alone, joined = slot0(False), slot0(True)
    assert alone[:3] == joined[:3]
    assert (alone != joined) == disturbed
