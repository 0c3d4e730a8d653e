"""The port's kernel wrappers (K1-K4, K7) on the CPU, held against the reference's
Pallas kernels run in interpret mode on the same numpy inputs.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version; these
tests pin that version to the reference (Gram 2e-5; K_nM contractions 1e-4
of the largest output; bf16 3e-2) for all five kernel families, vector and
panel inputs. The CUDA kernels themselves are compared with these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.falkon_matvec import ops as jax_fo
from repro.kernels.falkon_matvec.ref import falkon_matvec_masked_ref as jax_masked_ref
from repro.kernels.gram import ops as jax_go
from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels import falkon_matvec_ops as fo
from repro_torch.kernels import gram_ops as go
from repro_torch.kernels.common import is_cpu, pad_dim, require_cuda, round_up

FAMILIES = ["gaussian", "laplacian", "linear", "matern32", "cauchy"]
SIGMA = 1.7


def _inputs(n=193, m=45, d=7, k=3, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((n, d)).astype(f), rng.standard_normal((m, d)).astype(f),
            rng.standard_normal((m, k)).astype(f), rng.standard_normal((n, k)).astype(f))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", FAMILIES)
def test_gram_matches_reference_kernel(kind, bf16):
    x, z, _, _ = _inputs()
    ref = np.asarray(jax_go.gram(jnp.asarray(x), jnp.asarray(z), SIGMA, kind=kind,
                                 interpret=True, bf16=bf16))
    out = go.gram(_t(x), _t(z), SIGMA, kind=kind, bf16=bf16).numpy()
    assert out.shape == ref.shape == (x.shape[0], z.shape[0])
    tol = 3e-2 * max(np.abs(ref).max(), 1.0) if bf16 else 2e-5 * max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("panel", [False, True])
@pytest.mark.parametrize("kind", FAMILIES)
def test_knm_contractions_match_reference_kernels(kind, panel):
    x, z, v, y = _inputs()
    if not panel:
        v, y = v[:, 0], y[:, 0]
    jx, jz, jv, jy = map(jnp.asarray, (x, z, v, y))
    pairs = [
        (jax_fo.falkon_matvec(jx, jz, jv, SIGMA, kind=kind, interpret=True),
         fo.falkon_matvec(_t(x), _t(z), _t(v), SIGMA, kind=kind)),
        (jax_fo.knm_t(jx, jz, jy, SIGMA, kind=kind, interpret=True),
         fo.knm_t(_t(x), _t(z), _t(y), SIGMA, kind=kind)),
        (jax_fo.knm_matvec(jx, jz, jv, SIGMA, kind=kind, interpret=True),
         fo.knm_matvec(_t(x), _t(z), _t(v), SIGMA, kind=kind)),
    ]
    for ref, out in pairs:
        ref = np.asarray(ref)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("kind", ["gaussian", "linear"])
def test_bf16_contractions_match_reference_kernels(kind):
    x, z, v, y = _inputs(seed=1)
    jx, jz, jv, jy = map(jnp.asarray, (x, z, v, y))
    pairs = [
        (jax_fo.falkon_matvec(jx, jz, jv, SIGMA, kind=kind, interpret=True, bf16=True),
         fo.falkon_matvec(_t(x), _t(z), _t(v), SIGMA, kind=kind, bf16=True)),
        (jax_fo.knm_t(jx, jz, jy, SIGMA, kind=kind, interpret=True, bf16=True),
         fo.knm_t(_t(x), _t(z), _t(y), SIGMA, kind=kind, bf16=True)),
        (jax_fo.knm_matvec(jx, jz, jv, SIGMA, kind=kind, interpret=True, bf16=True),
         fo.knm_matvec(_t(x), _t(z), _t(v), SIGMA, kind=kind, bf16=True)),
    ]
    for ref, out in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=3e-2 * np.abs(ref).max())


def _mask_case(case, n=193, k=3, seed=1):
    """(mask, vector v?) for K7: a 0/1 vector with a vector v, a 0/1 panel, an
    (n,) mask broadcast to the panel, or fractional panel weights."""
    rng = np.random.default_rng(seed)
    shape = (n,) if case in ("vec", "broadcast") else (n, k)
    mask = rng.random(shape) if case == "fractional" else rng.random(shape) > 0.3
    return mask.astype(np.float32), case == "vec"


@pytest.mark.parametrize("case", ["vec", "panel", "broadcast", "fractional"])
@pytest.mark.parametrize("kind", FAMILIES)
def test_masked_contraction_matches_reference_kernel(kind, case):
    # K7's plain version against the Pallas K7 in interpret mode and the
    # reference's plain masked matvec, on the same inputs.
    x, z, v, _ = _inputs()
    mask, vector = _mask_case(case)
    if vector:
        v = v[:, 0]
    pallas = np.asarray(jax_fo.falkon_matvec(jnp.asarray(x), jnp.asarray(z), jnp.asarray(v), SIGMA,
                                             kind=kind, interpret=True, mask=jnp.asarray(mask)))
    full = np.broadcast_to(mask[:, None], (x.shape[0], v.shape[1])) if case == "broadcast" else mask
    inv_scale = fo._inv_scale(kind, SIGMA)
    plain = np.asarray(jax_masked_ref(jnp.asarray(x), jnp.asarray(z), jnp.asarray(v),
                                      jnp.asarray(full), inv_scale, kind=kind))
    out = fo.falkon_matvec(_t(x), _t(z), _t(v), SIGMA, kind=kind, mask=_t(mask))
    direct = fo.falkon_matvec_masked_reference(_t(x), _t(z), _t(v), _t(mask), SIGMA, kind=kind)
    for ref in (pallas, plain):
        assert out.shape == ref.shape == v.shape[:0] + (z.shape[0],) + v.shape[1:]
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    assert torch.equal(out, direct)


@pytest.mark.parametrize("vector", [True, False])
def test_masked_wrapper_all_ones_is_bit_identical_and_zeros_give_zero(vector):
    x, z, v, _ = map(_t, _inputs(seed=2))
    if vector:
        v = v[:, 0]
    rows = (x.shape[0],) + tuple(v.shape[1:])
    for bf16 in (False, True):
        plain = fo.falkon_matvec(x, z, v, SIGMA, bf16=bf16)
        assert torch.equal(fo.falkon_matvec(x, z, v, SIGMA, bf16=bf16, mask=torch.ones(rows)), plain)
        zeros = fo.falkon_matvec(x, z, v, SIGMA, bf16=bf16, mask=torch.zeros(rows))
        assert zeros.shape == plain.shape and torch.count_nonzero(zeros) == 0
    with pytest.raises(ValueError, match="mask must be"):
        fo.falkon_matvec(x, z, v, mask=torch.ones((x.shape[0] - 1,) + tuple(v.shape[1:])))


def test_masked_bf16_matches_reference_kernel():
    x, z, v, _ = _inputs(seed=3)
    mask, _ = _mask_case("panel", seed=4)
    ref = np.asarray(jax_fo.falkon_matvec(jnp.asarray(x), jnp.asarray(z), jnp.asarray(v), SIGMA,
                                          interpret=True, bf16=True, mask=jnp.asarray(mask)))
    out = fo.falkon_matvec(_t(x), _t(z), _t(v), SIGMA, bf16=True, mask=_t(mask)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=3e-2 * np.abs(ref).max())


def test_bf16_rounds_only_the_cross_term():
    # Values that bf16 cannot hold: the fp32 and bf16 Gram blocks must differ,
    # and the bf16 one must equal the fp32 formula on rounded cross-term operands.
    x = torch.tensor([[1.0 + 2.0**-12, 0.5]])
    z = torch.tensor([[1.0, 0.25 + 2.0**-14]])
    a = go.gram(x, z, 1.0, kind="linear")
    b = go.gram(x, z, 1.0, kind="linear", bf16=True)
    assert float(a) != float(b)
    assert float(b) == float(x.bfloat16().float() @ z.bfloat16().float().T)


def test_row_blocked_plain_versions_match_unblocked():
    x, z, v, y = map(_t, _inputs(n=300))
    s = 0.3
    from repro_torch.kernels.falkon_matvec.ref import falkon_matvec_ref, knm_matvec_ref, knm_t_ref
    for fn, arg in ((falkon_matvec_ref, v), (knm_t_ref, y), (knm_matvec_ref, v)):
        full = fn(x, z, arg, s, block=10_000)
        blocked = fn(x, z, arg, s, block=64)
        torch.testing.assert_close(blocked, full, rtol=0, atol=1e-5 * float(full.abs().max()))
    from repro_torch.kernels.falkon_matvec.ref import falkon_matvec_masked_ref
    mask = _t(_mask_case("fractional", n=300)[0])
    full = falkon_matvec_masked_ref(x, z, v, mask, s, block=10_000)
    blocked = falkon_matvec_masked_ref(x, z, v, mask, s, block=64)
    torch.testing.assert_close(blocked, full, rtol=0, atol=1e-5 * float(full.abs().max()))


def test_empty_inputs_give_empty_or_zero_outputs():
    x, z, v, y = map(_t, _inputs())
    assert fo.knm_matvec(x[:0], z, v).shape == (0, 3)
    assert torch.count_nonzero(fo.knm_t(x[:0], z, y[:0])) == 0
    assert fo.knm_t(x[:0], z, y[:0]).shape == (z.shape[0], 3)


def test_cpu_path_counts_no_launches():
    x, z, v, y = map(_t, _inputs())
    kernels.reset_launch_counts()
    go.gram(x, z)
    fo.falkon_matvec(x, z, v)
    fo.falkon_matvec(x, z, v, mask=torch.ones(x.shape[0]))
    fo.knm_t(x, z, y)
    fo.knm_matvec(x, z, v)
    w = torch.eye(z.shape[0])
    kernels.rls_score_ops.rls_score(x, z, w, torch.ones(z.shape[0], dtype=torch.bool), 1.0)
    kernels.quadform_ops.quadform(go.gram(x, z), w)
    q = torch.randn(1, 4, 9, 8)
    kernels.flash_attention_ops.flash_attention(q, q[:, :2], q[:, :2])
    kernels.ssd_ops.ssd(torch.randn(1, 9, 2, 4), torch.rand(1, 9, 2), -torch.rand(2),
                        torch.randn(1, 9, 3), torch.randn(1, 9, 3), chunk=4)
    assert kernels.launch_counts() == {"gram": 0, "falkon_matvec": 0, "falkon_matvec_masked": 0,
                                       "knm_t": 0, "knm_matvec": 0, "rls_score": 0,
                                       "quadform": 0, "flash_attention": 0, "ssd": 0}


def test_wrappers_refuse_mixed_or_unsupported_devices():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="share one device"):
        is_cpu(x, torch.zeros(4, 3, device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        require_cuda(x, "x")
    with pytest.raises(ValueError, match="feature dims"):
        go.gram(x, torch.zeros(2, 5))


def test_family_without_cuda_epilogue_is_refused_by_name():
    from repro_torch.families import KernelFamily, _FAMILY_REGISTRY, register_kernel_family

    register_kernel_family(KernelFamily(name="_test_poly", inv_scale=lambda s: 1.0,
                                        epilogue=lambda p, s: (1.0 + p) ** 2, dot_only=True,
                                        unit_diag=False))
    try:
        with pytest.raises(NotImplementedError, match="_test_poly"):
            go.cuda_family_id("_test_poly")
        out = go.gram(torch.ones(2, 3), torch.ones(4, 3), kind="_test_poly")  # plain path runs
        assert torch.all(out == 16.0)
    finally:
        _FAMILY_REGISTRY.pop("_test_poly")


@pytest.mark.parametrize("n,m", [(0, 5), (1, 1), (64, 64), (70_001, 1_000),
                                 (1_000_000, 10_000), (5_000_000, 3)])
def test_row_chunks_cover_every_row_once(n, m):
    n_chunks, chunk_rows = fo.row_chunks(n, m)
    assert chunk_rows % fo.TILE == 0 and 1 <= n_chunks <= 65535
    assert (n_chunks - 1) * chunk_rows < max(n, 1) <= n_chunks * chunk_rows
    assert fo.row_chunks(n, m) == (n_chunks, chunk_rows)  # a fixed split: fixed sum order


def test_common_helpers():
    assert round_up(70_001, 64) == 70_016 and round_up(64, 64) == 64
    t = pad_dim(torch.ones(3, 2), 0, 5)
    assert t.shape == (5, 2) and float(t[3:].abs().sum()) == 0.0
    assert pad_dim(t, 1, 1) is t


def test_build_is_lazy_and_goes_to_an_ignored_directory():
    # Importing the package compiled nothing; the one cpp_extension.load call
    # builds every source into a directory git ignores.
    assert build._EXT is None
    assert build.build_dir().parts[-2:] == ("build", "repro_torch_kernels")
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.CUDA_FLAGS
    flags = build.CUDA_FLAGS + build.CXX_FLAGS
    assert not any("fast_math" in f or "fast-math" in f for f in flags)
    pkg = build.CSRC.parent
    assert all((pkg / src).is_file() for src in build.SOURCES)
    assert sorted(p.relative_to(pkg).as_posix() for p in pkg.rglob("*.cu")) == sorted(
        s for s in build.SOURCES if s.endswith(".cu"))
    gitignore = (build.build_dir().parents[1] / ".gitignore").read_text().splitlines()
    assert "build/repro_torch_kernels/" in gitignore


def _launchers():
    header = (build.CSRC / "launchers.h").read_text()
    return re.findall(r"^void (launch_\w+)\(", header, flags=re.M)


def test_every_launcher_is_defined_against_its_declaration():
    # The .cu sources define each launcher of launchers.h by its qualified
    # name (a drifted signature then fails to compile) and include no
    # PyTorch header; only binding.cpp does.
    names = _launchers()
    assert names == ["launch_gram", "launch_gram_wide", "launch_falkon_matvec_fused",
                     "launch_row_norms",
                     "launch_reduce_partials_blocked", "launch_knm_matvec",
                     "launch_knm_matvec_masked", "launch_knm_t_reg", "launch_knm_t_partial",
                     "launch_reduce_partials", "launch_rls_score_partial",
                     "launch_rls_score_finish", "launch_quadform_partial",
                     "launch_flash_attention", "launch_ssd_chunk_state",
                     "launch_ssd_state_passing", "launch_ssd_chunk_scan"]
    pkg = build.CSRC.parent
    cu = {s: (pkg / s).read_text() for s in build.SOURCES if s.endswith(".cu")}
    for name in names:
        defined = [s for s, text in cu.items() if f"void repro::{name}(" in text]
        assert len(defined) == 1, (name, defined)
    for text in cu.values():
        assert '#include "launchers.h"' in text and "torch/" not in text
    assert "#include <torch/extension.h>" in (build.CSRC / "binding.cpp").read_text()


def test_binding_checks_every_launch():
    # Each launcher call in binding.cpp is followed by C10_CUDA_KERNEL_LAUNCH_CHECK
    # before the next statement that launches or returns.
    text = (build.CSRC / "binding.cpp").read_text()
    calls = [m.end() for m in re.finditer(r"repro::launch_\w+\(", text)]
    assert len(calls) >= len(_launchers())
    for end in calls:
        stmt_end = text.index(";", end)
        after = text[stmt_end + 1:].lstrip()
        assert after.startswith("C10_CUDA_KERNEL_LAUNCH_CHECK();"), text[end - 40:stmt_end + 60]
    for name in ("gram", "knm_matvec", "knm_t", "falkon_matvec_fused", "falkon_matvec",
                 "rls_score", "quadform", "flash_attention", "ssd"):
        assert f'm.def("{name}", &{name}' in text
    # K2's and K7's two-stage binding checks the mask, then runs K4's launches
    # (stage 1, the mask multiplying it) and K3's (stage 2)
    body = text[text.index("void falkon_matvec("):text.index("// K5:")]
    assert 'check(*mask, "mask")' in body and "TORCH_CHECK(mask->dim() == 2" in body
    assert "repro::launch_" not in body
    assert body.index("knm_matvec_launches(") < body.index("knm_t_launches(")
    # K4: the tiled route's kernel (masked or not), or the register route's
    # norms of z, K3's register kernel on (z, x) and, over several center
    # chunks, the blocked sum that applies the mask
    body = text[text.index("void knm_matvec_launches("):text.index("}  // namespace")]
    assert [m.group(0) for m in re.finditer(r"repro::launch_\w+", body)] == [
        "repro::launch_knm_matvec_masked", "repro::launch_knm_matvec", "repro::launch_row_norms",
        "repro::launch_knm_t_reg", "repro::launch_reduce_partials_blocked"]
    assert "repro::launch_knm_t_reg(z.data_ptr<float>(), x.data_ptr<float>()" in body
    assert "split ? nullptr : mask" in body and "TORCH_CHECK(d >= 1 && d <= 32" in body
    # K1: the tiled route's kernel, or the rows' norms of x and z and the wide kernel
    body = text[text.index("void gram("):text.index("// K4: out")]
    assert [m.group(0) for m in re.finditer(r"repro::launch_\w+", body)] == [
        "repro::launch_gram", "repro::launch_row_norms", "repro::launch_row_norms",
        "repro::launch_gram_wide"]
    assert "TORCH_CHECK(!vec || m % 4 == 0" in body and "gram_wide_smem_floats(" in body
    # the cluster route (K2, or K7 with a mask) checks the mask and the plan,
    # then runs the fused kernel and the fixed-order sum of its row chunks
    body = text[text.index("void falkon_matvec_fused("):text.index("// K2 (mask None) or K7 on the two-stage")]
    assert 'check(*mask, "mask")' in body and "TORCH_CHECK(mask->dim() == 2" in body
    assert "falkon_fused_smem_floats(" in body and "232448" in body
    assert [m.group(0) for m in re.finditer(r"repro::launch_\w+", body)] == [
        "repro::launch_row_norms", "repro::launch_falkon_matvec_fused",
        "repro::launch_reduce_partials_blocked"]
    # K5: the fused kernel, then the ordered sum of its column tiles and the epilogue
    body = text[text.index("void rls_score("):text.index("// K6:")]
    assert [m.group(0) for m in re.finditer(r"repro::launch_\w+", body)] == [
        "repro::launch_rls_score_partial", "repro::launch_rls_score_finish"]
    # K3 (and the two-stage route's second stage): the tiled route's kernel and
    # ordered sum, or the register route's row norms, kernel and blocked sum
    body = text[text.index("void knm_t_launches("):text.index("void knm_matvec_launches(")]
    assert [m.group(0) for m in re.finditer(r"repro::launch_\w+", body)] == [
        "repro::launch_knm_t_partial", "repro::launch_reduce_partials", "repro::launch_row_norms",
        "repro::launch_knm_t_reg", "repro::launch_reduce_partials_blocked"]
    assert "TORCH_CHECK(d >= 1 && d <= 32" in body
    # K9: the chunk states, the state passing, the chunk scan
    body = text[text.index("void ssd("):text.index("PYBIND11_MODULE")]
    assert [m.group(0) for m in re.finditer(r"repro::launch_\w+", body)] == [
        "repro::launch_ssd_chunk_state", "repro::launch_ssd_state_passing",
        "repro::launch_ssd_chunk_scan"]
    assert "ssd_smem_floats(" in body and "232448" in body


def test_masked_stage_one_is_the_templated_k4_kernel():
    # K7's mask multiply lives in the hand-written kernels. On the cluster
    # route one fused kernel templated on MASKED serves K2 (false) and K7
    # (true), the mask multiplying T between the two contractions; on the
    # two-stage route stage 1 is K4's: at d above 32 its tiled kernel
    # templated on MASKED (instantiated unmasked for K2/K4), at d <= 32 its
    # register route, which takes the mask as a pointer
    # (test_knm_matvec_register_route_keeps_g_in_registers).
    text = (build.CSRC.parent / "falkon_matvec" / "falkon_matvec.cu").read_text()
    fused = _kernel_body(text, "falkon_matvec_fused_kernel")
    assert "template <bool MASKED, int NC>\n__global__" in text
    assert "if constexpr (MASKED) t *= mcur;" in fused  # T times the tile's mask rows
    assert fused.count("mask[") == 1  # the mask's one read, a tile ahead of step E
    launcher = text[text.index("void repro::launch_falkon_matvec_fused("):]
    assert "launch_fused_kc<true>(" in launcher and "launch_fused_kc<false>(" in launcher
    assert "mask != nullptr" in launcher
    assert "template <bool MASKED>" in text
    assert "knm_matvec_kernel<false><<<" in text and "knm_matvec_kernel<true><<<" in text
    assert "MASKED ? acc[q] * mask[o] : acc[q]" in text


def test_fused_matvec_builds_each_gram_value_once_per_tile():
    # Steps C-F of the fused kernel: one register-tile build per pass, the
    # cluster's partials read through distributed shared memory after one
    # split cluster barrier, the slice's G^T T from shared memory. No float
    # atomics anywhere in the file.
    text = (build.CSRC.parent / "falkon_matvec" / "falkon_matvec.cu").read_text()
    fused = _kernel_body(text, "falkon_matvec_fused_kernel")
    assert fused.count("tile_epilogue(") == 1 and "gram_tile(" not in fused
    assert "map_shared_rank(" in fused and "cluster_arrive();" in fused
    assert "cluster_wait();" in fused and "cluster.sync();" in fused
    assert "barrier.cluster.arrive.release" in text and "barrier.cluster.wait.acquire" in text
    assert "atomicAdd" not in text and ".tf32" not in text
    assert "cudaOccupancyMaxActiveClusters" in text
    assert "cudaLaunchAttributeClusterDimension" in text


def _constant(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_matvec_plan_mirrors_the_kernel_layout():
    # The plan's constants are the kernel's, and its shared-memory count is
    # fused_layout's total (term by term: a slice column's Gram column, z row,
    # norm, V row and accumulator; two tiles' x feature-major and their norms;
    # the T shares of 16 warps, the partials of up to 8 blocks double-buffered,
    # and T).
    text = (build.CSRC.parent / "falkon_matvec" / "falkon_matvec.cu").read_text()
    assert _constant(text, "FR") == fo.FUSED_ROWS
    assert _constant(text, "FPASS") == fo.FUSED_SLICE_STEP
    nj = _constant(text, "FNJ")
    assert fo.FUSED_SLICE_STEP // (8 * nj) == fo.FUSED_WARPS  # FWARPS
    assert _constant(text, "FDMAX") == fo.FUSED_DMAX
    layout = text[text.index("inline FusedLayout fused_layout("):]
    layout = layout[:layout.index("return l;")]
    assert "l.total = l.tfull + FR * nc;" in layout
    for sw, d, nc in ((256, 1, 1), (1280, 18, 1), (768, 18, 8), (1024, 64, 4)):
        want = (16 * sw + d * sw + sw + nc * sw + nc * sw + 2 * d * 16 + 2 * 16
                + 16 * 16 * nc + 2 * 8 * 16 * nc + 16 * nc)
        assert fo.fused_smem_floats(sw, d, nc) == want


@pytest.mark.parametrize("n,m,d,k", [(10 ** 6, 10 ** 4, 18, 1), (10 ** 6, 2978, 18, 5),
                                     (70_001, 1_000, 18, 40), (0, 5, 3, 1), (1, 1, 1, 1),
                                     (65_536, 2_048, 18, 4), (10 ** 6, 12_288, 18, 1)])
def test_matvec_plan_takes_the_cluster_route_within_its_reach(n, m, d, k):
    plan = fo.matvec_plan(n, m, d, k)
    assert plan == fo.matvec_plan(n, m, d, k)  # a pure function of the shape
    assert plan.route == "cluster" and plan.cluster in fo.FUSED_CLUSTERS
    assert plan.kc in fo.FUSED_KC and plan.kc >= min(k, 8)
    sw = plan.slice_cols
    assert sw % fo.FUSED_SLICE_STEP == 0 and (plan.cluster - 1) * sw < m <= plan.cluster * sw
    assert 4 * fo.fused_smem_floats(sw, d, plan.kc) <= fo.SMEM_BYTES
    # the fewest blocks per cluster that fit
    smaller = [c for c in fo.FUSED_CLUSTERS if c < plan.cluster]
    for c in smaller:
        s2 = fo.round_up(-(-m // c), fo.FUSED_SLICE_STEP)
        assert (c - 1) * s2 >= m or 4 * fo.fused_smem_floats(s2, d, plan.kc) > fo.SMEM_BYTES
    # row chunks of whole 16-row tiles cover every row once, at most 1024 of them
    assert plan.chunk_rows % fo.FUSED_ROWS == 0 and 1 <= plan.n_chunks <= fo.FUSED_MAX_CHUNKS
    assert (plan.n_chunks - 1) * plan.chunk_rows < max(n, 1) <= plan.n_chunks * plan.chunk_rows


def test_matvec_plan_main_path_shapes():
    # K2 on the uniform SUSY-scale fit and K7 on the CV sweep's BLESS centers
    assert fo.matvec_plan(10 ** 6, 10 ** 4, 18, 1)[:4] == ("cluster", 8, 1280, 1)
    assert fo.matvec_plan(10 ** 6, 2978, 18, 5)[:4] == ("cluster", 4, 768, 5)


@pytest.mark.parametrize("n,m,d,k", [(10 ** 6, 12_289, 18, 1), (10 ** 6, 16_384, 18, 1),
                                     (10 ** 6, 10 ** 5, 18, 5), (5_000, 100, 65, 1),
                                     (100, 8_000, 64, 40)])
def test_matvec_plan_takes_the_two_stage_route_above_the_cap(n, m, d, k):
    plan = fo.matvec_plan(n, m, d, k)
    assert plan.route == "two-stage" and plan == fo.matvec_plan(n, m, d, k)
    # its second stage is K3, so its column and row chunks are K3's plan's
    stage2 = fo.knm_t_plan(n, m, d, k)
    assert (plan.kc, plan.n_chunks, plan.chunk_rows) == (stage2.kc,) + stage2[4:]


@pytest.mark.parametrize("n,m,d,k", [(10 ** 6, 10 ** 4, 18, 1), (10 ** 6, 2978, 18, 5),
                                     (10 ** 6, 16_384, 18, 1), (10 ** 6, 10 ** 5, 18, 5),
                                     (70_001, 1_000, 18, 40), (0, 5, 3, 1), (1, 1, 1, 1),
                                     (3_001, 1_023, 32, 9), (5 * 10 ** 6, 3, 7, 2)])
def test_knm_t_plan_covers_every_row_and_center_once(n, m, d, k):
    plan = fo.knm_t_plan(n, m, d, k)
    assert plan == fo.knm_t_plan(n, m, d, k)  # a pure function of the shape
    assert plan.route == "register" and plan.kc in fo.FUSED_KC and plan.kc >= min(k, 8)
    # row chunks of whole 64-row tiles cover every row once, none too long
    assert plan.chunk_rows % fo.KT_ROWS == 0 and plan.chunk_rows <= fo.KT_MAX_CHUNK_ROWS
    assert (plan.n_chunks - 1) * plan.chunk_rows < max(n, 1) <= plan.n_chunks * plan.chunk_rows
    assert 1 <= plan.n_chunks <= 65535
    # 512-center slices and column chunks cover every center and column once
    slices, col_chunks = -(-m // plan.slice_cols), -(-k // plan.kc)
    assert (slices - 1) * plan.slice_cols < m <= slices * plan.slice_cols
    assert (col_chunks - 1) * plan.kc < k <= col_chunks * plan.kc
    assert 4 * fo.knm_t_smem_floats(d, plan.kc) <= fo.SMEM_BYTES
    # about TARGET_BLOCKS blocks (whole tiles per chunk round it down a
    # little), a few waves of 132 SMs, where the rows allow it
    tiles = -(-max(n, 1) // fo.KT_ROWS)
    blocks = slices * col_chunks * plan.n_chunks
    assert blocks >= min(3 * fo.TARGET_BLOCKS // 4, tiles * slices * col_chunks)


def test_knm_t_plan_main_path_shapes():
    # the uniform SUSY-scale fit's right-hand side, the CV sweep's 5 folds,
    # the classifier's 2 columns, and the two-stage route's second stage
    assert fo.knm_t_plan(10 ** 6, 10 ** 4, 18, 1) == fo.KnmTPlan("register", 512, 64, 1, 103, 9728)
    assert fo.knm_t_plan(10 ** 6, 2978, 18, 5)[:4] == ("register", 512, 64, 5)
    assert fo.knm_t_plan(10 ** 6, 10 ** 4, 18, 2).kc == 2
    assert fo.knm_t_plan(10 ** 6, 16_384, 18, 1)[4:] == (64, 15_680)


@pytest.mark.parametrize("n,m,d,k", [(5_000, 100, 33, 1), (10 ** 6, 10 ** 4, 40, 5), (64, 1, 200, 1)])
def test_knm_t_plan_takes_the_tiled_route_above_d_32(n, m, d, k):
    plan = fo.knm_t_plan(n, m, d, k)
    assert plan.route == "tiled" and plan.kc == 0
    assert (plan.n_chunks, plan.chunk_rows) == fo.row_chunks(n, m)


def test_knm_t_register_kernel_keeps_g_in_registers():
    # The plan's constants are the kernel's; its shared memory holds the
    # staged x, norms and Y tiles only (knm_t_layout, term by term): the Gram
    # values go from the family epilogue straight into the contraction.
    text = (build.CSRC.parent / "falkon_matvec" / "falkon_matvec.cu").read_text()
    assert _constant(text, "KT_THREADS") * _constant(text, "KT_NJ") == fo.KT_SLICE
    assert _constant(text, "KT_ROWS") == fo.KT_ROWS and _constant(text, "KT_DMAX") == fo.KT_DMAX
    layout = text[text.index("inline KnmTLayout knm_t_layout("):]
    assert "l.total = l.ys + 2 * nc * KT_ROWS;" in layout[:layout.index("return l;")]
    for d, nc in ((1, 1), (18, 1), (32, 8)):
        assert fo.knm_t_smem_floats(d, nc) == 2 * d * (64 + 4) + 2 * 64 + 2 * nc * 64
    kernel = _kernel_body(text, "knm_t_reg_kernel")
    assert kernel.count("tile_epilogue(fam, g, xni, zn, s);") == 1 and "gram_tile(" not in kernel
    assert "cp_async4(" in kernel and "__shared__ TileSmem" not in kernel
    assert "acc[j][c] += t8;" in kernel and "atomicAdd" not in text
    launcher = text[text.index("void repro::launch_knm_t_reg("):]
    assert "launch_knm_t_reg_bf<true>(" in launcher and "launch_knm_t_reg_bf<false>(" in launcher


@pytest.mark.parametrize("n,m,d,k", [(10 ** 6, 10 ** 4, 18, 1), (10 ** 6, 2978, 18, 5),
                                     (10 ** 6, 16_384, 18, 1), (10 ** 6, 10 ** 5, 18, 5),
                                     (70_001, 1_000, 18, 40), (0, 5, 3, 1), (1, 1, 1, 1),
                                     (3_001, 1_023, 32, 9), (5 * 10 ** 6, 3, 7, 2)])
def test_knm_matvec_plan_covers_every_row_and_center_once(n, m, d, k):
    plan = fo.knm_matvec_plan(n, m, d, k)
    assert plan == fo.knm_matvec_plan(n, m, d, k)  # a pure function of the shape
    assert plan.route == "register" and plan.kc in fo.FUSED_KC and plan.kc >= min(k, 8)
    # center chunks of whole 64-center tiles cover every center once, none too long
    assert plan.cols == fo.KT_ROWS and plan.chunk_cols % fo.KT_ROWS == 0
    assert plan.chunk_cols <= fo.KT_MAX_CHUNK_ROWS and 1 <= plan.n_chunks <= 65535
    assert (plan.n_chunks - 1) * plan.chunk_cols < max(m, 1) <= plan.n_chunks * plan.chunk_cols
    # 512-row slices and column chunks cover every row and column once
    slices, col_chunks = -(-max(n, 1) // plan.slice_rows), -(-k // plan.kc)
    assert plan.slice_rows == fo.KT_SLICE
    assert (slices - 1) * plan.slice_rows < max(n, 1) <= slices * plan.slice_rows
    assert (col_chunks - 1) * plan.kc < k <= col_chunks * plan.kc
    # about TARGET_BLOCKS blocks where the centers allow it: no fewer than
    # half, and no more center chunks than needed to come nearest to it
    tiles = -(-max(m, 1) // fo.KT_ROWS)
    blocks = slices * col_chunks * plan.n_chunks
    assert blocks >= min(fo.TARGET_BLOCKS // 2, tiles * slices * col_chunks)
    if plan.n_chunks > -(-tiles // (fo.KT_MAX_CHUNK_ROWS // fo.KT_ROWS)):
        assert slices * col_chunks * (plan.n_chunks - 1) < fo.TARGET_BLOCKS


def test_knm_matvec_plan_main_path_shapes():
    # predict of the uniform fit's 10^5 test rows (split: 196 row slices
    # alone), the CV sweep's panel predict on 10^6 rows (the row slices
    # alone), the classifier's 2 columns, and the two-stage route's first
    # stage at 16 384 centers (one chunk)
    assert fo.knm_matvec_plan(10 ** 5, 10 ** 4, 18, 1) == fo.KnmMatvecPlan(
        "register", 512, 64, 1, 10, 1024)
    assert fo.knm_matvec_plan(10 ** 6, 2977, 18, 5) == fo.KnmMatvecPlan(
        "register", 512, 64, 5, 1, 3008)
    assert fo.knm_matvec_plan(10 ** 5, 2977, 18, 2)[:4] == ("register", 512, 64, 2)
    assert fo.knm_matvec_plan(10 ** 6, 16_384, 18, 1)[3:] == (1, 1, 16_384)
    # the GPU test of the all-ones mask on the two-stage route splits its centers
    assert fo.knm_matvec_plan(9_001, 12_289, 18, 1).n_chunks > 1


@pytest.mark.parametrize("n,m,d,k", [(5_000, 100, 33, 1), (10 ** 6, 10 ** 4, 40, 5), (64, 1, 200, 1)])
def test_knm_matvec_plan_takes_the_tiled_route_above_d_32(n, m, d, k):
    plan = fo.knm_matvec_plan(n, m, d, k)
    assert plan.route == "tiled" and plan.kc == 0 and plan.n_chunks == 1
    assert plan.chunk_cols >= m


def test_knm_matvec_register_route_keeps_g_in_registers():
    # K4's register route is K3's register kernel on the transposed problem
    # (x's rows its thread-owned side, the centers streamed): the binding
    # hands it (z, x), z's norms and the mask, and that kernel keeps no Gram
    # buffer in shared memory. The mask multiplies the whole sum once: in the
    # kernel's write or in the blocked reduce, never both.
    text = (build.CSRC.parent / "falkon_matvec" / "falkon_matvec.cu").read_text()
    kernel = _kernel_body(text, "knm_t_reg_kernel")
    assert "gs[" not in kernel and "TileSmem" not in kernel and "gram_tile(" not in kernel
    assert "__shared__" not in kernel.replace("extern __shared__ __align__(16) float dyn[];", "")
    assert "mask != nullptr ? acc[j][c] * mask[o + c] : acc[j][c]" in kernel
    reduce = text[text.index("void reduce_partials_blocked_kernel("):]
    assert "mask != nullptr ? total * mask[i] : total" in reduce[:reduce.index("\n}\n")]
    binding = (build.CSRC / "binding.cpp").read_text()
    body = binding[binding.index("void knm_matvec_launches("):binding.index("}  // namespace")]
    assert "repro::launch_row_norms(z.data_ptr<float>(), znorm.data_ptr<float>()" in body
    assert "znorm.data_ptr<float>(), split ? nullptr : mask, target, m, n, d, k" in body
    assert "repro::launch_reduce_partials_blocked(partial.data_ptr<float>(), mask," in body


def test_gram_wide_route_writes_16_byte_stores():
    # The plan's constants are the kernel's; each thread of the wide kernel
    # owns GW_CW = 4 consecutive columns of 16 rows and writes each row as one
    # float4 streaming store (4-byte streaming stores where m % 4 != 0); the
    # stripe and the tiles are staged by cp.async, and gram_tile is not used.
    text = (build.CSRC.parent / "gram" / "gram.cu").read_text()
    assert _constant(text, "GW_RW") * _constant(text, "GW_THREADS") // 32 == go.ROWS
    assert 32 * _constant(text, "GW_CW") == go.COLS and _constant(text, "GW_CW") == 4
    assert _constant(text, "GW_DMAX") == go.DMAX
    kernel = _kernel_body(text, "gram_wide_kernel")
    assert "__stcs(reinterpret_cast<float4*>(dst), make_float4(" in kernel
    assert "__stcs(dst + j, g[i][j])" in kernel and "if constexpr (VEC)" in kernel
    assert "cp_async4(" in kernel and "gram_tile(" not in kernel and "TileSmem" not in kernel
    assert kernel.count("tile_epilogue(fam, g, xni, znj, s);") == 1
    assert "fmaf(a[i], bv[j], g[i][j])" in kernel and "atomicAdd" not in text
    launcher = text[text.index("void repro::launch_gram_wide("):]
    for vec in ("true", "false"):
        for bf16 in ("true", "false"):
            assert f"launch_wide<{vec}, {bf16}>" in launcher
    layout = text[text.index("inline GramLayout gram_layout("):]
    assert "l.total = l.zn + 2 * GW_COLS;" in layout[:layout.index("return l;")]


@pytest.mark.parametrize("n,m,d", [(10 ** 4, 10 ** 4, 18), (26_843, 10 ** 4, 18), (1, 1, 1),
                                   (0, 4, 3), (5_003, 301, 18), (32_768, 2_560, 18),
                                   (10 ** 6, 9, 64), (7, 10 ** 7, 2)])
def test_gram_plan_covers_every_row_and_column_once(n, m, d):
    plan = go.gram_plan(n, m, d)
    assert plan == go.gram_plan(n, m, d)  # a pure function of the shape
    assert plan.route == ("wide" if m % 4 == 0 else "scalar")
    assert (plan.rows, plan.cols) == (go.ROWS, go.COLS)
    stripes, tiles = -(-max(n, 1) // plan.rows), -(-max(m, 1) // plan.cols)
    runs = -(-tiles // plan.run)
    assert 1 <= plan.run <= tiles and runs <= 65535
    assert (runs - 1) * plan.run < tiles <= runs * plan.run
    # about TARGET_BLOCKS blocks where the shape allows it
    blocks = stripes * runs
    assert blocks >= min(go.TARGET_BLOCKS // 2, stripes * tiles)
    if plan.run > 1 and runs < 65535:
        assert stripes * -(-tiles // (plan.run - 1)) > go.TARGET_BLOCKS // 2


def test_gram_plan_main_path_shapes():
    # K_MM at M = 10^4, the predictive variance's 1 GiB slab, a ladder level
    assert go.gram_plan(10 ** 4, 10 ** 4, 18) == go.GramPlan("wide", 128, 128, 2)
    assert go.gram_plan(26_843, 10 ** 4, 18) == go.GramPlan("wide", 128, 128, 5)
    assert go.gram_plan(10 ** 4, 2977, 18).route == "scalar"


@pytest.mark.parametrize("n,m,d", [(777, 130, 65), (10 ** 4, 10 ** 4, 200), (1, 1, 65)])
def test_gram_plan_takes_the_tiled_route_above_the_d_cap(n, m, d):
    assert go.DMAX == 64 and go.gram_plan(n, m, d).route == "tiled"


@pytest.mark.parametrize("k", [5, 9])
@pytest.mark.parametrize("kind", FAMILIES)
def test_knm_t_panels_match_reference_kernel(kind, k):
    # K3's plain version at the CV sweep's 5 columns and a 9-column panel
    # (two of the register route's 8-column chunks) against the Pallas K3
    x, z, _, y = _inputs(k=k, seed=5)
    ref = np.asarray(jax_fo.knm_t(jnp.asarray(x), jnp.asarray(z), jnp.asarray(y), SIGMA, kind=kind,
                                  interpret=True))
    out = fo.knm_t(_t(x), _t(z), _t(y), SIGMA, kind=kind).numpy()
    assert out.shape == ref.shape == (z.shape[0], k)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_rls_score_tile_matches_the_wrapper_and_bf16_is_a_template_parameter():
    # K5's partial buffer is (max(1, ceil(M / TILE)), R): the wrapper's TILE
    # must be the kernel's W column tile. The G W loop of the fp32 kernel
    # carries no bf16 branch; the slab is built in registers, not by gram_tile.
    from repro_torch.kernels import rls_score_ops as ro

    text = (build.CSRC.parent / "rls_score" / "rls_score.cu").read_text()
    assert _constant(text, "SN") == ro.TILE
    assert "template <bool BF16, bool VEC>" in text
    kernel = _kernel_body(text, "rls_score_partial_kernel")
    signature = kernel[:kernel.index("{")]
    assert "bf16" not in signature.lower() and "if (BF16)" in kernel and "if (bf16)" not in kernel
    assert "tile_epilogue(fam, g," in kernel and "gram_tile(" not in kernel
    assert "cp.async.wait_group %0" in kernel and "atomicAdd" not in text
    assert "fmaf(a[i], b[j], acc[i][j])" in kernel

def _kernel_body(text, name):
    """The text of the __global__ function `name`, from its name to its end."""
    start = text.index(f"\n{name}(")
    body = text.index("{", text.index(")", start))
    depth, i = 0, body
    while True:
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return text[start:i + 1]
        i += 1


def test_flash_attention_runs_bf16_on_the_tensor_cores_and_fp32_on_the_fma_units():
    # K8's bf16 tensor-core kernel (mma.sync, fp32 accumulation); fp32 stays
    # the IEEE fp32 FMA kernel (no TF32).
    text = (build.CSRC.parent / "flash_attention" / "flash_attention.cu").read_text()
    mma = _kernel_body(text, "flash_attention_mma_kernel")
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in text
    assert "mma_bf16(" in mma and "ldsm_x4_trans(" in mma and "fmaf(" not in mma
    fma = _kernel_body(text, "flash_attention_kernel")
    assert "fmaf(" in fma and "mma" not in fma
    assert ".tf32" not in text  # no TF32 instruction
    launcher = text[text.index("void repro::launch_flash_attention("):]
    bf16_branch, fp32_branch = launcher.split("} else {")
    assert "dispatch_mma(static_cast<const __nv_bfloat16*>" in bf16_branch
    assert "dispatch(static_cast<const float*>" in fp32_branch


def test_quadform_tile_matches_the_wrapper_and_bf16_is_a_template_parameter():
    # The partial buffer is (ceil(m / TILE), n): the wrapper's TILE must be the
    # kernel's tile, or the kernel writes past it. bf16 is compiled in, so the
    # fp32 kernel's FMA loop carries no runtime branch.
    from repro_torch.kernels import quadform_ops as qo

    text = (build.CSRC.parent / "quadform" / "quadform.cu").read_text()
    assert int(re.search(r"constexpr int QT = (\d+);", text).group(1)) == qo.TILE
    assert "template <bool BF16, bool VEC>" in text
    kernel = _kernel_body(text, "quadform_partial_kernel")
    signature = kernel[:kernel.index("{")]
    assert "bf16" not in signature.lower() and "if (BF16)" in kernel
    assert "if (bf16)" not in kernel and "fmaf(a[i], b[j], acc[i][j])" in kernel
    assert "launch<true, true>" in text and "launch<false, true>" in text
