"""The port's kernel wrappers (K1-K4) on the CPU, held against the reference's
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
    fo.knm_t(x, z, y)
    fo.knm_matvec(x, z, v)
    w = torch.eye(z.shape[0])
    kernels.rls_score_ops.rls_score(x, z, w, torch.ones(z.shape[0], dtype=torch.bool), 1.0)
    kernels.quadform_ops.quadform(go.gram(x, z), w)
    assert kernels.launch_counts() == {"gram": 0, "falkon_matvec": 0, "knm_t": 0,
                                       "knm_matvec": 0, "rls_score": 0, "quadform": 0}


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
    assert names == ["launch_gram", "launch_knm_matvec", "launch_knm_t_partial",
                     "launch_reduce_partials", "launch_rls_score", "launch_quadform_partial"]
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
    for name in ("gram", "knm_matvec", "knm_t", "falkon_matvec", "rls_score", "quadform"):
        assert f'm.def("{name}", &{name}' in text
