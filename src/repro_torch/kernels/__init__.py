"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each kernel lives in ``<name>/{<name>.cu, ref.py, ops.py}``: the CUDA source,
the plain PyTorch version, and the wrapper that launches the kernel for CUDA
tensors and runs the plain version for CPU tensors. ``build.py`` compiles
the sources on first use; importing this package compiles nothing.
"""
from .falkon_matvec import ops as falkon_matvec_ops
from .gram import ops as gram_ops
from .quadform import ops as quadform_ops
from .rls_score import ops as rls_score_ops

#: every kernel wrapper, by the name the launch counts are reported under.
WRAPPERS = {
    "gram": gram_ops.gram,
    "falkon_matvec": falkon_matvec_ops.falkon_matvec,
    "knm_t": falkon_matvec_ops.knm_t,
    "knm_matvec": falkon_matvec_ops.knm_matvec,
    "rls_score": rls_score_ops.rls_score,
    "quadform": quadform_ops.quadform,
}


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    """Each wrapper's launch count since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}
