"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each kernel lives in ``<name>/{<name>.cu, ref.py, ops.py}``: the CUDA source,
the plain PyTorch version, and the wrapper that launches the kernel for CUDA
tensors and runs the plain version for CPU tensors. ``build.py`` compiles
the sources on first use; importing this package compiles nothing.
"""
from .falkon_matvec import ops as falkon_matvec_ops
from .flash_attention import ops as flash_attention_ops
from .gram import ops as gram_ops
from .quadform import ops as quadform_ops
from .rls_score import ops as rls_score_ops
from .ssd import ops as ssd_ops

#: every kernel wrapper, by the name the launch counts are reported under.
WRAPPERS = {
    "gram": gram_ops.gram,
    "falkon_matvec": falkon_matvec_ops.falkon_matvec,
    "falkon_matvec_masked": falkon_matvec_ops.falkon_matvec_masked,
    "knm_t": falkon_matvec_ops.knm_t,
    "knm_matvec": falkon_matvec_ops.knm_matvec,
    "rls_score": rls_score_ops.rls_score,
    "quadform": quadform_ops.quadform,
    "flash_attention": flash_attention_ops.flash_attention,
    "ssd": ssd_ops.ssd,
}


#: the plain versions of the kernels that have a gradient (K8, K9): each
#: counts its calls on CUDA tensors, and the wrapper its backward recomputes.
PLAIN = {"flash_attention": flash_attention_ops.attention_ref, "ssd": ssd_ops.ssd_ref}


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0, and the K8 / K9 plain-call and
    backward-recompute counts with them."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    for name, ref in PLAIN.items():
        ref.cuda_calls = 0
        WRAPPERS[name].backward_recomputes = 0


def launch_counts() -> dict[str, int]:
    """Each wrapper's launch count since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def plain_counts() -> dict[str, dict[str, int]]:
    """For K8 and K9 since the last reset: the plain version's calls on CUDA
    tensors and the backward recomputes among them. A forward pass on the
    card makes none of the first that is not one of the second."""
    return {name: {"cuda_calls": ref.cuda_calls,
                   "backward_recomputes": WRAPPERS[name].backward_recomputes}
            for name, ref in PLAIN.items()}
