"""The solver layer of the port: kernels and their backends, the BLESS
ladders and the related-work samplers, FALKON, the direct oracles. All hot
contractions go through the ``Backend`` seam in ``repro_torch.core.backend``
(the pure-torch streamer or the CUDA kernels)."""
from .gram import (
    Kernel,
    KernelFamily,
    backend_names,
    blocked_cross,
    kernel_family_names,
    make_kernel,
    register_backend,
    register_kernel_family,
    resolve_backend,
    sq_dists,
)
from .backend import Backend, CudaBackend, TorchBackend, default_backend
from .leverage import (
    CenterSet,
    approx_rls,
    approx_rls_all,
    effective_dim,
    exact_rls,
    uniform_center_set,
)
from .bless import BlessLevel, BlessResult, bless, bless_r, lam_ladder, theory_constants
from .baselines import recursive_rls, squeak, two_pass, uniform_centers
from .chen_yang import default_sketch_size, fast_spectral_rls
from .sampling import categorical, gumbel_topk
from .falkon import (
    FalkonModel,
    Preconditioner,
    cg,
    falkon_bless_fit,
    falkon_fit,
    local_knm_quadratic,
    local_knm_t,
    make_preconditioner,
)
from .nystrom import exact_krr, nystrom_krr

__all__ = [
    "Kernel", "KernelFamily", "make_kernel", "blocked_cross", "sq_dists",
    "kernel_family_names", "register_kernel_family",
    "Backend", "TorchBackend", "CudaBackend",
    "backend_names", "default_backend", "register_backend", "resolve_backend",
    "CenterSet", "approx_rls", "approx_rls_all", "effective_dim", "exact_rls",
    "uniform_center_set",
    "BlessLevel", "BlessResult", "bless", "bless_r", "lam_ladder", "theory_constants",
    "recursive_rls", "squeak", "two_pass", "uniform_centers", "default_sketch_size",
    "fast_spectral_rls", "categorical", "gumbel_topk",
    "FalkonModel", "Preconditioner", "cg", "falkon_bless_fit", "falkon_fit",
    "local_knm_quadratic", "local_knm_t", "make_preconditioner",
    "exact_krr", "nystrom_krr",
]
