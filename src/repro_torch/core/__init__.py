"""The solver layer of the port: kernels and their backends, FALKON, the
direct oracles. All hot contractions go through the ``Backend`` seam in
``repro_torch.core.backend`` (the pure-torch streamer or the CUDA kernels)."""
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
from .leverage import CenterSet, effective_dim, exact_rls, uniform_center_set
from .falkon import (
    FalkonModel,
    Preconditioner,
    cg,
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
    "CenterSet", "effective_dim", "exact_rls", "uniform_center_set",
    "FalkonModel", "Preconditioner", "cg", "falkon_fit",
    "local_knm_quadratic", "local_knm_t", "make_preconditioner",
    "exact_krr", "nystrom_krr",
]
