"""Build and load the hand-written CUDA kernels.

One ``torch.utils.cpp_extension.load`` call compiles every source of the
package for ``sm_90a`` into one extension module: the ``.cu`` kernel files
(plain CUDA C++, no PyTorch headers) and ``csrc/binding.cpp``, the only file
that includes ``torch/extension.h``. Ninja compiles the sources in parallel.
Nothing is compiled at import time: the first kernel launch calls
``extension()``.

Output goes to ``build/repro_torch_kernels/`` at the root of the checkout
(listed in ``.gitignore``); an unchanged build is reused, a changed source
rebuilt.

Flags: ``-O3 -gencode=arch=compute_90a,code=sm_90a``, no ``--use_fast_math``
(the epilogues use IEEE ``expf`` / ``sqrtf``).
"""
from __future__ import annotations

import pathlib
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
NAME = "repro_torch_kernels"
#: every source of the extension, relative to the kernels package.
SOURCES = ["csrc/binding.cpp", "gram/gram.cu", "falkon_matvec/falkon_matvec.cu",
           "rls_score/rls_score.cu", "quadform/quadform.cu",
           "flash_attention/flash_attention.cu", "ssd/ssd.cu"]
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]
CXX_FLAGS = ["-O3"]

_LOCK = threading.Lock()
_EXT = None


def build_dir() -> pathlib.Path:
    """``build/repro_torch_kernels`` at the root of the checkout."""
    return _PKG.parents[2] / "build" / NAME


def build() -> dict:
    """Compile (or reuse) the extension; ``{"seconds": wall seconds}``.

    A failed compile raises ``RuntimeError`` with the compiler's output.
    """
    t0 = time.perf_counter()
    extension()
    return {"seconds": time.perf_counter() - t0}


def extension():
    """The loaded extension module, built on first use."""
    global _EXT
    with _LOCK:
        if _EXT is None:
            from torch.utils import cpp_extension

            out = build_dir()
            out.mkdir(parents=True, exist_ok=True)  # load() does not create it
            _EXT = cpp_extension.load(
                name=NAME, sources=[str(_PKG / s) for s in SOURCES],
                extra_cflags=CXX_FLAGS, extra_cuda_cflags=CUDA_FLAGS,
                extra_include_paths=[str(CSRC)], build_directory=str(out), verbose=False)
        return _EXT
