"""PyTorch / CUDA port of the BLESS / FALKON reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference this package is held against; the
port imports nothing of it (and nothing of JAX). Its layout mirrors the
reference: ``families``, ``core`` (kernels, backends, FALKON), ``api`` (the
sampler and estimator front door), ``models``, ``configs`` and ``serving``
(the LM stack and its serving path), ``optim``, ``training``, ``data`` and
``runtime`` (LM training), ``kernels`` (the hand-written CUDA kernels and
their plain PyTorch versions) and ``interop`` (state carried across from
the JAX side as numpy arrays).

Entry points run on the card unless the caller asks for the CPU
(``FitConfig(device="cpu")`` / ``backend="torch"`` / ``LM(cfg, device="cpu")``).
"""
