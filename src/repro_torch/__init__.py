"""PyTorch/CUDA port of the ``repro`` serving stack.

Mirrors the JAX package ``repro`` module by module (``configs``,
``models``, ``kernels``, ``serve``, ``launch``).  It imports ``torch`` and
never ``jax`` or ``repro``.  Entry points take an explicit ``device``
that defaults to ``"cuda"``; on a CUDA tensor the attention kernels are the
hand-written CUDA ones under ``kernels/*/csrc``, on a CPU tensor their
plain PyTorch versions.
"""
