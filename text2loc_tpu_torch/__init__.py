"""text2loc-tpu on PyTorch and CUDA: the port of the JAX package to one
NVIDIA H100.

The JAX package ``text2loc_tpu`` stays the reference. This package imports
``torch`` and never ``jax`` or any module of the JAX package: it keeps its
own copies of the host-side modules it needs (``constants``, ``config``,
``data.arrays``, ``data.synthetic``, ``data.structs``, ``data.pmc``,
``data.prefetch``, ``utils.logging``, ``utils.profiling``'s StageTimer). Every Pallas kernel on the ported path
has a hand-written CUDA kernel under ``csrc/`` and a plain PyTorch version
beside its wrapper: a CPU tensor takes the plain version, a CUDA tensor the
kernel.
"""
