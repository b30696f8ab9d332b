"""extended_gan_torch: the PyTorch/CUDA port of ``extended_gan_tpu``.

The JAX package beside it stays the reference; each slice of this package
is held against it by the ``tests/test_torch_port_*.py`` files. The port
imports neither ``jax`` nor ``extended_gan_tpu``: what it needs from the
JAX package's pure-Python modules it keeps as its own copy.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :func:`extended_gan_torch.core.device.resolve_device`).
Hand-written CUDA kernels live in ``ops/csrc/`` and are built with ``nvcc``
on first use (``ops/build.py``).
"""

__version__ = "0.1.0"
