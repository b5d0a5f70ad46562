"""PyTorch/CUDA port of the TLMAC serve path (see ``src/repro`` for the
JAX reference every module here is held against).

Module names mirror the JAX package: ``repro.models.lm`` has its
counterpart in ``repro_torch.models.lm`` and so on.  The package imports
``torch`` and nothing of JAX or of ``repro``.  The two hand-written
Hopper kernels live in ``csrc/`` and are compiled with ``nvcc`` at first
use (``kernels/_build.py``); on CPU tensors their wrappers run the plain
PyTorch versions beside them.
"""
