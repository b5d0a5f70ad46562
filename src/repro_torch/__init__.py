"""PyTorch/CUDA port of the TLMAC system (see ``src/repro`` for the JAX
reference every module here is held against): the paged TLMAC serve
path and the paper's compile-and-execute flow (compiler, quantisers,
``TLMACLinear``, ResNet-18 lookup convs).

Module names mirror the JAX package: ``repro.models.lm`` has its
counterpart in ``repro_torch.models.lm`` and so on.  The package imports
``torch``, numpy and scipy, and nothing of JAX or of ``repro``.  The
hand-written Hopper kernels live in ``csrc/`` and are compiled with
``nvcc`` at first use (``kernels/_build.py``); on CPU tensors their
wrappers run the plain PyTorch versions beside them.
"""
