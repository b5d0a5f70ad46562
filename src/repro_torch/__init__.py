"""PyTorch/CUDA port of the TLMAC system (see ``src/repro`` for the JAX
reference every module here is held against): the paged TLMAC serve
path, the paper's compile-and-execute flow (compiler, quantisers,
``TLMACLinear``, ResNet-18 lookup convs), and QAT training of the dense
decoders and ResNet-18 (``optim``, ``train``, ``data``, ``checkpoint``,
``launch.train``).

Module names mirror the JAX package: ``repro.models.lm`` has its
counterpart in ``repro_torch.models.lm`` and so on.  The package imports
``torch``, numpy and scipy, and nothing of JAX or of ``repro``.  The
hand-written Hopper kernels live in ``csrc/`` and are compiled with
``nvcc`` at first use (``kernels/_build.py``); on CPU tensors their
wrappers run the plain PyTorch versions beside them.
"""
