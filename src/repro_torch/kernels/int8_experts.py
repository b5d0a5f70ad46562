"""Expert-stacked int8 product: int8 ``a [E, M, K]`` x int8 ``w [E, K, N]``
-> int32 ``[E, M, N]``, exactly (the reference's ``jax.vmap`` of an int8
``dot_general`` over the experts of an int8 serve layout; it replaces no
Pallas kernel).

``int8_experts_matmul`` launches the CUDA kernel of
``csrc/int8_experts.cu`` once for the whole stack on CUDA tensors and runs
``int8_experts_matmul_plain`` (one batched int32 product) on CPU tensors
only (``meta`` tensors get the output's shape and dtype, no values).
``launches`` counts kernel launches.  ``int8_experts_loop`` is a
per-expert ``torch._int_mm`` loop: a yardstick and a card-side oracle,
never the serve path.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.launch.comm_analysis import note_kernel

launches = 0

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("int8_experts").int8_experts_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_args(a, w):
    if a.dim() != 3 or a.dtype != torch.int8:
        raise ValueError(f"a must be int8 [E, M, K], got {a.dtype} "
                         f"{tuple(a.shape)}")
    if w.dim() != 3 or w.dtype != torch.int8:
        raise ValueError(f"w must be int8 [E, K, N], got {w.dtype} "
                         f"{tuple(w.shape)}")
    if a.shape[0] != w.shape[0] or a.shape[2] != w.shape[1]:
        raise ValueError(f"a {tuple(a.shape)} and w {tuple(w.shape)} do not "
                         "chain as [E, M, K] x [E, K, N]")
    if a.device != w.device:
        raise ValueError(f"operands on several devices: {a.device}, "
                         f"{w.device}")


def int8_experts_matmul_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel: on the CPU one exact batched
    int32 product; on the card (no int32 matmul there) each expert's
    product in f64, exact as every partial sum is an integer below 2^53."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), w.to(torch.int32))
    return torch.stack([torch.matmul(a[e].double(), w[e].double()).to(
        torch.int32) for e in range(a.shape[0])])


def int8_experts_loop(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One ``torch._int_mm`` per expert on the card (M padded to 32 rows,
    K and N multiples of 8): the yardstick the kernel is timed against."""
    E, M, K = a.shape
    Mp = max(32, -(-M // 8) * 8)
    ap = torch.zeros((E, Mp, K), dtype=torch.int8, device=a.device)
    ap[:, :M] = a
    return torch.stack([torch._int_mm(ap[e], w[e])[:M] for e in range(E)])


def kernel_work(a: torch.Tensor, w: torch.Tensor) -> tuple:
    """``(operations, bytes)`` of one call: ``2 E M K N``, both operands
    read once and the int32 output written once."""
    E, M, K = a.shape
    N = w.shape[2]
    return 2 * E * M * K * N, a.numel() + w.numel() + E * M * N * 4


def int8_experts_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int32 ``[E, M, N]`` = ``a [E, M, K] @ w [E, K, N]`` of int8 operands,
    any E, M, K and N: one launch on the card.  Each call notes its work
    (``kernel_work``) to the open step traces; on ``meta`` tensors it
    returns the output's shape only."""
    global launches
    _check_args(a, w)
    dev = a.device.type
    if dev not in ("cpu", "meta") and not a.is_cuda:
        raise ValueError(f"unsupported device {a.device}")
    with note_kernel("int8_experts_matmul", *kernel_work(a, w)):
        if dev == "cpu":
            return int8_experts_matmul_plain(a, w)
        a, w = a.contiguous(), w.contiguous()
        E, M, K = a.shape
        N = w.shape[2]
        out = torch.empty((E, M, N), dtype=torch.int32, device=a.device)
        if out.numel() == 0 or dev == "meta":
            return out
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _launcher()(a.data_ptr(), w.data_ptr(), out.data_ptr(), E, M,
                          K, N, stream)
        _build.check(err, "int8_experts_matmul")
        launches += 1
        return out
