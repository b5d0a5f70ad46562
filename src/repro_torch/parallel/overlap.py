"""Compute/communication overlap: collective matmuls over a P2P ring
(port of ``repro.parallel.overlap``).

Standard TP computes ``y = x @ W`` with ``x`` row-sharded by first
all-gathering ``x`` (exposed latency), then the matmul.  The collective
matmul overlaps the two: each ring step multiplies the block it holds
while ``batch_isend_irecv`` forwards the block to the next rank, so after
n - 1 hops every rank has the full product with no all-gather on the
critical path.  On the card NCCL's P2P runs on its own stream, under the
product.

The reference expresses the schedule in ``shard_map`` over a mesh axis;
here each function runs on one rank of a process group (every rank calls
it), with the rank's own shard.  Products are f32, as the reference's
``preferred_element_type``.  On one rank a hop is the identity (the
reference's ``ppermute`` over a size-1 axis) and nothing is sent.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.comm_analysis import note_collective


def _ring(group):
    """(n, this rank's index, global rank of the next, of the previous)."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    glob = lambda i: dist.get_global_rank(group, i) if group else i
    return n, idx, glob((idx + 1) % n), glob((idx - 1) % n)


def _start_hop(send: torch.Tensor, nxt: int, prv: int, group):
    """Send ``send`` to the next rank and receive the previous rank's
    block of the same shape; returns (receive buffer, requests)."""
    recv = torch.empty_like(send)
    note_collective("collective-permute", send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, nxt, group),
        dist.P2POp(dist.irecv, recv, prv, group),
    ])
    return recv, reqs


def ring_ag_matmul(x_blk: torch.Tensor, w: torch.Tensor, group=None):
    """``y = allgather(x) @ w`` with the gather overlapped by a ring.

    x_blk: ``[M_shard, K]``, this rank's rows of ``x`` (row-sharded over
    the group, rank i holding rows ``[i M_shard, (i + 1) M_shard)``);
    w: ``[K, N]``, replicated.  Returns ``y [M_shard * n, N]`` f32, the
    whole product on every rank.  n - 1 hops, each one block."""
    n, idx, nxt, prv = _ring(group)
    blk = x_blk.to(torch.float32).contiguous()
    w32 = w.to(torch.float32)
    m = blk.shape[0]
    out = torch.zeros((m * n, w.shape[1]), dtype=torch.float32,
                      device=blk.device)
    for i in range(n):
        src = (idx - i) % n             # the rank this block came from
        reqs = ()
        if i < n - 1:
            recv, reqs = _start_hop(blk, nxt, prv, group)
        torch.matmul(blk, w32, out=out[src * m:(src + 1) * m])
        for r in reqs:
            r.wait()
        if reqs:
            blk = recv
    return out


def ring_rs_matmul(x: torch.Tensor, w_blk: torch.Tensor, group=None):
    """Reduce-scatter fused matmul (the Megatron 'g' partner of the 'f'
    all-gather above): ``w`` is K-sharded, the partial products need a
    cross-rank sum, and the result lands row-scattered.

    x: ``[M, K]`` replicated; w_blk: ``[K / n, N]``, this rank's rows of
    ``w``.  Returns this rank's row slice ``[M / n, N]`` of ``x @ w`` f32
    (the caller assembles the rows, as the reference's ``out_specs``
    does).  The accumulator rotates one hop a step while the next
    partial product is computed; computing slice ``(idx - i - 1) mod n``
    keeps each accumulator on one output slice, which lands on its owner
    after the last step.  The reference's first hop moves a zero
    accumulator; the port skips it (n - 1 hops)."""
    n, idx, nxt, prv = _ring(group)
    M = x.shape[0]
    if M % n:
        raise ValueError(f"ring_rs_matmul: M={M} does not divide over "
                         f"{n} ranks")
    m, k = M // n, w_blk.shape[0]
    x_j = x[:, idx * k:(idx + 1) * k].to(torch.float32)
    w32 = w_blk.to(torch.float32)
    acc = None
    for i in range(n):
        src = (idx - i - 1) % n
        reqs = ()
        if acc is not None:
            recv, reqs = _start_hop(acc, nxt, prv, group)
        part = torch.matmul(x_j[src * m:(src + 1) * m], w32)
        for r in reqs:
            r.wait()
        acc = part if acc is None else recv + part
    return acc
