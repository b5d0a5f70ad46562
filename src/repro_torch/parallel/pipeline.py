"""GPipe-style pipeline parallelism (port of ``repro.parallel.pipeline``).

``pipeline_apply`` runs S stages (one a rank of the group) over M
microbatches with the classic (S + M - 1)-slot schedule: at each slot
every stage processes the microbatch it holds and hands its output to
the next stage (a P2P hop); stage 0 takes microbatch t, the last stage
collects.  Bubble fraction = (S - 1) / (S + M - 1).  The collected
outputs are then summed over the group with the other stages' zeros
(the reference's masked ``psum``), so every rank holds them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.comm_analysis import note_collective


def pipeline_apply(stage_fn, stage_params, xs: torch.Tensor, group=None):
    """Run ``stage_fn(stage_params, x)`` as a pipeline over the group.

    stage_params: THIS rank's stage params (the reference's
    ``params_stacked[rank]``); xs: ``[M, mb, ...]`` microbatches,
    replicated.  Returns ``[M, mb, ...]`` after all stages, on every
    rank."""
    S = dist.get_world_size(group)
    sid = dist.get_rank(group)
    glob = lambda i: dist.get_global_rank(group, i) if group else i
    M = xs.shape[0]
    mb_shape = xs.shape[1:]
    zeros = torch.zeros(mb_shape, dtype=xs.dtype, device=xs.device)
    outs = torch.zeros_like(xs)
    held = zeros
    for t in range(S + M - 1):
        if sid == 0:
            inp = xs[t] if t < M else zeros
        else:
            inp = held
        out = stage_fn(stage_params, inp)
        # pass to the next stage: j -> j + 1 for j < S - 1
        ops, recv = [], None
        if sid < S - 1:
            note_collective("collective-permute", out)
            ops.append(dist.P2POp(dist.isend, out.contiguous(),
                                  glob(sid + 1), group))
        if sid > 0:
            recv = torch.empty(mb_shape, dtype=xs.dtype, device=xs.device)
            ops.append(dist.P2POp(dist.irecv, recv, glob(sid - 1), group))
        for r in (dist.batch_isend_irecv(ops) if ops else ()):
            r.wait()
        held = recv if recv is not None else zeros
        done = t - (S - 1)      # the last stage finished microbatch done
        if sid == S - 1 and done >= 0:
            outs[done] = out
    if sid != S - 1:
        outs.zero_()
    note_collective("all-reduce", outs)
    dist.all_reduce(outs, group=group)
    return outs
