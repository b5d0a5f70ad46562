"""Training step and loop (port of ``repro.train.trainer``).

``make_train_step`` builds the step: gradient accumulation over
``accum_steps`` microbatches, optional int8 gradient compression,
global-norm clipping, AdamW with the configured state dtype, and the
schedule.  It runs eagerly: params and optimizer state are updated in
place (the reference's jit donates them; buffer donation is an XLA hint
with no counterpart here).

Under ``launch.mesh.mesh_context(mesh)`` the step runs on this rank's
blocks, as the reference's ``jax.jit(make_train_step(cfg, tc),
in_shardings=...)`` runs it (``launch/dryrun.py::_lower_train``): params
cut by their specs (``convert.train_params_from_jax(..., mesh=)``) and
moments by ``optim.adamw.opt_axes`` (``adamw_init`` under the mesh, or
``adamw_state_from_jax(..., mesh=)``), the batch this rank's rows (over
('pod', 'data'), or ('data', 'model') under ``pure_fsdp``).  The forward
is ``models.lm.forward``'s sharded one (a MoE FFN expert parallel, MLA
on this rank's heads, the recurrent blocks on this rank's channels, an
encoder or a VLM's front rows in the sequence cut); each of the
``accum_steps`` microbatches is this rank's share of the global batch's
(``_sharded_microbatches``: every entry of the batch, ``frames`` and
``front`` too).  After
the backward each gradient leaf is summed over the mesh axes on which its
uses saw different data (``_reduce_grads``); the compression runs on
this rank's block of the global gradient and gives that block of the
unsharded compression (``train.compress``); clipping sums the norm over
the shards; AdamW updates each rank's moments (int8 moments that
``opt_axes`` replicates from the whole gradient).  The loss and the norm
are the global values on every rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.models import lm, nn
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm, tree_leaves,
                                     tree_map)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (_names, current_mesh, spec_of,
                                           with_spec)
from repro_torch.optim.schedules import cosine_schedule, wsd_schedule
from repro_torch.train.compress import compress_grads


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    total_steps: int = 1000
    warmup_steps: int = 20
    schedule: str = "cosine"      # cosine | wsd
    clip_norm: float = 1.0
    accum_steps: int = 1
    compress: bool = False        # int8 grad compression
    adamw: AdamWConfig = AdamWConfig()


def schedule_fn(tc: TrainConfig):
    if tc.schedule == "wsd":
        return lambda s: wsd_schedule(s, tc.lr, tc.total_steps,
                                      tc.warmup_steps)
    if tc.schedule != "cosine":
        raise ValueError(f"schedule {tc.schedule!r} not in cosine | wsd")
    return lambda s: cosine_schedule(s, tc.lr, tc.total_steps,
                                     tc.warmup_steps)


def _unflatten(tree, leaves):
    it = iter(leaves)
    order = {id(t): next(it) for t in tree_leaves(tree)}
    return tree_map(lambda t: order[id(t)], tree)


def grad_axes(cfg, spec) -> tuple:
    """The mesh axes over which the gradient of a leaf of spec ``spec`` is
    summed after the backward: every axis on which the sharded step splits
    its work (``nn.train_work_axes``: the batch's, and 'model' under
    tensor parallelism) that the spec does not shard the leaf on.

    Along an axis the spec names, each rank's block is reduced already:
    an FSDP axis by the backward of the block's gather (a reduce-scatter,
    the data-parallel sum), a TP 'model' because only its owner uses the
    block (a column-parallel ``w``, ``w_step`` or bias; the
    vocab-parallel table).  Along every other work axis the ranks hold
    one copy and use it on different data: their rows (the batch axes),
    or under tensor parallelism their sequence block (the norms), their
    columns (an ``aq`` beside a column- or row-parallel product; a
    row-parallel ``wo``'s replicated ``w_step``).  So each such gradient
    is a partial sum."""
    sharded = {a for e in spec for a in _names(e)}
    return tuple(a for a in nn.train_work_axes(cfg) if a not in sharded)


def _reduce_grads(params, grads, cfg):
    """Each gradient leaf summed over its ``grad_axes`` (this rank's
    block of the global gradient), in place (the step owns its
    gradients: no second copy of the tree), and tagged with its param's
    spec."""
    out = []
    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        spec = spec_of(p)
        axes = grad_axes(cfg, spec)
        if axes:
            g = coll.all_reduce(g.contiguous(), axes, inplace=True)
        out.append(with_spec(g, spec))
    return _unflatten(grads, out)


def _sharded_microbatches(batch, n: int, cfg) -> list:
    """This rank's share of each of ``n`` microbatches under the mesh.
    Microbatch ``i`` is the global batch's rows ``[i B / n, (i + 1) B /
    n)``, as the reference's step reshapes the global batch (the MoE aux
    loss is not linear in the rows, so the grouping counts): the rows are
    gathered over the batch axes (token ids, a few KB) and each
    microbatch's rows cut into blocks over them again."""
    axes = nn.train_batch_axes(cfg)
    whole = {k: coll.all_gather(v, axes, dim=0) for k, v in batch.items()}
    return [{k: coll.split(v.reshape(n, -1, *v.shape[1:])[i], axes, dim=0)
             for k, v in whole.items()} for i in range(n)]


def make_train_step(cfg, tc: TrainConfig,
                    forward_fn: Optional[Callable] = None):
    """Returns ``train_step(params, opt_state, batch, step, gen=None) ->
    (params, opt_state, metrics)``: ``batch`` a dict of tensors on the
    params' device (split into ``accum_steps`` microbatches along its
    first dim), ``step`` the int step the schedule reads, ``gen`` the
    generator of the compression's uniforms.  ``metrics``: ``loss``,
    ``gnorm`` (before clipping) and ``lr``, 0-d tensors.

    ``train_step.grads(params, batch) -> (loss, grads)`` is the step's
    gradient before clipping: accumulated over the microbatches and,
    under a mesh, reduced (``_reduce_grads``)."""
    fwd = forward_fn or (lambda p, b: lm.forward(p, b, cfg)[0])
    sched = schedule_fn(tc)

    def loss_and_grads(params, batch):
        # a leaf the forward does not read (a VLM's ``front`` on a
        # tokens-only batch) gets zeros, as ``jax.grad`` gives it
        leaves = tree_leaves(params)
        loss = fwd(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), _unflatten(params, grads)

    def step_grads(params, batch):
        if tc.accum_steps > 1:
            mbs = (_sharded_microbatches(batch, tc.accum_steps, cfg)
                   if current_mesh() is not None else
                   [{k: v.reshape(tc.accum_steps, -1, *v.shape[1:])[i]
                     for k, v in batch.items()}
                    for i in range(tc.accum_steps)])
            gsum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32)
            for mb in mbs:
                loss, g = loss_and_grads(params, mb)
                for a, b in zip(tree_leaves(gsum), tree_leaves(g)):
                    a.add_(b)
                del g           # one microbatch's gradient alive at a time
                lsum = lsum.to(loss.device) + loss
            loss = lsum / tc.accum_steps
            grads = tree_map(lambda g: g.div_(tc.accum_steps), gsum)
        else:
            loss, grads = loss_and_grads(params, batch)
        if current_mesh() is not None:
            grads = _reduce_grads(params, grads, cfg)
        return loss, grads

    def train_step(params, opt_state, batch, step,
                   gen: Optional[torch.Generator] = None):
        # looked up at call time: a caller may wrap it to read the gradient
        loss, grads = train_step.grads(params, batch)
        if tc.compress:   # the residuals, a gradient's size, freed at once
            grads = compress_grads(grads, gen)[0]
        grads, gnorm = clip_by_global_norm(grads, tc.clip_norm)
        lr = sched(step)
        adamw_update(params, grads, opt_state, lr, tc.adamw)
        return params, opt_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    train_step.grads = step_grads
    return train_step


COMPRESS_SEED = 1234   # the compression generator of step s: seed + s


class TrainLoop:
    """Host-side loop: data, the step, checkpointing, metrics.  Params and
    state live on ``device``; each step's batch is copied there."""

    def __init__(self, cfg, tc: TrainConfig, data, ckpt_dir=None,
                 ckpt_interval=50, forward_fn=None, device="cuda"):
        self.cfg, self.tc, self.data = cfg, tc, data
        self.ckpt_dir, self.ckpt_interval = ckpt_dir, ckpt_interval
        self.device = torch.device(device)
        self.step_fn = make_train_step(cfg, tc, forward_fn=forward_fn)
        self.metrics_log = []

    def init(self, seed=0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = lm.init_lm(self.cfg, gen, purpose="train",
                            device=self.device)
        return params, adamw_init(params, self.tc.adamw)

    def run(self, params, opt_state, start_step=0, num_steps=100,
            step_hook=None):
        from repro_torch.checkpoint import save_checkpoint

        for step in range(start_step, start_step + num_steps):
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch(step).items()}
            gen = torch.Generator(device=self.device).manual_seed(
                COMPRESS_SEED + step)
            t0 = time.perf_counter()
            params, opt_state, m = self.step_fn(params, opt_state, batch,
                                                step, gen)
            m = {k: float(v) for k, v in m.items()}   # waits for the step
            m["step"] = step
            m["wall_s"] = time.perf_counter() - t0
            self.metrics_log.append(m)
            if step_hook:
                step_hook(step, params, opt_state, m)
            if self.ckpt_dir and (step + 1) % self.ckpt_interval == 0:
                save_checkpoint(self.ckpt_dir, step + 1,
                                {"params": params, "opt": opt_state},
                                metadata={"loss": m["loss"]})
        return params, opt_state
