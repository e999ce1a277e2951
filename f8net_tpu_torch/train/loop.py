"""Training / evaluation / calibration loop (the port of
`f8net_tpu/train/loop.py`).

Steps over the params, state and momentum dicts of tensors, with the
reference's input conditioning, cross-entropy objective, top-k error
metrics, finetune_iters cap (tiny finetuning) and bn-calibration phase.  A
train step is the model's train-mode forward, the loss, `loss.backward()`
(autograd through `ops.fxp.ste_quant`'s straight-through gradient) and
`sgd_update`, all in full float32 on the card (`utils.float32_exact`: TF32
off for the backward convs too).  Metrics stay on the device and are read
once per epoch.

Data parallelism (the JAX package's one jitted step over Mesh('data')):
given a process group of more than one process, each process steps on its
shard of the global batch, and every reduction spans the global batch --
the QAT forward's batch statistics (nn/quant_layers.py), the loss (the
mean over the global batch), the parameter gradients (all-reduced before
`sgd_update`, so every process applies the same update to the same
params) and the metrics (`parallel.all_reduce_metrics`).  With no group,
or a group of one, the step is the one-process step.

Tensor parallelism (the JAX step over Mesh('data', 'model') with
`param_shardings(..., tensor_parallel=True)`, as
`__graft_entry__.dryrun_multichip` trains): given a mesh, the params and
momentum are this rank's slices (`parallel.mesh.shard_params`), the state
whole, and the images and labels its data row's shard of the global
batch.  The forward runs the cut layers on the model line
(parallel/tp_train.py); every reduction over the global batch -- the
statistics, the loss, the gradients, the metrics -- spans the data line
only, since the ranks of a model line hold the same images.  With a
model axis of one rank the step is the data-parallel one over the data
line.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from ..parallel.dist import all_reduce_metrics, all_reduce_min, all_reduce_sum_
from ..parallel.tp_train import data_line
from ..utils.device import float32_exact, resolve_device
from .optim import sgd_init, sgd_update, weight_decay_mask
from .schedules import lr_schedule


def condition_input(images, cfg, plan_head_fl: Optional[int] = None):
    """Reference input conditioning (fix_train.py:676-694).

    Unnormalized pipeline: images in [0,1] -> round(255 x)/256 (the head conv
    is weight-only and consumes the fraclen-8 grid).  Normalized pipeline:
    images already mean/std normalized pass through (the head quantizes)."""
    if cfg.normalize:
        return images
    return torch.round(255.0 * images) / 256.0


def cross_entropy_loss(logits, labels, total=None):
    """Mean negative log-likelihood, through the reference's log_softmax:
    logits minus their (constant) row max, minus the log of the summed
    exponentials.  With `total`, the sum over these rows divided by it (a
    process's share of the mean over a global batch of `total` rows)."""
    shifted = logits - torch.amax(logits, dim=1, keepdim=True).detach()
    logp = shifted - torch.log(torch.sum(torch.exp(shifted), dim=1, keepdim=True))
    nll = torch.gather(logp, 1, labels.long()[:, None])
    if total is None:
        return -torch.mean(nll)
    return -torch.sum(nll) / total


def topk_correct(logits, labels, ks=(1, 5)):
    """Number of correct predictions at each k (tensors on the logits'
    device)."""
    _, pred = torch.topk(logits, max(ks), dim=1)
    match = pred == labels.long()[:, None]
    return {k: torch.sum(match[:, :k]) for k in ks}


def _metrics(loss, logits, labels, tcfg, group=None):
    """The step's loss, top-k counts and rows; with a group, summed over
    its processes (one collective: the loss shares add up to the global
    batch's loss)."""
    metrics = {"loss": loss.detach(), "n": torch.tensor(labels.shape[0], device=logits.device)}
    for k, v in topk_correct(logits.detach(), labels, tcfg.topk).items():
        metrics[f"top{k}"] = v
    return metrics if group is None else all_reduce_metrics(metrics, "sum", group)


def _detached(state):
    return {lname: {k: v.detach() for k, v in sub.items()} for lname, sub in state.items()}


def _data_parallel(group) -> bool:
    return group is not None and torch.distributed.get_world_size(group) > 1


def _global_count(labels, group):
    """The global batch's row count (a float32 tensor on the labels'
    device), or None without a group."""
    if group is None:
        return None
    n = torch.tensor([float(labels.shape[0])], device=labels.device)
    return all_reduce_sum_(n, group)[0]


def _all_reduce_grads(grads, group) -> None:
    """Sums every parameter gradient over the group, in place, through one
    flat buffer (one collective)."""
    leaves = [g for sub in grads.values() for g in sub.values() if g is not None]
    flat = all_reduce_sum_(torch.cat([g.reshape(-1) for g in leaves]), group)
    for g, part in zip(leaves, torch.split(flat, [g.numel() for g in leaves])):
        g.copy_(part.view_as(g))


def _step_groups(group, mesh):
    """(the data line's process group or None, the gradients' group):
    under a mesh the gradients go through its data line, which counts
    them."""
    if mesh is None:
        group = group if _data_parallel(group) else None
        return group, group
    if group is not None:
        raise ValueError("a step takes a group or a mesh, not both")
    return data_line(mesh), mesh.line("data")


def make_train_step(model, cfg, tcfg, group=None, mesh=None):
    """Returns step(params, state, opt, images, labels, lr) -> (params,
    state, opt, metrics).  params and the momentum buffers are updated in
    place; images and labels are tensors on the params' device.  Given a
    process group of more than one process, images and labels are this
    process's shard of the global batch and the step is data parallel
    (module docstring): metrics are the global batch's.  Given a mesh
    instead, the step is tensor parallel over its model line and data
    parallel over its data line (module docstring)."""
    group, grad_group = _step_groups(group, mesh)
    mask = None  # built lazily against the param structure

    def step(params, state, opt, images, labels, lr):
        nonlocal mask
        x = condition_input(images, cfg)
        total = _global_count(labels, group)
        leaves = [p for sub in params.values() for p in sub.values()]
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        try:
            with float32_exact():
                logits, new_state = (model.forward(params, state, x, "train", cfg, group)
                                     if mesh is None else
                                     model.forward(params, state, x, "train", cfg, mesh=mesh))
                loss = cross_entropy_loss(logits, labels, total)
                loss.backward()
            grads = {lname: {k: p.grad for k, p in sub.items()} for lname, sub in params.items()}
            if grad_group is not None:
                _all_reduce_grads(grads, grad_group)
            if mask is None:
                mask = weight_decay_mask(
                    model.graph, params, tcfg.weight_decay_scheme, tcfg.weight_decay
                )
            sgd_update(params, grads, opt, lr, mask, tcfg.momentum, tcfg.nesterov)
        finally:
            for p in leaves:
                p.grad = None
                p.requires_grad_(False)
        return params, _detached(new_state), opt, _metrics(loss, logits, labels, tcfg, group)

    return step


def make_eval_step(model, cfg, tcfg, mode: str = "eval", group=None, mesh=None):
    """step(params, state, images, labels) -> (state, metrics); 'calib'
    mode returns the calibrated BN state, 'eval' the state unchanged.
    Given a process group of more than one process, a 'calib' step's batch
    statistics and metrics span the global batch, as the train step's do;
    an 'eval' step's forward reads no statistic, and its metrics stay this
    process's (the Trainer reduces them per epoch).  Given a mesh instead,
    the forward is tensor parallel over its model line (params this rank's
    slices, state whole) and the data line plays the group's part."""
    group = _step_groups(group, mesh)[0]
    group = group if mode == "calib" else None

    @torch.no_grad()
    def step(params, state, images, labels):
        x = condition_input(images, cfg)
        logits, new_state = (model.forward(params, state, x, mode, cfg, group) if mesh is None
                             else model.forward(params, state, x, mode, cfg, mesh=mesh))
        loss = cross_entropy_loss(logits, labels, _global_count(labels, group))
        return new_state, _metrics(loss, logits, labels, tcfg, group)

    return step


class Trainer:
    """Orchestrates epochs: train -> val -> checkpoint, with calib and
    tiny-finetuning support (the reference's Trainer).  Batches come from a
    loader as numpy NHWC float32 images and int labels (or tensors); each is
    moved to `device` ("cuda", the default, raises without a card).

    Given a process group of more than one process (data parallelism), each
    process's loader yields its shard of every global batch; the train and
    calib steps run in lockstep (a process whose shard has more batches
    than another's stops with the fewest: the global batches a process
    would take alone are dropped), and the results are the global
    batches'."""

    def __init__(self, model, cfg, tcfg, log=print, device="cuda", group=None):
        self.model = model
        self.cfg = cfg
        self.tcfg = tcfg
        self.log = log
        self.device = resolve_device(device)
        self.group = group if _data_parallel(group) else None
        self.train_step = make_train_step(model, cfg, tcfg, self.group)
        self.eval_step = make_eval_step(model, cfg, tcfg)
        self.calib_step = make_eval_step(model, cfg, tcfg, mode="calib", group=self.group)
        self._lockstep: Dict[int, tuple] = {}  # id(loader) -> (loader, its lockstep count)

    def lockstep_steps(self, loader) -> int:
        """The batches each process takes from `loader` in a train or calib
        epoch: its length in one process; under data parallelism the least
        length over the processes (one collective per loader: a Loader's
        length does not change between epochs)."""
        if self.group is None:
            return len(loader)
        if id(loader) not in self._lockstep:
            self._lockstep[id(loader)] = (loader, all_reduce_min(len(loader), self.group))
        return self._lockstep[id(loader)][1]

    def init(self, generator: torch.Generator):
        """(params, state, SGD state) with the model's init drawn from
        `generator` and placed on the trainer's device."""
        params, state = self.model.init(generator, device=self.device)
        return params, state, sgd_init(params)

    def _to_device(self, images, labels):
        images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        labels = torch.as_tensor(labels).to(self.device)
        return images, labels

    def run_epoch(
        self,
        params,
        state,
        opt,
        loader,
        epoch: int,
        steps_per_epoch: int,
        phase: str = "train",
    ):
        """loader yields (images NHWC float [0,1] or normalized, labels)."""
        t0 = time.time()
        sched = lr_schedule(self.tcfg, steps_per_epoch)
        totals: Dict[str, Any] = {}
        nb = 0
        fi = self.tcfg.finetune_iters
        lockstep = self.group is not None and phase in ("train", "calib")
        steps = self.lockstep_steps(loader) if lockstep else None
        for batch_idx, (images, labels) in enumerate(loader):
            if phase == "train" and fi is not None and batch_idx >= fi:
                break
            if phase == "calib" and 0 <= self.tcfg.bn_calib_batch_num == batch_idx:
                break
            if lockstep and batch_idx >= steps:
                break
            images, labels = self._to_device(images, labels)
            if phase == "train":
                lr = self.tcfg.lr * sched(epoch * steps_per_epoch + batch_idx)
                params, state, opt, metrics = self.train_step(
                    params, state, opt, images, labels, lr
                )
            elif phase == "calib":
                state, metrics = self.calib_step(params, state, images, labels)
            else:
                _, metrics = self.eval_step(params, state, images, labels)  # eval leaves state
            nb += 1
            if self.tcfg.print_each_iter:
                # per-iteration error lines (fix_train.py:714-715); a host
                # sync per batch, so opt-in like the reference
                bn = float(metrics["n"])
                for k in self.tcfg.topk:
                    self.log(f"top{k} err: {1.0 - float(metrics[f'top{k}']) / bn}.")
            # accumulate on the device; one host read per epoch
            for k, v in metrics.items():
                totals[k] = v if k not in totals else totals[k] + v
        if self.group is not None and not lockstep:
            # this process's eval totals (the same keys on every process,
            # also one whose shard was empty)
            keys = ["loss", "n"] + [f"top{k}" for k in self.tcfg.topk]
            totals = all_reduce_metrics(dict({k: totals.get(k, 0.0) for k in keys}, batches=nb),
                                        "sum", self.group)
            nb = totals.pop("batches")
        keys = list(totals)
        values = torch.stack([totals[k].double() for k in keys]).tolist() if keys else []
        totals = dict(zip(keys, values))
        nb = int(nb)
        n = max(totals.get("n", 1.0), 1.0)
        results = {"loss": totals.get("loss", 0.0) / max(nb, 1)}
        for k in self.tcfg.topk:
            results[f"top{k}_error"] = 1.0 - totals.get(f"top{k}", 0.0) / n
        self.log(
            f"{time.time() - t0:.1f}s\t{phase}\t{epoch}/{self.tcfg.num_epochs}: "
            + ", ".join(f"{k}: {v:.3f}" for k, v in results.items())
        )
        return params, state, opt, results
