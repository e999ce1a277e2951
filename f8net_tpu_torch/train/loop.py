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
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

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


def cross_entropy_loss(logits, labels):
    """Mean negative log-likelihood, through the reference's log_softmax:
    logits minus their (constant) row max, minus the log of the summed
    exponentials."""
    shifted = logits - torch.amax(logits, dim=1, keepdim=True).detach()
    logp = shifted - torch.log(torch.sum(torch.exp(shifted), dim=1, keepdim=True))
    return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))


def topk_correct(logits, labels, ks=(1, 5)):
    """Number of correct predictions at each k (tensors on the logits'
    device)."""
    _, pred = torch.topk(logits, max(ks), dim=1)
    match = pred == labels.long()[:, None]
    return {k: torch.sum(match[:, :k]) for k in ks}


def _metrics(loss, logits, labels, tcfg):
    metrics = {"loss": loss.detach(), "n": torch.tensor(labels.shape[0], device=logits.device)}
    for k, v in topk_correct(logits.detach(), labels, tcfg.topk).items():
        metrics[f"top{k}"] = v
    return metrics


def _detached(state):
    return {lname: {k: v.detach() for k, v in sub.items()} for lname, sub in state.items()}


def make_train_step(model, cfg, tcfg):
    """Returns step(params, state, opt, images, labels, lr) -> (params,
    state, opt, metrics).  params and the momentum buffers are updated in
    place; images and labels are tensors on the params' device."""
    mask = None  # built lazily against the param structure

    def step(params, state, opt, images, labels, lr):
        nonlocal mask
        x = condition_input(images, cfg)
        leaves = [p for sub in params.values() for p in sub.values()]
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        try:
            with float32_exact():
                logits, new_state = model.forward(params, state, x, "train", cfg)
                loss = cross_entropy_loss(logits, labels)
                loss.backward()
            grads = {lname: {k: p.grad for k, p in sub.items()} for lname, sub in params.items()}
            if mask is None:
                mask = weight_decay_mask(
                    model.graph, params, tcfg.weight_decay_scheme, tcfg.weight_decay
                )
            sgd_update(params, grads, opt, lr, mask, tcfg.momentum, tcfg.nesterov)
        finally:
            for p in leaves:
                p.grad = None
                p.requires_grad_(False)
        return params, _detached(new_state), opt, _metrics(loss, logits, labels, tcfg)

    return step


def make_eval_step(model, cfg, tcfg, mode: str = "eval"):
    """step(params, state, images, labels) -> (state, metrics); 'calib'
    mode returns the calibrated BN state, 'eval' the state unchanged."""

    @torch.no_grad()
    def step(params, state, images, labels):
        x = condition_input(images, cfg)
        logits, new_state = model.forward(params, state, x, mode, cfg)
        loss = cross_entropy_loss(logits, labels)
        return new_state, _metrics(loss, logits, labels, tcfg)

    return step


class Trainer:
    """Orchestrates epochs: train -> val -> checkpoint, with calib and
    tiny-finetuning support (the reference's Trainer).  Batches come from a
    loader as numpy NHWC float32 images and int labels (or tensors); each is
    moved to `device` ("cuda", the default, raises without a card)."""

    def __init__(self, model, cfg, tcfg, log=print, device="cuda"):
        self.model = model
        self.cfg = cfg
        self.tcfg = tcfg
        self.log = log
        self.device = resolve_device(device)
        self.train_step = make_train_step(model, cfg, tcfg)
        self.eval_step = make_eval_step(model, cfg, tcfg)
        self.calib_step = make_eval_step(model, cfg, tcfg, mode="calib")

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
        for batch_idx, (images, labels) in enumerate(loader):
            if phase == "train" and fi is not None and batch_idx >= fi:
                break
            if phase == "calib" and 0 <= self.tcfg.bn_calib_batch_num == batch_idx:
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
        keys = list(totals)
        values = torch.stack([totals[k].double() for k in keys]).tolist() if keys else []
        totals = dict(zip(keys, values))
        n = max(totals.get("n", 1.0), 1.0)
        results = {"loss": totals.get("loss", 0.0) / max(nb, 1)}
        for k in self.tcfg.topk:
            results[f"top{k}_error"] = 1.0 - totals.get(f"top{k}", 0.0) / n
        self.log(
            f"{time.time() - t0:.1f}s\t{phase}\t{epoch}/{self.tcfg.num_epochs}: "
            + ", ".join(f"{k}: {v:.3f}" for k, v in results.items())
        )
        return params, state, opt, results
