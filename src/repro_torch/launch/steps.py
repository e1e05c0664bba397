"""The train step (port of ``repro.launch.steps.make_train_step``).

``make_train_step`` assembles the production step: microbatched gradient
accumulation in float32, mixed precision (float32 masters, bf16 compute:
``models.transformer.loss_fn`` casts inside the differentiated function),
global-norm clipping, optional int8 gradient compression with error
feedback, AdamW on a cosine LR. The sharding arguments of the reference
(``rules``, ``mesh``, ``make_constrain``) are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.models import transformer as T
from repro_torch.optim import (adamw_update, clip_by_global_norm,
                               compressed_grads, cosine_schedule)


def make_train_step(cfg: ModelCfg, *, microbatches: int = 1,
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, grad_clip: float = 1.0,
                    compress: bool = False):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``params`` is the model (its float32 masters and
    ``opt_state``'s moments are updated in place), ``batch`` holds tokens and
    targets (B, S) on the model's device; metrics ``loss``, ``xent``,
    ``aux``, ``grad_norm`` and ``lr`` are 0-d tensors there (no host
    read)."""
    T.check_trainable(cfg)

    def grads_of(params, batch):
        named = dict(params.named_parameters())
        loss, metrics = T.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, list(named.values()))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(named, grads)))

    def train_step(params, opt_state: dict, batch: dict):
        if microbatches == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            bsz = batch["tokens"].shape[0]
            if bsz % microbatches:
                raise ValueError(f"batch {bsz} is not a multiple of "
                                 f"{microbatches} microbatches")
            mb = bsz // microbatches
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.named_parameters()}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l_i, _, g_i = grads_of(params, part)
                for k, g in g_i.items():
                    grads[k] += g.float()
                lsum = lsum + l_i
            grads = {k: g / microbatches for k, g in grads.items()}
            loss = lsum / microbatches
            metrics = {"xent": loss, "aux": torch.zeros_like(loss)}

        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        if compress:
            grads, new_err = compressed_grads(grads, opt_state.get("err"))
        lr = cosine_schedule(opt_state["count"], peak_lr=peak_lr,
                             warmup=warmup, total=total_steps)
        adamw_update(grads, opt_state, dict(params.named_parameters()),
                     lr=lr)
        if compress:
            opt_state["err"] = new_err
        metrics = dict(metrics)
        metrics.update(loss=loss, grad_norm=gnorm, lr=lr)
        return params, opt_state, metrics

    return train_step
