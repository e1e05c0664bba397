"""End-to-end training entry point (port of ``repro.launch.train``).

Trains an ``--arch`` of the port (full or ``--smoke`` config) under the
fault-tolerance supervisor when ``--ckpt-dir`` is given: the host-sharded
synthetic data pipeline, the train step of ``launch.steps`` (bf16 compute
over float32 masters for bf16 configs), async atomic checkpoints,
restore-on-restart. Weights are random from ``torch.Generator`` seeded by
``--seed``; ``--device`` defaults to the GPU (``cpu`` runs the plain
kernels). Every family trains; the stub frontends are fed as the
reference's trainer feeds them: zero ``patch_embeds`` (B, frontend_len, d)
ahead of a patch-stub config's tokens, ``encoder_frames`` of 0.1 (B,
n_frames, d_enc) for an encoder-decoder, both in bfloat16. On
the card an attention logit softcap is refused
(``models.transformer.check_trainable``, ROADMAP.md); a MoE config's loss
adds its routers' aux loss. ``main(argv)`` returns the list of losses.

    python -m repro_torch.launch.train --arch qwen3-1.7b --soi pp \\
        --steps 30 --batch 8 --seq 128
    python -m repro_torch.launch.train --device cpu --smoke --steps 200 \\
        --batch 8 --seq 128 --ckpt-dir "$TMPDIR/ckpt"
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.data.pipeline import ShardedLMPipeline
from repro_torch.distributed.fault_tolerance import (SupervisorConfig,
                                                     TrainSupervisor)
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.obs.clock import now
from repro_torch.optim import adamw_init


def stub_batch(cfg, batch: int, device) -> dict:
    """The stub frontends' batch keys (``repro.launch.train``'s
    ``extra_batch``): zero ``patch_embeds`` (B, frontend_len, d) for a
    patch-stub config, ``encoder_frames`` of 0.1 (B, n_frames, d_enc) for
    an encoder-decoder, in bfloat16 as the reference makes them (the
    model casts both to its compute dtype); {} for a text-only config."""
    dt = torch.bfloat16
    extras = {}
    if cfg.frontend == "patch_stub":
        extras["patch_embeds"] = torch.zeros(
            (batch, cfg.frontend_len, cfg.d_model), dtype=dt, device=device)
    if cfg.encoder is not None:
        extras["encoder_frames"] = torch.full(
            (batch, cfg.encoder.n_frames, cfg.encoder.d_model), 0.1,
            dtype=dt, device=device)
    return extras


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=configs.ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--soi", default=None, choices=["pp", "fp"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (configs.get_smoke(args.arch, soi=args.soi) if args.smoke
           else configs.get(args.arch, soi=args.soi))
    T.check_trainable(cfg, dev)
    pipe = ShardedLMPipeline(global_batch=args.batch, seq_len=args.seq,
                             vocab=cfg.vocab, seed=args.seed)
    step_fn = make_train_step(cfg, peak_lr=args.lr, warmup=20,
                              total_steps=args.steps)
    extras = stub_batch(cfg, args.batch, dev)
    losses = []

    def one_step(state, step):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch(step).items()}
        batch.update(extras)
        p, o, metrics = step_fn(state["params"], state["opt"], batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {loss:8.4f}  "
                  f"gnorm {float(metrics['grad_norm']):8.3f}  "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        return {"params": p, "opt": o}

    def make_state():
        p = T.init(cfg, generator=torch.Generator(device=dev).manual_seed(
            args.seed), device=dev)
        return {"params": p, "opt": adamw_init(dict(p.named_parameters()))}

    t0 = now()
    if args.ckpt_dir:
        sup = TrainSupervisor(
            SupervisorConfig(ckpt_dir=args.ckpt_dir,
                             ckpt_every=args.ckpt_every),
            make_state, one_step)
        sup.run(args.steps)
    else:
        state = make_state()
        for step in range(args.steps):
            state = one_step(state, step)
    dt = now() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s; "
          f"loss {losses[0]:.4f} -> {np.mean(losses[-10:]):.4f}")
    return losses


if __name__ == "__main__":
    main()
