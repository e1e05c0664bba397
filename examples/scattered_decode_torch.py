"""SOI as a first-class LM serving feature on the PyTorch port: scattered
decode through ``repro_torch.engine`` (the counterpart of
``examples/scattered_decode.py``).

Two demos on a reduced qwen3-family model (float32) with the SOI middle
block:

  1. ``lm_stream_session``: online SOI prefill (the prompt streams through
     the compressed trunk), then token-by-token decode — held against the
     offline forward. The session's clock picks the step's SOI branch; on
     the card each branch is one captured CUDA graph.
  2. ``SOIEngine`` continuous batching: requests prefilled at *different*
     prompt offsets share one batch, so their SOI phases disagree — and the
     one generate step still reproduces the offline logits of every slot.

    PYTHONPATH=src python examples/scattered_decode_torch.py \\
        [--device cpu] [--mode pp|fp]

Without ``--device cpu`` it runs on the card (and raises without one).
"""

import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import qwen3_1_7b as Q
from repro_torch.engine import SOIEngine, lm_stream_session
from repro_torch.models import transformer as T


@torch.no_grad()
def main(argv=None) -> list:
    """Runs both demos; returns their max |Δlogit| against the offline
    forward."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="pp", choices=["pp", "fp"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(Q.smoke_config(soi=args.mode), dtype="float32")
    print(f"model: {cfg.name} (reduced) layers={cfg.n_layers} "
          f"SOI middle = layers [{cfg.soi.first_layer}, {cfg.soi.last_layer})"
          f" mode={cfg.soi.mode} device={dev}")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init(cfg, generator=gen, device=dev)

    b, s = 2, 24
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev,
                           dtype=torch.int32)
    full = T.forward(params, cfg, tokens)

    # 1) the session: online prefill of the first half, stream the rest
    half = s // 2
    session = lm_stream_session(params, cfg, max_len=s,
                                prompt=tokens[:, :half], device=dev)
    err_session = 0.0
    for t in range(half, s):
        lg = session.push(tokens[:, t])
        err_session = max(err_session,
                          float((lg - full[:, t]).abs().max()))
    print(f"StreamSession (SOI prefill @ {half} + streamed decode) == "
          f"offline forward: max |dlogit| = {err_session:.2e}")

    # 2) mixed-phase continuous batching through the engine
    engine = SOIEngine(cfg, max_concurrent_decodes=b, max_len=s, device=dev)
    ds = engine.init_decode_state(params)
    offsets = [half, half + 1]        # adjacent offsets -> opposite phases
    for slot, off in enumerate(offsets):
        ds = engine.insert(engine.prefill(params, tokens[slot, :off]), ds,
                           slot)
    err_batch, cursor = 0.0, list(offsets)
    for _ in range(s - max(offsets)):
        for r in range(b):
            ds["tokens"][r] = tokens[r, cursor[r]]
        ds, result = engine.generate(params, ds)
        for r in range(b):
            err_batch = max(err_batch, float(
                (result.logits[r] - full[r, cursor[r]]).abs().max()))
            cursor[r] += 1
    print(f"mixed-phase batch (offsets {offsets}) through one generate "
          f"step == offline: max |dlogit| = {err_batch:.2e}")
    if args.mode == "fp":
        print("fp: the middle block consumed strictly-past tokens — on a "
              "serving stack it runs while waiting for the next request "
              "token (the paper's 'precomputed' fraction).")
    return [err_session, err_batch]


if __name__ == "__main__":
    main()
