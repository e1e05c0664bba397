"""Serving driver: slot-based continuous batching through
``repro_torch.engine`` (port of ``repro.launch.serve``, dense path).

Requests are prefilled one by one (prompt lengths staggered by
``--stagger``, so slots may sit at different SOI phases) and inserted into
engine slots; one generate step then advances every slot per iteration.
Prompts pad to a bucket (``--bucket``, default "pow2") and are masked by
their true length. ``--phase-align`` delays each insert (at most stride-1
steps) until its slot lands in the batch's phase class.

The loop drains each step's tokens one step late: after dispatching step k
it reads step k-1's tokens, whose host copy was queued on the stream right
behind step k-1, so the read overlaps step k's work on the card.

Weights are random, from ``--seed``; ``--device`` defaults to the GPU.
``main(argv)`` returns the generated tokens (requests x gen_len).

    python -m repro_torch.launch.serve --arch qwen3-1.7b --soi pp \\
        --batch 4 --prompt-len 1024 --stagger 2 --gen-len 64
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.engine import SOIEngine
from repro_torch.models import transformer as T

# flags of the reference's driver that belong to later slices of the port
_LATER = ("paged", "page_size", "chunk_size", "prefix_cache", "shared_prefix",
          "speculate", "mixed_spec", "trace_out", "metrics_out")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=configs.ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--soi", default=None, choices=["pp", "fp"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=64)
    ap.add_argument("--stagger", type=int, default=1,
                    help="request i's prompt is shortened by i*stagger "
                         "tokens (mixed SOI phases in one batch; 0 = "
                         "aligned)")
    ap.add_argument("--bucket", default="pow2",
                    help="prefill bucket policy: 'pow2' (default), 'none' "
                         "(exact length), or comma-separated lengths")
    ap.add_argument("--phase-align", action="store_true",
                    help="phase-aligned admission: delay each insert (at "
                         "most stride-1 decode steps) until its slot lands "
                         "in the batch's t %% stride phase class")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (plain kernels)")
    for name in _LATER:
        ap.add_argument("--" + name.replace("_", "-"), default=None,
                        nargs="?", const=True, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for name in _LATER:
        if getattr(args, name) is not None:
            raise NotImplementedError(
                f"--{name.replace('_', '-')} is not ported yet; see "
                f"ROADMAP.md")
    return args


@dataclasses.dataclass
class ServeResult:
    seqs: np.ndarray            # (admitted requests, gen_len) token ids
    plens: list                 # prompt length of every request
    prefill_s: float            # host clock, prefill + insert of all
    decode_s: float             # host clock, the decode loop
    decoded: int                # tokens produced by generate steps
    steps: int                  # generate steps
    mid_steps: int              # steps in which the SOI middle ran


def serve(engine: SOIEngine, params, prompt, plens, gen_len: int, *,
          phase_align: bool = False) -> ServeResult:
    """Serve ``len(plens)`` requests (request i is ``prompt[i, :plens[i]]``)
    to ``gen_len`` tokens each; returns their tokens and the loop's
    counters."""
    b = len(plens)
    state = engine.init_decode_state(params)
    steps0, mid0 = engine.steps, engine.mid_steps
    out: dict = {}
    admitted: list = []
    pendq = list(range(b))

    def admit_ready(state):
        for slot in list(pendq):
            if phase_align and not engine.can_insert(plens[slot], slot,
                                                     phase_align=True):
                continue
            pendq.remove(slot)
            prefix = engine.prefill(params, prompt[slot, :plens[slot]])
            state = engine.insert(prefix, state, slot)
            out[slot] = [int(prefix.first_token[0])]
            admitted.append(slot)
        return state

    t0 = time.perf_counter()
    state = admit_ready(state)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    prefill_s = time.perf_counter() - t0

    def drain(res, snapshot, state, done):
        res = res.convert_to_numpy()
        for slot in snapshot:
            if len(out[slot]) < gen_len:
                out[slot].append(int(res.get_result_at_slot(slot).tokens[0]))
                if len(out[slot]) == gen_len:
                    state = engine.free_slot(state, slot)
                    done += 1
        return state, done

    t0 = time.perf_counter()
    done = 0
    pending = None
    stride = engine.cfg.soi.stride if engine.cfg.soi is not None else 1
    for _ in range(gen_len - 1 + (len(pendq) + 1) * stride):
        state = admit_ready(state)
        snapshot = list(admitted)
        state, result = engine.generate(params, state)
        if pending is not None:
            state, done = drain(*pending, state, done)
            if done == len(admitted) and not pendq:
                pending = None
                break
        pending = (result, snapshot)
    if pending is not None:
        state, done = drain(*pending, state, done)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    decode_s = time.perf_counter() - t0
    for slot in pendq:
        print(f"request {slot} not admitted within the phase-align step "
              f"budget")
    seqs = np.stack([np.asarray(out[s][:gen_len]) for s in admitted])
    decoded = sum(len(v) for v in out.values()) - len(admitted)
    return ServeResult(seqs, list(plens), prefill_s, decode_s, decoded,
                       engine.steps - steps0, engine.mid_steps - mid0)


def run(args: argparse.Namespace) -> ServeResult:
    """Build the config, random weights, prompts and engine of ``args`` and
    serve them."""
    device = resolve_device(args.device)
    if args.bucket == "pow2":
        buckets = "pow2"
    elif args.bucket == "none":
        buckets = None
    else:
        buckets = tuple(int(x) for x in args.bucket.split(","))
    cfg = (configs.get_smoke(args.arch, soi=args.soi) if args.smoke
           else configs.get(args.arch, soi=args.soi))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.cast_params(
        T.init(cfg, generator=gen, device=device, dtype=T._dtype(cfg)), cfg)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=device, dtype=torch.int32)
    plens = [max(1, args.prompt_len - i * args.stagger)
             for i in range(args.batch)]
    engine = SOIEngine(cfg, max_concurrent_decodes=args.batch,
                       max_len=args.prompt_len + args.gen_len,
                       device=device, prefill_buckets=buckets)
    res = serve(engine, params, prompt, plens, args.gen_len,
                phase_align=args.phase_align)
    print(f"arch={cfg.name} soi={args.soi or 'off'} device={device}  "
          f"prefill {len(res.seqs)}/{args.batch} reqs (lens {plens}) in "
          f"{res.prefill_s:.3f}s [bucket={args.bucket}], decoded "
          f"{res.decoded} tok in {res.steps} steps "
          f"({res.mid_steps} with the middle) in {res.decode_s:.3f}s "
          f"({res.decoded / max(res.decode_s, 1e-9):.1f} tok/s decode)")
    print("sample:", res.seqs[0, :16].tolist())
    return res


def main(argv=None):
    return run(parse_args(argv)).seqs


if __name__ == "__main__":
    main()
