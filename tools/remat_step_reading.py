"""What rematerialisation costs the train step, beside a tree without it.

    python3 tools/remat_step_reading.py [--src DIR] [--label NAME]
                                        [--remat on off ...]

On one card: qwen3-1.7b at full width and depth, SOI pp, bf16 over
float32 masters, ``make_train_step`` on seed 0's weights, at two shapes:
B 8 x S 128 (chip_smoke.py phase 17 (c)'s batch, where the step waits on
the host) and B 2 x S 4096 (phase 29 (a)'s, where it waits on the card).
For each shape, a fresh model and optimizer for each ``--remat`` value in
turn (``on``: ``cfg.remat``, the default ``"full"`` policy; ``dots``,
``names``: remat with that ``remat_policy``; ``off``: ``remat=False``),
2 warm steps, then 5 timed (host clock after a synchronize), the device
busy ms of one more step (the profiler's CUDA kernels, merged where they
overlap) and its peak GiB.

``--src DIR`` runs the package under ``DIR/src`` instead of this
checkout's: to compare with the parent, unpack it first (``mkdir -p
build/parent && git archive HEAD | tar -x -C build/parent``) and run
``--src build/parent --label parent --remat off`` (a tree without remat
ignores the flag), this tree, this tree, the parent again, in one call.
Prints one JSON line a run, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WARM, TIMED = 2, 5
SHAPES = ((8, 128), (2, 4096))


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def _busy_ms(fn) -> float:
    """Device busy ms of ``fn``'s CUDA kernels, merged where they
    overlap."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in ev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="the tree whose src/ package runs")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--remat", nargs="+", default=["on", "off"],
                    choices=["on", "off", "dots", "names"])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.src.resolve() / "src"))
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import ShardedLMPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = _card()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = configs.get("qwen3-1.7b", soi="pp")
    for b, s in SHAPES:
        pipe = ShardedLMPipeline(global_batch=b, seq_len=s,
                                 vocab=base.vocab, seed=0)
        batches = [{k: torch.from_numpy(v).to(dev)
                    for k, v in pipe.batch(i).items()}
                   for i in range(WARM + TIMED)]
        for remat in args.remat:
            cfg = dataclasses.replace(
                base, remat=remat != "off",
                remat_policy=remat if remat in ("dots", "names") else "full")
            model = T.init(cfg, generator=torch.Generator(device=dev)
                           .manual_seed(0), device=dev)
            opt = adamw_init(dict(model.named_parameters()))
            step = make_train_step(cfg, peak_lr=1e-3, warmup=20,
                                   total_steps=30)
            times = []
            for i, bt in enumerate(batches):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                step(model, opt, bt)
                torch.cuda.synchronize(dev)
                if i >= WARM:
                    times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.reset_peak_memory_stats(dev)
            busy = _busy_ms(lambda: step(model, opt, batches[0]))
            print(json.dumps({
                "tree": args.label, "remat": remat, "B": b, "S": s,
                "median_ms": sorted(times)[len(times) // 2],
                "times_ms": [round(t, 3) for t in times],
                "busy_ms": busy,
                "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                "card": card}), flush=True)
            del model, opt, step
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
