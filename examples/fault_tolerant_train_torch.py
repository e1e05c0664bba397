"""Fault tolerance end to end on the PyTorch port: train under the
supervisor, kill the "node" at step 37 of 60 (simulated), watch it restore
from the latest atomic checkpoint and finish; then restore the result onto
another device (elastic: onto the CPU when training ran on the card; a run
on the CPU restores into a fresh state there).

    PYTHONPATH=src python examples/fault_tolerant_train_torch.py \\
        [--device cpu] [--steps 60]
"""

import argparse
import tempfile

import torch

from repro_torch import configs as C
from repro_torch import resolve_device
from repro_torch.data.pipeline import ShardedLMPipeline
from repro_torch.distributed.fault_tolerance import (SupervisorConfig,
                                                     TrainSupervisor,
                                                     elastic_restore)
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    crash_at = min(37, args.steps - 1)
    cfg = C.get_smoke("qwen3-1.7b")
    pipe = ShardedLMPipeline(global_batch=4, seq_len=64, vocab=cfg.vocab)
    step = make_train_step(cfg, peak_lr=1e-3, warmup=5,
                           total_steps=args.steps)
    crash = {"armed": True}
    seen = []

    def step_fn(state, i):
        if i == crash_at and crash["armed"]:
            crash["armed"] = False
            raise RuntimeError(f"simulated node failure at step {i}")
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch(i).items()}
        p, o, m = step(state["params"], state["opt"], batch)
        seen.append((i, float(m["loss"])))
        return {"params": p, "opt": o}

    def make_state(device=dev):
        p = T.init(cfg, generator=torch.Generator(device=device)
                   .manual_seed(0), device=device)
        return {"params": p, "opt": adamw_init(dict(p.named_parameters()))}

    with tempfile.TemporaryDirectory() as ckpt:
        sup = TrainSupervisor(SupervisorConfig(ckpt_dir=ckpt, ckpt_every=10),
                              make_state, step_fn)
        state = sup.run(args.steps)
        print(f"finished with {sup.restarts} restart(s); events: "
              f"{[e[0] for e in sup.events]}")
        print(f"loss {seen[0][1]:.3f} -> {seen[-1][1]:.3f} (steps executed: "
              f"{len(seen)}, incl. replay after restore)")
        if sup.restarts != 1 or int(state["opt"]["count"]) != args.steps:
            raise RuntimeError(f"restarts {sup.restarts}, count "
                               f"{int(state['opt']['count'])}")

        # elastic restore onto another device
        other = torch.device("cpu") if dev.type == "cuda" else dev
        at, restored = elastic_restore(ckpt, make_state(other), other)
        same = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(
            state["params"].state_dict().values(),
            restored["params"].state_dict().values()))
        print(f"elastic restore onto {other}: step {at}, opt count "
              f"{int(restored['opt']['count'])}, params equal to the "
              f"trained ones: {same} — same bytes, new placement")
        if not same:
            raise RuntimeError("elastic restore differs from the state")


if __name__ == "__main__":
    main()
