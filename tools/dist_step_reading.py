"""Where the sharded train step's extra host time goes, at world size 1.

    python3 tools/dist_step_reading.py

On one card over NCCL (a HashStore process group of one rank, a (1, 1)
("data", "model") mesh): qwen3-1.7b at full width and depth, SOI pp, bf16
over float32 masters, B 8 x S 128 (chip_smoke.py phase 17's batch). The
plain ``make_train_step`` and the sharded one on the mesh take turns,
plain / sharded / sharded / plain, each a fresh model from the same seed,
2 warm steps then 8 timed (host clock after a synchronize); then:

  * the collectives and ``to_local`` calls one sharded step makes (a
    profiled step's host records), and the host time of that many
    all-reduces and ``to_local`` calls alone, timed in a loop;
  * the device busy time of one step of each (the profiler's kernels);
  * the host ops of one step of each that take the most self CPU time
    (the profiler's CPU records; it adds its own cost to each op).

Prints the card's name and power limit on each result line.
"""

from __future__ import annotations

import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

WARM, TIMED = 2, 8


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def _busy_ms(fn) -> float:
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


def main():
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.data.pipeline import ShardedLMPipeline
    from repro_torch.distributed.sharding import ShardingRules, shard_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import local_batch, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = _card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    mesh = make_mesh((1, 1), ("data", "model"))
    rules = ShardingRules(data_axes=("data",))
    cfg = configs.get("qwen3-1.7b", soi="pp")
    pipe = ShardedLMPipeline(global_batch=8, seq_len=128, vocab=cfg.vocab,
                             seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in pipe.batch(i).items()}
               for i in range(WARM + TIMED)]
    kw = dict(peak_lr=1e-3, warmup=20, total_steps=30)

    def build(sharded: bool):
        model = T.init(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(0), device=dev)
        if sharded:
            model = shard_params(model, rules, mesh)
            step = make_train_step(cfg, rules, mesh, **kw)
        else:
            step = make_train_step(cfg, **kw)
        opt = adamw_init(dict(model.named_parameters()))
        return model, opt, step

    def timed(sharded: bool) -> tuple:
        model, opt, step = build(sharded)
        times = []
        for i, bt in enumerate(batches):
            bt = local_batch(bt, mesh) if sharded else bt
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            step(model, opt, bt)
            torch.cuda.synchronize(dev)
            if i >= WARM:
                times.append((time.perf_counter() - t0) * 1e3)
        busy = _busy_ms(lambda: step(model, opt, local_batch(
            batches[0], mesh) if sharded else batches[0]))
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(model, opt, local_batch(batches[0], mesh) if sharded
                 else batches[0])
            torch.cuda.synchronize(dev)
        top = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
        total = sum(a.self_cpu_time_total for a in prof.key_averages())
        print(f"  host ops of one {'sharded' if sharded else 'plain'} step "
              f"(profiled, {total / 1e3:.1f} ms self CPU in all): " + "; ".join(
                  f"{a.key} {a.count}x {a.self_cpu_time_total / 1e3:.1f} ms"
                  for a in top[:12]), flush=True)
        extra = {}
        if sharded:
            names = Counter(e.name for e in prof.events())
            extra = {"nccl:all_reduce": names.get("nccl:all_reduce", 0),
                     "to_local": sum(1 for p in model.parameters())}
        del model, opt, step
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        return sorted(times)[len(times) // 2], times, busy, extra

    runs = []
    for sharded in (False, True, True, False):
        med, times, busy, extra = timed(sharded)
        label = "sharded" if sharded else "plain"
        runs.append((label, med, extra))
        print(f"{label:8s} step median {med:.2f} ms of {TIMED} "
              f"({min(times):.2f}..{max(times):.2f}); device busy "
              f"{busy:.2f} ms a step [{card}]", flush=True)
    extra = next(e for _l, _m, e in runs if e)
    n_ar = extra["nccl:all_reduce"]

    # the host cost of that many collectives and to_local calls alone
    g = mesh.get_group("data")
    small = [torch.zeros(16, device=dev) for _ in range(n_ar)]
    for t in small[:8]:
        dist.all_reduce(t, group=g)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for t in small:
        dist.all_reduce(t, group=g)
    torch.cuda.synchronize(dev)
    ar_ms = (time.perf_counter() - t0) * 1e3
    model = shard_params(T.init(cfg, generator=torch.Generator(device=dev)
                                .manual_seed(0), device=dev), rules, mesh)
    params = list(model.parameters())
    t0 = time.perf_counter()
    for _ in range(3):
        for p in params:
            p.to_local().detach()
    tl_ms = (time.perf_counter() - t0) * 1e3 / 3
    print(f"one sharded step: {n_ar} NCCL all-reduces on the host, "
          f"{len(params)} to_local; alone: {n_ar} all-reduces of 16 floats "
          f"{ar_ms:.2f} ms ({ar_ms / n_ar * 1e3:.1f} us each), "
          f"{len(params)} to_local {tl_ms:.2f} ms [{card}]", flush=True)
    plain = sorted(m for l_, m, _e in runs if l_ == "plain")
    sharded = sorted(m for l_, m, _e in runs if l_ == "sharded")
    print(f"medians plain {plain}, sharded {sharded}: sharded - plain "
          f"{sharded[0] - plain[-1]:.2f}..{sharded[-1] - plain[0]:.2f} ms "
          f"[{card}]")
    del model, params
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
