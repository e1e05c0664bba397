"""Serving driver: slot-based continuous batching through
``repro_torch.engine`` (port of ``repro.launch.serve``).

Requests are prefilled one by one (prompt lengths staggered by
``--stagger``, so slots may sit at different SOI phases) and inserted into
engine slots; one generate step then advances every slot per iteration.
Prompts pad to a bucket (``--bucket``, default "pow2") and are masked by
their true length, or, with ``--chunk-size C``, are prefilled C tokens at a
time. ``--paged`` keeps the KV caches in page pools (``--page-size``);
``--prefix-cache`` (with ``--paged --chunk-size``) shares the pages of
common prompt prefixes copy-on-write and skips their prefill, and
``--shared-prefix N`` makes every request share its first N prompt tokens.
A request the page pools cannot back is not admitted. ``--phase-align``
delays each insert (at most stride-1 steps) until its slot lands in the
batch's phase class. ``--speculate K`` serves through self-speculative
windows (K-1 off-phase draft steps verified against the true schedule: up
to K tokens a slot an engine call, the same greedy tokens);
``--mixed-spec`` opts every second request out, so speculative and plain
requests share the batch. The loop then takes each slot's first
``accepted`` tokens of a window, and the tail adds a ``speculative:`` line.

``--trace-out PATH`` writes a Chrome-trace JSON (open it in
ui.perfetto.dev) of every request's lifecycle spans (queued, prefill,
decode, one commit instant a drained step); ``--metrics-out PATH`` the
flat metrics JSON: the engine registry (the drained telemetry vectors'
counters, prefix-cache, speculative and pool gauges, the sanctioned
drains) and the spans' TTFT / TPOT / queue-wait percentiles. Either one
builds the engine with ``telemetry=True`` and adds a ``phase coherence:``
line to the tail (``repro_torch.obs``).

The loop drains each step's tokens one step late: after dispatching step k
it reads step k-1's tokens, whose host copy was queued on the stream right
behind step k-1, so the read overlaps step k's work on the card.

Weights are random, from ``--seed``; ``--device`` defaults to the GPU.
``--layers N`` cuts a full-size config to N layers at full width (the
first layers of the stack; SOI bounds follow the config's own rule).
``main(argv)`` returns the generated tokens (requests x gen_len).

    python -m repro_torch.launch.serve --arch qwen3-1.7b --soi pp \\
        --batch 4 --prompt-len 1024 --stagger 2 --gen-len 64 \\
        [--paged --page-size 16 --chunk-size 256 --prefix-cache \\
         --shared-prefix 768]
    python -m repro_torch.launch.serve --arch deepseek-v2-236b --layers 4 \\
        --soi pp --batch 4 --prompt-len 1024 --stagger 2 --gen-len 64 \\
        --paged --page-size 16
    python -m repro_torch.launch.serve --arch recurrentgemma-9b --soi pp \\
        --batch 4 --prompt-len 2040 --stagger 2 --gen-len 64 \\
        [--paged --page-size 16]

A config with MoE or RG-LRU blocks cannot mask pad: it prefills at the
exact prompt length whatever ``--bucket`` says, and ``--chunk-size`` (so
also ``--prefix-cache``) raises, as the reference's engine does.
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
from repro_torch.obs import (EngineTelemetry, MetricsRegistry, Tracer, now,
                             write_metrics, write_trace)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=configs.ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the full-size config to this many layers "
                         "(every width kept)")
    ap.add_argument("--soi", default=None, choices=["pp", "fp"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=64)
    ap.add_argument("--stagger", type=int, default=1,
                    help="request i's prompt is shortened by i*stagger "
                         "tokens (mixed SOI phases in one batch; 0 = "
                         "aligned)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV caches: shared page pools + per-slot page "
                         "lists instead of dense per-slot rings")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="chunked prefill: append this many tokens per "
                         "host-loop iteration (overrides --bucket)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="copy-on-write prefix page cache: share the KV and "
                         "compressed-middle pages of common prompt prefixes "
                         "and skip their prefill (needs --paged "
                         "--chunk-size)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="make every request share its first N prompt "
                         "tokens (system-prompt traffic)")
    ap.add_argument("--bucket", default="pow2",
                    help="prefill bucket policy: 'pow2' (default), 'none' "
                         "(exact length), or comma-separated lengths")
    ap.add_argument("--speculate", type=int, default=None, metavar="K",
                    help="self-speculative decoding: draft K-1 tokens with "
                         "off-phase SOI steps and verify them against the "
                         "true phase schedule in one window — up to K "
                         "tokens commit an engine call, greedy tokens "
                         "identical to per-token serving")
    ap.add_argument("--mixed-spec", action="store_true",
                    help="with --speculate: opt every second request out "
                         "of speculation (a mixed speculative/plain batch)")
    ap.add_argument("--phase-align", action="store_true",
                    help="phase-aligned admission: delay each insert (at "
                         "most stride-1 decode steps) until its slot lands "
                         "in the batch's t %% stride phase class")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Perfetto-openable Chrome-trace JSON of "
                         "per-request lifecycle spans; implies engine "
                         "telemetry")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the flat metrics JSON (registry snapshot + "
                         "TTFT/TPOT percentiles); implies engine telemetry")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (plain kernels)")
    return ap.parse_args(argv)


@dataclasses.dataclass
class ServeResult:
    seqs: np.ndarray            # (admitted requests, gen_len) token ids
    plens: list                 # prompt length of every request
    prefill_s: float            # host clock, prefill + insert of all
    decode_s: float             # host clock, the decode loop
    decoded: int                # tokens produced by generate steps
    steps: int                  # generate steps
    mid_steps: int              # steps in which the SOI middle ran
    prefix_cache: dict          # engine.prefix_cache_stats ({} if off)
    pools: dict                 # engine.pool_stats() ({} if dense)
    cow_flushes: int            # COW flushes that copied pages
    spec: dict = dataclasses.field(default_factory=dict)
    #                             engine.spec_accept_stats() ({} if off)
    tracer: Tracer = dataclasses.field(default_factory=Tracer)
    #                             each request's spans (request id = slot)


def serve(engine: SOIEngine, params, prompt, plens, gen_len: int, *,
          phase_align: bool = False, mixed_spec: bool = False,
          telemetry: EngineTelemetry | None = None) -> ServeResult:
    """Serve ``len(plens)`` requests (request i is ``prompt[i, :plens[i]]``)
    to ``gen_len`` tokens each; returns their tokens and the loop's
    counters. ``mixed_spec`` (a speculative engine) opts every odd request
    out of speculation. The result's ``tracer`` holds each request's spans
    (request id = its slot, queued at the loop's start); ``telemetry``
    takes every drained result."""
    b = len(plens)
    state = engine.init_decode_state(params)
    steps0, mid0, flush0 = engine.steps, engine.mid_steps, engine.cow_flushes
    out: dict = {}
    admitted: list = []
    pendq = []
    t_queued = now()
    tracer = Tracer()
    traces = {slot: tracer.request(slot, t_queued=t_queued)
              for slot in range(b)}
    for slot in range(b):
        # a request the page pools cannot back now is not admitted, rather
        # than crashing into a half-released slot mid-insert
        if engine.can_insert(plens[slot], slot):
            pendq.append(slot)
        else:
            print(f"request {slot} deferred: the page pools cannot back "
                  f"{plens[slot]} tokens")

    def admit_ready(state):
        for slot in list(pendq):
            if phase_align and not engine.can_insert(plens[slot], slot,
                                                     phase_align=True):
                continue
            pendq.remove(slot)
            tr = traces[slot]
            hits0 = engine.prefix_cache_stats["hits"]
            tr.mark_prefill_start(plens[slot])
            prefix = engine.prefill(params, prompt[slot, :plens[slot]])
            tr.mark_prefill_end(
                cache_hit=engine.prefix_cache_stats["hits"] > hits0,
                tokens_skipped=(prefix.cache_meta or {}).get("hit", 0))
            spec = slot % 2 == 0 if mixed_spec else None
            state = engine.insert(prefix, state, slot, speculate=spec)
            tr.mark_inserted()
            out[slot] = [int(prefix.first_token[0])]
            tr.mark_first_token()
            admitted.append(slot)
        return state

    t0 = time.perf_counter()
    state = admit_ready(state)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    prefill_s = time.perf_counter() - t0

    def drain(res, snapshot, state, done):
        res = res.convert_to_numpy()
        if telemetry is not None:
            telemetry.observe_result(res)
        for slot in snapshot:
            if len(out[slot]) < gen_len:
                sd = res.get_result_at_slot(slot)
                # a speculative window commits its first ``accepted``
                # tokens of up to K
                n = 1 if sd.accepted is None else int(sd.accepted[0])
                got = min(n, gen_len - len(out[slot]))
                out[slot].extend(int(x) for x in sd.tokens[:got])
                if got:
                    traces[slot].mark_decode(got)
                if len(out[slot]) == gen_len:
                    traces[slot].mark_done()
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
    pc = engine.prefix_cache_stats if engine.prefix_cache_enabled else {}
    spec = engine.spec_accept_stats() if engine.speculate else {}
    return ServeResult(seqs, list(plens), prefill_s, decode_s, decoded,
                       engine.steps - steps0, engine.mid_steps - mid0, pc,
                       engine.pool_stats(), engine.cow_flushes - flush0,
                       spec, tracer)


def setup(args: argparse.Namespace, cfg=None):
    """The config, random weights (from ``--seed``), prompts, prompt
    lengths and engine of ``args``: ``(cfg, params, prompt, plens,
    engine)``. ``cfg`` replaces the config ``--arch`` names (a stack that
    is no registered architecture, e.g. deepseek-v2's MLA block with its
    dense MLP); everything else still comes from ``args``."""
    device = resolve_device(args.device)
    if args.bucket == "pow2":
        buckets = "pow2"
    elif args.bucket == "none":
        buckets = None
    else:
        buckets = tuple(int(x) for x in args.bucket.split(","))
    if args.smoke and args.layers:
        raise ValueError("--layers cuts a full-size config; the smoke "
                         "configs have their own depth")
    if cfg is None:
        cfg = (configs.get_smoke(args.arch, soi=args.soi) if args.smoke
               else configs.get(args.arch, soi=args.soi,
                                n_layers=args.layers))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.cast_params(
        T.init(cfg, generator=gen, device=device, dtype=T._dtype(cfg)), cfg)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=device, dtype=torch.int32)
    if args.shared_prefix:
        n = min(args.shared_prefix, args.prompt_len)
        prompt[:, :n] = prompt[0, :n]
    plens = [max(1, args.prompt_len - i * args.stagger)
             for i in range(args.batch)]
    engine = SOIEngine(cfg, max_concurrent_decodes=args.batch,
                       max_len=args.prompt_len + args.gen_len,
                       device=device, paged=args.paged,
                       page_size=args.page_size, prefill_buckets=buckets,
                       prefill_chunk=args.chunk_size,
                       prefix_cache=args.prefix_cache,
                       speculate=args.speculate,
                       telemetry=bool(args.trace_out or args.metrics_out))
    return cfg, params, prompt, plens, engine


def run(args: argparse.Namespace, cfg=None) -> ServeResult:
    """Build the config (``cfg`` if given), random weights, prompts and
    engine of ``args`` and serve them."""
    cfg, params, prompt, plens, engine = setup(args, cfg)
    registry = telemetry = None
    if engine.telemetry:
        registry = MetricsRegistry()
        telemetry = EngineTelemetry(
            cfg.soi.stride if cfg.soi is not None else 1, registry=registry)
    res = serve(engine, params, prompt, plens, args.gen_len,
                phase_align=args.phase_align,
                mixed_spec=bool(args.speculate and args.mixed_spec),
                telemetry=telemetry)
    device = engine.device
    layout = (f"paged(page {args.page_size})" if args.paged else "dense")
    prefill_by = (f"chunk={args.chunk_size}" if args.chunk_size
                  else f"bucket={args.bucket}")
    tail = (f"arch={cfg.name} soi={args.soi or 'off'} device={device} "
            f"{layout}  prefill {len(res.seqs)}/{args.batch} reqs (lens "
            f"{plens}) in {res.prefill_s:.3f}s [{prefill_by}], decoded "
            f"{res.decoded} tok in "
            + (f"{res.spec['windows']} windows" if res.spec else
               f"{res.steps} steps ({res.mid_steps} with the middle)")
            + f" in {res.decode_s:.3f}s "
            f"({res.decoded / max(res.decode_s, 1e-9):.1f} tok/s decode)")
    if res.prefix_cache:
        pc = res.prefix_cache
        tail += (f"; prefix-cache {pc['hits']}/{pc['hits'] + pc['misses']} "
                 f"hits, {pc['tokens_skipped']} prompt tokens skipped, "
                 f"{pc['pages_shared']} pages shared, {pc['cow_copies']} COW "
                 f"copies, {pc['evictions']} evictions, {pc['entries']} "
                 f"entries")
    for name, ps in res.pools.items():
        tail += (f"; {name} pool {ps['used']}/{ps['n_pages']} pages used "
                 f"(high water {ps['high_water']})")
    print(tail)
    if res.spec:
        sp = res.spec
        print(f"speculative: K={sp['speculate']}, {sp['windows']} windows, "
              f"{sp['committed']} tokens committed "
              f"({sp['tokens_per_window']:.2f} tokens/window), "
              f"draft accept rate {100 * sp['accept_rate']:.0f}% "
              f"({sp['draft_accepted']}/{sp['draft_candidates']})")
    if telemetry is not None:
        telemetry.snapshot_engine(engine)
        coh = telemetry.phase_coherence()
        print(f"phase coherence: {100 * coh['coherent_step_rate']:.0f}% of "
              f"active steps fully aligned (modal-bucket slot fraction "
              f"{coh['modal_fraction_mean']:.2f}; "
              f"--phase-align {'on' if args.phase_align else 'off'})")
        if args.trace_out:
            write_trace(res.tracer, args.trace_out)
            print(f"trace written to {args.trace_out} "
                  f"(open in ui.perfetto.dev)")
        if args.metrics_out:
            write_metrics(args.metrics_out, registry=registry,
                          tracer=res.tracer)
            print(f"metrics written to {args.metrics_out}")
    print("sample:", res.seqs[0, :16].tolist())
    return res


def main(argv=None):
    return run(parse_args(argv)).seqs


if __name__ == "__main__":
    main()
