"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (sm_90a, H100).

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device  — needs a CUDA device; prints the card's name and power limit;
             sets the two TF32 switches off (float32 stays float32).
2. build   — builds every kernel under src/repro_torch/kernels/csrc with
             nvcc; prints the build seconds and ptxas' register, shared
             memory and spill lines of the serving path's instantiations.
3. kernels — each CUDA kernel at the serving path's shapes, bfloat16 and
             float32, against its plain PyTorch version on the card
             (max|Δ| < 2e-2 bf16, < 2e-5 f32; the bf16 decode reads
             within 2^-6 of their largest output; copy_pages bit-exact,
             and lru_scan bit-exact in f32), with
             its time, the plain version's and that of one PyTorch call
             computing the same function (a yardstick only) — device time
             from torch.profiler, and CUDA-event time per call beside it —
             and the least time the card could take (bytes or operations).
             The paged decode read must equal the dense kernel over the
             gathered view bit for bit, and the bf16 (tensor-core) results
             of flash_attention and of both decode reads a second launch
             on the same inputs; the decode reads also print their split
             of S, the device ms of the split kernel and the combine
             apart, and their host ms a call; at recurrentgemma's shapes
             every split's partial must count once at its weight (q = 0,
             V marking each row's split). The chunk kernels (qwen3's
             chunk_attention and deepseek-v2's mla_chunk_attention at the
             outer and middle chunks, every query at a real position as
             the serving path sends them) are held in bf16 to 2^-6 of
             their largest output too, repeat bit for bit, and end the
             phase with a table: ms beside SDPA, plain and bound, max|Δ|,
             blocks, the key tiles skipped and walked again (counted by
             the kernels on the card, in a launch that must give the
             wrapper's bits), chunk_attention's split of the keys, and
             ptxas' lines; the outer chunks with 6 pad queries at -1 are
             held too, not timed. recurrentgemma's shapes:
             the decode reads at G 16 / dh 256 on wrapped rings of 2048
             with the window, lru_scan at (1, 2040, 4096) and (1, 1020,
             4096), with h0, at an odd shape (the edge path) and at B 4
             (more chains than SMs), launched twice and held bit for bit,
             with its plan (chain-warps, warps a block, stages, T) and host
             ms a call (no library yardstick: no single PyTorch call
             computes the recurrence). stmc_conv at the
             streaming U-Net's shapes, float32 and bfloat16 (torch.addmm as
             the yardstick), launched twice and held bit for bit, with its
             plan (blocks, cluster size, columns a block); the paged MLA
             read in bf16 prints its split of S and blocks, its split
             kernel and combine apart and its host ms a call, as the decode
             reads do. A table of the kernels this slice redesigned
             (lru_scan, copy_pages) follows the chunk table; then a whole
             COW flush of qwen3's serving pools (28 layers x (k, v, pos),
             4 real and 4 padding pairs a table) and an MLA flush (latent,
             rope, pos) in one copy_pages_leaves launch, held bit for bit
             leaf by leaf, timed against one launch a leaf, the indexed
             assignment a leaf and the bytes' bound (device ms with the
             kernel and the table's upload apart, host ms a call); then
             stmc_conv in float32 at B 1 on each of the 14 convs of
             soi-unet-dns beside addmm and the bound, and their sum
             against the bound of a frame's weights.
4. parity  — full-width qwen3-1.7b cut to 4 layers (SOI over layers 1..3),
             float32, pp and fp: the port's SOIEngine with 3 slots (prompts
             of 200 and 201 tokens, a third of 150 after 3 steps), 8 greedy
             steps on the card and on the CPU: logits within 1e-3, tokens
             identical. Then, in pp, a paged chunked prefix-cache engine
             (page 16, chunk 64, max_len 256): 3 prompts of ~200 tokens
             sharing their first 128, 66 greedy steps, so every ring wraps
             onto shared pages and copies them on write — tokens identical,
             logits within 1e-3, prefix-cache counters equal, COW on the
             card through copy_pages: one launch a flush, held to the
             engine's count of flushes (equal on the card and the CPU).
5. serve   — the serving driver on full-width qwen3-1.7b, SOI pp, 4
             requests of 1024..1018 tokens, 64 generated each, dense rings
             and bucketed prefill; every kernel launch is counted and held
             to the count the host clocks give. A second, profiled run
             (the serve loop alone, weights built outside it) gives the
             prefill window's device busy time, idle share and
             flash_attention time, and the decode loop's busy time and
             idle share, each with its kernel time by name.
6. paged   — the same traffic with a shared 768-token prefix through
             --paged --chunk-size 256 --prefix-cache: prefix-cache counters
             and chunk/paged-decode launch counts held to their expected
             values (copy_pages to the engine's COW flushes), tokens
             identical to the same command without the
             prefix cache, then a profiled rerun as in phase 5 (the
             prefill window and chunk_attention's device ms a request in
             it, the decode loop).
7. ds-parity — full-width deepseek-v2 cut to 2 layers (dense layer 0
             before the SOI middle, one MoE layer of 160 experts as the
             middle), float32, SOI pp: dense and paged engines with 3 slots
             (prompts of 41 and 43 tokens, a third of 37 after 3 steps), 8
             greedy steps on the card and on the CPU: logits within 1e-3,
             tokens identical; the card's paged run goes through
             paged_mla_decode_attention, its prefills through the d_qk 192 /
             d_v 128 flash_attention.
8. ds-serve — the serving driver on full-width deepseek-v2 cut to 4 layers
             (1 dense + 3 MoE), bfloat16, SOI pp, 4 requests of
             1024..1018 tokens, 64 generated each, --paged --page-size 16,
             exact-length prefill: flash_attention and
             paged_mla_decode_attention launches held to 16 and 192; step
             time at SOI phase 0 against off-phase steps (host clock after
             a synchronize); a profiled rerun for the prefill window (busy
             time, idle share, flash_attention time) and the decode
             loop's idle share and paged MLA read's device ms a step
             (split kernel and combine apart).
9. mla     — deepseek-v2's layer-0 block (MLA + SwiGLU 12288) at full
             width, SOI pp. Card against CPU in float32 (2 layers): a
             paged, chunked prefix-cache engine whose rings wrap onto
             shared pages and copy the MLA pools on write — tokens
             identical, logits within 1e-3, counters equal, copy_pages
             launched once a COW flush. Then the serve
             traffic of phase 6 through 4 bfloat16 layers: mla_chunk
             attention launches held to 28 (4 layers x 7 computed chunks),
             prefix-cache counters, warm against cold bit for bit, and a
             profiled rerun (the prefill window with mla_chunk_attention's
             device ms a request, the decode loop).
10. rg-parity — full-width recurrentgemma-9b cut to 12 layers (SOI pre
             0..2, middle 3..8, post 9..11; 8 RG-LRU and 4 windowed MQA
             layers), float32, pp and fp, dense and paged (page 16): 3 slots
             (prompts of 41 and 43 tokens, a third of 37 after 3 steps), 8
             greedy steps on the card and on the CPU: logits within 1e-3,
             tokens identical; lru_scan launched 8 times a prefill, the
             decode reads at the count the host clocks give.
11. rg-serve — the serving driver on full-depth recurrentgemma-9b (38
             layers), bfloat16, SOI pp, 4 requests of 2040..2034 tokens, 64
             generated each, so every outer ring (window 2048) wraps: dense,
             then --paged --page-size 16, exact-length prefill; lru_scan
             held to 104 launches, decode_attention / paged_decode_attention
             to 576, flash_attention to 0; tokens identical between the
             layouts; step time at SOI phase 0 against off-phase steps; a
             profiled rerun of each layout, with the prefill window's busy
             time, idle share and lru_scan's device ms a request, and the
             decode reads' device ms a step (split kernel and combine
             apart).
12. unet-parity — the paper's streaming U-Net, full-width soi-unet-dns
             (7 + 7 causal convs, K 3, 128 channels in and out, widths 616..
             1296), float32, B 2, 48 frames, for the 11 SOI configurations of
             tests/test_soi_unet.py: the stream on the card against the
             stream on the CPU and against apply_offline on the card
             (max|Δ| < 1e-4 each); stmc_conv launched exactly as often as
             the phase plans compute convs.
13. unet-stream — the same model, 512 frames (8.2 s of audio at 62.5 fps),
             at B 1 (one live stream) and B 32 (a server of many streams),
             for the STMC baseline, PP S-CC (3,), PP 2xS-CC (1,3) and FP
             SS-CC (3,): stmc_conv launches held to the phase plans (7168 /
             4608 / 2304 / 4608); median step time per phase (host clock
             after a synchronize), frames/s, the real-time factor against
             16 ms a frame, the MAC retain beside the measured step-time
             ratio to the baseline, peak device memory, and from a profiled
             rerun the idle share, kernel time by name and stmc_conv's
             device ms a frame.
14. graphs  — the captured step graphs (``engine.contracts.CheckedGraph``:
             on the card ``SOIEngine.generate`` replays one CUDA graph per
             SOI branch, ``unet_stream_session`` one per phase, as in phases
             4-13) against the eager steps, bit for bit: the graphed engine
             against an eager twin (a deep copy of the engine and its state,
             whose step runs ``generate_step`` eagerly) — tokens and logits
             every step, every leaf of the decode state at the end — for
             qwen3 at 4 layers in f32 (pp and fp dense; pp paged with
             chunked prefill and the prefix cache, 60 steps, so COW flushes
             run between replays), deepseek-v2 at 2 layers (bf16, paged) and
             recurrentgemma-9b at 12 (bf16, dense and paged); 2 captures an
             engine, none in steady state; a rebound >= 16 KiB state leaf
             raises DroppedDonationError and another params object
             ValueError before a replay. The U-Net session against the eager
             steppers at B 1 and B 32 for phase 13's configs, every frame
             and the final state bit for bit, stmc_conv launched as planned.
             Timing, graphed against eager from one state in the same
             process: full-width qwen3-1.7b at phase 5's traffic (64 steps
             each, interleaved: median step, with and without the middle;
             a profiled window of 16 steps: busy ms a step, idle share,
             device kernels a step, the decode reads on the device equal
             to the replays' count), and soi-unet-dns at B 1 and B 32, STMC
             baseline and PP S-CC (3,) (192 frames each: median step per
             phase, real-time factor, step ratio beside the MAC retain; 64
             profiled frames: busy, idle share, stmc_conv kernels on the
             device equal to the count); each graph's capture time, pool
             bytes and copy-back bytes.
15. spec    — self-speculative windows (``SOIEngine(speculate=4)``: K-1
             draft steps, the restore of the rows they wrote and K verify
             steps, one CUDA graph a window key). (a) qwen3 at 4 layers,
             f32, dense and paged with the prefix cache: a rejection forced
             at every depth n through ``verify_commit`` on the card and on
             the CPU — committed tokens equal, logits within 1e-3, the
             card's state bit for bit that of n sequential card steps (the
             null page aside). (b) full-width qwen3-1.7b bf16 through
             launch/serve.py at phase 5's traffic with --speculate 4, then at
             phase 6's (paged, prefix cache) with --mixed-spec: tokens equal
             to phases 5 and 6 (or the first differing slot and step is
             named), decode-read launches equal to the windows' plans
             ((K-1)*14 + sum_j (14 + 14*mid_j) a window), copy_pages to the
             COW flushes, captures equal to the window keys; windows, tokens
             a window, accept rate, pool bytes, the draft's gathered bytes
             a window; then windows and plain graphed steps in turn from one
             prompt set (median ms, host clock after a synchronize; tokens/s
             of each) and a profiled stretch of windows (busy, idle share,
             device kernels, the decode reads on the device == counted).
16. obs     — the observability layer (``repro_torch.obs``) on full-width
             qwen3-1.7b bf16, SOI pp. (a) phase 5's traffic (dense, 64
             steps) through an engine with telemetry and one without, in
             one process: tokens equal, every drained metrics vector equal
             to the one the host computes from its clocks (mid_fired == the
             host's branch), one drain a step either way, the same captures
             and launches a replay; device kernels a step from a profiled
             window: off == phase 14's count (PERF.md records 2229), on adds
             the vector's (at most 8); median step with and without telemetry
             from 12 interleaved pairs of 8 drained steps, the least per-pair
             on/off ratio within the reference's 1.05. (b) ``run_load`` of
             ``make_trace(24, ...)`` (4 tenants, Zipf 1.1, 768-token tenant
             prefixes, suffixes 16..256, 16..64 generated, bursts at 4 Hz of
             mean 2) through a paged prefix-cache engine (4 slots, page 16,
             chunk 256, max_len 1152, telemetry), first-come then
             phase-aligned: every request completes, the cache hits,
             chunk_attention / paged_decode_attention / copy_pages launched
             as the spans and the engine's counters give them; TTFT, TPOT and
             queue-wait p50/p99, tok/s, hit rate, deferrals, off-phase rate by
             occupancy and coherence; the Chrome trace and metrics JSON
             written and read back. (c) phase 15's dense traffic with
             --speculate 4 --trace-out --metrics-out through launch/serve.py:
             phase 5's tokens, one accepted-count sample a slot a drained
             window. (d) the U-Net session (B 1, STMC baseline, 192 frames)
             with a registry: 192 pushes counted, frames bit for bit those
             without, the push dispatch latency.
17. the kernels JSON line (the decode reads and copy_pages also give their
             phase-15 launches under "spec"; the kernels phase 16 launches
             their launches there under "obs"), the card line, and last
             {"ok": true, ...}.

Phases 4-13, 15 and 16 run the engine and the U-Net session as a user does, so
on the card every generate step, window and frame after a branch's first is
a graph replay; the kernel launch counters (Python-side) get each graph's launches
added at every replay (``ops.add_launch_counts``), which is what their
checks hold. Phase 13 captures every phase before its timed frames.

Any failure raises and exits nonzero; no result line is printed then.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# the decode reads in bf16: at most four half-ulps of their largest output
# (an output is a mean of V rows, at recurrentgemma's read ~0.04 RMS)
READ_REL_TOL = 2.0 ** -6
L2_BYTES = 50 * 2 ** 20

SERVE_ARGV = ["--arch", "qwen3-1.7b", "--soi", "pp", "--batch", "4",
              "--prompt-len", "1024", "--stagger", "2", "--gen-len", "64",
              "--seed", "0"]
PAGED_ARGV = SERVE_ARGV + ["--paged", "--page-size", "16", "--chunk-size",
                           "256", "--shared-prefix", "768"]


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


# the script's start on the host clock: each phase line gives the seconds
# since, so a run shows what each phase costs of the time limit
T_START = time.perf_counter()


def phase(name):
    print(f"== {name} [{time.perf_counter() - T_START:.1f} s]", flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def device_phase():
    phase("1 device")
    check(torch.cuda.is_available(), "no CUDA device: chip_smoke.py needs "
                                     "an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; device 0 = {torch.cuda.get_device_name(0)}"
          f"; TF32 off")
    return card


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

# (label, needles) of the serving path's instantiations (head dim 128;
# decode reads at G = 2 query heads per KV head, and recurrentgemma's MQA at
# G 16 / dh 256): a compiled kernel is reported when its mangled name holds
# every needle (a mangled name carries an identifier's length before it)
PATH_KERNELS = (
    ("decode_attention", ("decode_mma_kernel", "DenseRows", "Li2ELi128E")),
    ("decode_attention", ("decode_scalar_kernel", "DenseRows",
                          "Li2ELi128E")),
    ("paged_decode_attention", ("decode_mma_kernel", "PagedRows",
                                "Li2ELi128E")),
    ("paged_decode_attention", ("decode_scalar_kernel", "PagedRows",
                                "Li2ELi128E")),
    ("decode_attention (MQA)", ("decode_mma_kernel", "DenseRows",
                                "Li16ELi256E")),
    ("decode_attention (MQA)", ("decode_scalar_kernel", "DenseRows",
                                "Li16ELi256E")),
    ("paged_decode_attention (MQA)", ("decode_mma_kernel", "PagedRows",
                                      "Li16ELi256E")),
    ("paged_decode_attention (MQA)", ("decode_scalar_kernel", "PagedRows",
                                      "Li16ELi256E")),
    ("decode reads' combine", ("decode_combine_kernel",)),
    ("flash_attention", ("22flash_attention_kernel", "Li128ELi128E")),
    ("flash_attention (MLA)", ("22flash_attention_kernel", "Li192ELi128E")),
    ("chunk_attention", ("22chunk_attention_kernel", "Li128E")),
    ("chunk_attention's merge", ("20chunk_combine_kernel", "Li128E")),
    ("chunk_attention, walk counted", ("17chunk_walk_kernel", "Li128E")),
    ("copy_pages", ("17copy_pages_kernel",)),
    ("mla_chunk_attention", ("26mla_chunk_attention_kernel",
                             "Li512ELi64E")),
    ("mla_chunk_attention, walk counted", ("21mla_chunk_walk_kernel",
                                           "Li512ELi64E")),
    ("paged_mla_decode_attention", ("33paged_mla_decode_attention_kernel",
                                    "Li512ELi64E")),
    ("lru_scan (ring)", ("15lru_scan_kernel", "Lb0E")),
    ("lru_scan (edge)", ("15lru_scan_kernel", "Lb1E")),
    ("stmc_conv (B 1)", ("16stmc_conv_kernel", "Li1E")),
    ("stmc_conv (B 32 tile)", ("16stmc_conv_kernel", "Li32E")),
)


def _ptxas_lines(log: str) -> list:
    """One line per compiled kernel of the serving path, from nvcc
    -Xptxas -v (a kernel compiled alike in two sources, once)."""
    out, name = [], None
    spill = ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            spill = (f"stack {m.group(1)} B, spill st/ld "
                     f"{m.group(2)}/{m.group(3)} B")
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            for kind, needles in PATH_KERNELS:
                if all(n in name for n in needles):
                    dt = ("bf16" if "bfloat16" in name
                          or "tensor_cores" in name else
                          "bytes" if kind == "copy_pages" else "f32")
                    smem = re.search(r"(\d+) bytes smem", line)
                    text = (f"  {kind}[{dt}]: {m.group(1)} registers, "
                            f"{smem.group(1) if smem else 0} B static "
                            f"smem, {spill}")
                    if text not in out:
                        out.append(text)
            name, spill = None, ""
    return out


def build_phase():
    phase("2 build")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info()
    took = time.perf_counter() - t0
    how = (f"built in {info.seconds:.2f} s" if info.seconds is not None
           else f"reused an existing build ({took:.2f} s to load)")
    print(f"kernels: {info.path.relative_to(ROOT)} {how}")
    lines = _ptxas_lines(info.log)
    check(lines or info.seconds is None, "no ptxas lines in the build log")
    for line in lines:
        print(line)


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------

def _copies(make, bytes_per_set: int):
    """Enough input sets that cycling through them exceeds the L2 cache:
    each launch finds its inputs cold, as the serving path does (every
    layer owns its caches)."""
    n = max(2, math.ceil(2 * L2_BYTES / max(bytes_per_set, 1)))
    return [make() for _ in range(min(n, 64))]


def _time_ms(fn, sets, iters: int) -> float:
    """Mean device time of ``fn(*args)`` over ``iters`` launches, cycling
    the argument sets; CUDA events after a warm-up."""
    for args in sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_ms(fn, sets, iters: int) -> float:
    """Host time per call of ``fn(*args)``: ``iters`` calls enqueued back to
    back after a warm-up and a synchronize, on the host clock, the
    synchronize that drains them left out (a few ms of device work: the
    launch queue never fills, so no call waits on the card)."""
    for args in sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def _split_coverage(kern, plain, args, plan, label) -> float:
    """Every split of a decode read counts once, at its weight: with q = 0
    each live key scores alike, so the read is V's mean over its live keys;
    V row s holds ``n_split`` in column ``s // keys_per_split`` (its split)
    and 0 elsewhere, so column j of the output is ``n_split`` times split
    j's share of the live keys (1 where all keys are live). A split
    dropped, counted twice or weighed wrongly moves its column by its
    whole share. Dense ``(q, k, v, pos, t)`` or paged ``(q, k_pool, v_pool,
    pos_pool, page_map, t)`` arguments; returns max|kernel - plain|."""
    n_split, keys = plan[:2]
    v = torch.zeros_like(args[2])
    check(n_split <= v.shape[-1], f"{label}: {n_split} splits > dh")
    if len(args) == 5:
        rows = torch.arange(v.shape[1], device=v.device)
        v[:, rows, :, rows // keys] = n_split
    else:
        p_sz, pmap = v.shape[1], args[4]
        rows = torch.arange(pmap.shape[1] * p_sz, device=v.device)
        pages = pmap[:, rows // p_sz].long()            # (B, S) pool pages
        v[pages, (rows % p_sz).expand_as(pages), :,
          (rows // keys).expand_as(pages)] = n_split
    case = (torch.zeros_like(args[0]), args[1], v) + tuple(args[3:])
    got = kern(*case).float()
    want = plain(*case).float()
    # the columns of the splits hold all the mass, n_split a head (float32:
    # no rounding)
    totals = plain(*(x.float() if x.is_floating_point() else x
                     for x in case))[..., :n_split].sum(-1)
    check(bool(torch.allclose(totals, torch.full_like(totals, n_split),
                              rtol=1e-5)),
          f"{label}: the coverage input does not reach every split")
    err = float((got - want).abs().max())
    tol = min(TOL[args[0].dtype], READ_REL_TOL * float(want.abs().max()))
    check(err < tol, f"{label}: split coverage max|Δ| {err} >= {tol} (a "
                     f"split's partial lost, repeated or misweighted)")
    return err


def _device_events(fn) -> list:
    """Run ``fn`` under torch.profiler with CUDA activity only; returns the
    device intervals (start µs, end µs, name) of its kernels and copies,
    sorted by start."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == cuda)


def _device_ms(fn, sets, iters: int, by_name=None, bound_ms=None):
    """Mean device time per call (the summed durations of the call's
    kernels, host launch gaps excluded); None if the profiler saw no
    device activity. ``by_name`` (a dict) receives each kernel's mean ms
    per call. A reading under ``bound_ms`` (the least time the card could
    take: the profiler lost events) is not taken: the run is profiled
    again, and a second reading under the bound raises."""
    def run():
        for i in range(iters):
            fn(*sets[i % len(sets)])

    def reading(ev):
        return sum(e - s for s, e, _ in ev) / iters / 1e3 if ev else None
    # the profiler can hand back no device events for a run, or lose some
    # of them: look again
    ev = _device_events(run)
    if not ev or (bound_ms is not None and reading(ev) < bound_ms):
        ev = _device_events(run)
        ms = reading(ev)
        check(bound_ms is None or ms is None or ms >= bound_ms,
              f"device time {ms} ms under the bound {bound_ms} ms in two "
              f"profiled runs: the profiler loses events")
    if not ev:
        return None
    if by_name is not None:
        for s, e, name in ev:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / iters / 1e3
    return reading(ev)


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals sorted by start."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _bound(nbytes: int, flops: float, dt) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dt]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _decode_case(b, s, hkv, g, dh, dt, t_base, dev, gen):
    """Serving-like decode inputs: slot i holds positions 0..t_i of a cache
    of s rows (the rest empty)."""
    h = hkv * g

    def make():
        q = torch.randn((b, h, dh), generator=gen, device=dev).to(dt)
        k = torch.randn((b, s, hkv, dh), generator=gen, device=dev).to(dt)
        v = torch.randn((b, s, hkv, dh), generator=gen, device=dev).to(dt)
        t = torch.tensor([t_base - 2 * i for i in range(b)],
                         dtype=torch.int32, device=dev)
        pos = torch.arange(s, dtype=torch.int32, device=dev)[None].repeat(
            b, 1)
        pos = torch.where(pos <= t[:, None], pos, torch.full_like(pos, -1))
        return q, k, v, pos, t

    esz = torch.finfo(dt).bits // 8
    sets = _copies(make, 2 * b * s * hkv * dh * esz)
    q, k, v, pos, t = sets[0]
    live = int((pos >= 0).sum())
    # bytes: q and out once, positions and clocks once, the K/V rows the
    # mask keeps live once; operations: q.k and p.v over the live rows
    nbytes = (2 * b * h * dh * esz + pos.numel() * 4 + b * 4
              + 2 * live * hkv * dh * esz)
    flops = 4.0 * live * h * dh
    # the position mask as SDPA takes it, built outside the timed call
    masks = {st[3].data_ptr(): ((st[3] >= 0) & (st[3] <= st[4][:, None]))
             [:, None, None] for st in sets}

    def library(q, k, v, pos, t):
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=masks[pos.data_ptr()], enable_gqa=True)[:, :, 0]

    return sets, nbytes, flops, library, {}


def _flash_case(b, s, hkv, g, dh, dt, dev, gen, dv=None):
    h = hkv * g
    dv = dv or dh

    def make():
        return (torch.randn((b, s, h, dh), generator=gen, device=dev).to(dt),
                torch.randn((b, s, hkv, dh), generator=gen, device=dev).to(dt),
                torch.randn((b, s, hkv, dv), generator=gen, device=dev).to(dt))

    esz = torch.finfo(dt).bits // 8
    # q read and out written once, K and V read once
    nbytes = b * s * esz * (h * dh + h * dv + hkv * (dh + dv))
    sets = _copies(make, nbytes)
    pairs = s * (s + 1) // 2                      # causal (q, k) pairs
    flops = 2.0 * b * h * (dh + dv) * pairs

    def library(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    return sets, nbytes, flops, library, {}


def _chunk_case(b, c, s_cache, hkv, g, dh, dt, q0, filled, pad_rows, dev,
                gen):
    """A serving prefill chunk: ``c`` queries at q0.. (the last
    ``pad_rows`` of them pad, at position -1) against a cache whose first
    ``filled`` rows hold positions 0.. (the rest empty) plus the chunk."""
    h = hkv * g
    sk = s_cache + c

    def make():
        q = torch.randn((b, c, h, dh), generator=gen, device=dev).to(dt)
        k = torch.randn((b, sk, hkv, dh), generator=gen, device=dev).to(dt)
        v = torch.randn((b, sk, hkv, dh), generator=gen, device=dev).to(dt)
        qp = q0 + torch.arange(c, dtype=torch.int32, device=dev)
        qp[c - pad_rows:] = -1
        cache = torch.arange(s_cache, dtype=torch.int32, device=dev)
        cache = torch.where(cache < filled, cache, torch.full_like(cache, -1))
        kp = torch.cat([cache, qp])[None].repeat(b, 1)
        return q, k, v, qp[None].repeat(b, 1).contiguous(), kp

    esz = torch.finfo(dt).bits // 8
    sets = _copies(make, 2 * b * sk * hkv * dh * esz)
    q, k, v, qp, kp = sets[0]
    allow = ((kp[:, None, :] >= 0) & (kp[:, None, :] <= qp[:, :, None]))
    pairs = int(allow.sum())
    live_keys = int((kp >= 0).sum())
    # bytes: q and out once, the live K/V rows once, both position lanes;
    # operations: q.k and p.v over the live (query, key) pairs
    nbytes = (2 * q.numel() * esz + 2 * live_keys * hkv * dh * esz
              + (qp.numel() + kp.numel()) * 4)
    flops = 4.0 * pairs * h * dh
    masks = {st[4].data_ptr(): ((st[4][:, None, :] >= 0)
                                & (st[4][:, None, :] <= st[3][:, :, None]))
             [:, None] for st in sets}

    def library(q, k, v, qp, kp):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=masks[kp.data_ptr()], enable_gqa=True).transpose(1, 2)

    # SDPA leaves a query row with no live key undefined: compare live rows
    live_rows = qp[0] >= 0
    return sets, nbytes, flops, library, {"rows": live_rows}


def _paged_case(b, n_pp, p_sz, hkv, g, dh, dt, t_base, dev, gen):
    """Serving-like paged decode inputs: ``b * n_pp + 1`` pool pages (page
    0 the null page, its position lane live-looking garbage), slot i
    mapping shuffled pages for its positions 0..t_i, the rest of its map
    unbacked."""
    from repro_torch.models.attention import paged_view
    h = hkv * g
    n_pages = b * n_pp + 1
    ts = [t_base - 3 * i for i in range(b)]

    def make():
        q = torch.randn((b, h, dh), generator=gen, device=dev).to(dt)
        shape = (n_pages, p_sz, hkv, dh)
        k = torch.randn(shape, generator=gen, device=dev).to(dt)
        v = torch.randn(shape, generator=gen, device=dev).to(dt)
        pos = torch.full((n_pages, p_sz), -1, dtype=torch.int32, device=dev)
        pos[0] = torch.arange(p_sz, dtype=torch.int32, device=dev)
        perm = 1 + torch.randperm(n_pages - 1, generator=gen, device=dev)
        pm = torch.zeros((b, n_pp), dtype=torch.int32, device=dev)
        used = 0
        for s_, t in enumerate(ts):
            n_live = t // p_sz + 1
            ids = perm[used:used + n_live]
            used += n_live
            pm[s_, :n_live] = ids.to(torch.int32)
            pos[ids] = torch.arange(n_live * p_sz, dtype=torch.int32,
                                    device=dev).view(n_live, p_sz)
        t = torch.tensor(ts, dtype=torch.int32, device=dev)
        return q, k, v, pos, pm, t

    esz = torch.finfo(dt).bits // 8
    sets = _copies(make, 2 * n_pages * p_sz * hkv * dh * esz)
    live = sum(t + 1 for t in ts)
    mapped = sum((t // p_sz + 1) * p_sz for t in ts)
    # bytes: q and out once, the live K/V rows once, the mapped pages'
    # position lanes, the map and the clocks; operations over the live rows
    nbytes = (2 * b * h * dh * esz + 2 * live * hkv * dh * esz + mapped * 4
              + b * n_pp * 4 + b * 4)
    flops = 4.0 * live * h * dh
    # the library yardstick runs on the dense view gathered from the pages
    # (gathered here, outside the timed call)
    views = {}
    for q, k, v, pos, pm, t in sets:
        dv = paged_view({"k": k, "v": v, "pos": pos}, pm)
        mask = (dv["pos"] >= 0) & (dv["pos"] <= t[:, None])
        views[k.data_ptr()] = (dv["k"].contiguous(), dv["v"].contiguous(),
                               dv["pos"].contiguous(), mask[:, None, None])

    def library(q, k, v, pos, pm, t):
        kd, vd, _, mask = views[k.data_ptr()]
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)[:, :, 0]

    return sets, nbytes, flops, library, {"dense_view": views}


MLA_SCALE = (128 + 64) ** -0.5           # deepseek-v2: (qk_nope + qk_rope)^-.5


def _mla_chunk_case(b, c, s_cache, h, lat_d, r, dt, q0, filled, pad_rows,
                    dev, gen):
    """An absorbed-MLA prefill chunk: ``c`` queries at q0.. (the last
    ``pad_rows`` of them pad) against a latent ring whose first ``filled``
    rows hold positions 0.. plus the chunk."""
    sk = s_cache + c

    def make():
        ql = torch.randn((b, c, h, lat_d), generator=gen, device=dev).to(dt)
        qr = torch.randn((b, c, h, r), generator=gen, device=dev).to(dt)
        lat = torch.randn((b, sk, lat_d), generator=gen, device=dev).to(dt)
        rope = torch.randn((b, sk, r), generator=gen, device=dev).to(dt)
        qp = q0 + torch.arange(c, dtype=torch.int32, device=dev)
        qp[c - pad_rows:] = -1
        cache = torch.arange(s_cache, dtype=torch.int32, device=dev)
        cache = torch.where(cache < filled, cache, torch.full_like(cache, -1))
        kp = torch.cat([cache, qp])[None].repeat(b, 1)
        return ql, qr, lat, rope, qp[None].repeat(b, 1).contiguous(), kp

    esz = torch.finfo(dt).bits // 8
    sets = _copies(make, b * (c * h * 2 * (lat_d + r) + sk * (lat_d + r))
                   * esz)
    ql, qr, lat, rope, qp, kp = sets[0]
    allow = (kp[:, None, :] >= 0) & (kp[:, None, :] <= qp[:, :, None])
    pairs = int(allow.sum())
    live_keys = int((kp >= 0).sum())
    # bytes: q_lat/q_rope read and out written once, the live latent and
    # rope rows once, both position lanes; operations: the two score terms
    # and the latent value product over the live (query, key) pairs
    nbytes = (esz * (ql.numel() + qr.numel() + ql.numel())
              + live_keys * (lat_d + r) * esz + (qp.numel() + kp.numel()) * 4)
    flops = 2.0 * pairs * h * (lat_d + r + lat_d)
    kv = {}
    for st in sets:
        mask = ((st[5][:, None, :] >= 0)
                & (st[5][:, None, :] <= st[4][:, :, None]))[:, None]
        kv[st[2].data_ptr()] = (torch.cat([st[2], st[3]], -1)[:, None],
                                st[2][:, None], mask)

    def library(ql, qr, lat, rope, qp, kp):
        # q = [q_lat | q_rope], k = [latent | rope] on one KV head, v =
        # latent: SDPA computes the same absorbed function (d_v != d_qk)
        k1, v1, mask = kv[lat.data_ptr()]
        q = torch.cat([ql, qr], -1).transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            q, k1, v1, attn_mask=mask, scale=MLA_SCALE,
            enable_gqa=True).transpose(1, 2)

    live_rows = qp[0] >= 0
    return (sets, nbytes, flops, library,
            {"rows": live_rows, "kw": {"scale": MLA_SCALE}})


def _paged_mla_case(b, n_pp, p_sz, h, lat_d, r, dt, t_base, dev, gen):
    """Serving-like paged MLA decode inputs: ``b * n_pp + 1`` pool pages
    (page 0 the null page), slot i mapping shuffled pages for its positions
    0..t_i, the rest of its map unbacked."""
    from repro_torch.models.attention import paged_view
    n_pages = b * n_pp + 1
    ts = [t_base - 3 * i for i in range(b)]

    def make():
        ql = torch.randn((b, h, lat_d), generator=gen, device=dev).to(dt)
        qr = torch.randn((b, h, r), generator=gen, device=dev).to(dt)
        lat = torch.randn((n_pages, p_sz, lat_d), generator=gen,
                          device=dev).to(dt)
        rope = torch.randn((n_pages, p_sz, r), generator=gen,
                           device=dev).to(dt)
        pos = torch.full((n_pages, p_sz), -1, dtype=torch.int32, device=dev)
        pos[0] = torch.arange(p_sz, dtype=torch.int32, device=dev)
        perm = 1 + torch.randperm(n_pages - 1, generator=gen, device=dev)
        pm = torch.zeros((b, n_pp), dtype=torch.int32, device=dev)
        used = 0
        for s_, t in enumerate(ts):
            n_live = t // p_sz + 1
            ids = perm[used:used + n_live]
            used += n_live
            pm[s_, :n_live] = ids.to(torch.int32)
            pos[ids] = torch.arange(n_live * p_sz, dtype=torch.int32,
                                    device=dev).view(n_live, p_sz)
        t = torch.tensor(ts, dtype=torch.int32, device=dev)
        return ql, qr, lat, rope, pos, pm, t

    esz = torch.finfo(dt).bits // 8
    sets = _copies(make, n_pages * p_sz * (lat_d + r) * esz)
    live = sum(t + 1 for t in ts)
    mapped = sum((t // p_sz + 1) * p_sz for t in ts)
    # bytes: q_lat/q_rope and out once, the live latent + rope rows once,
    # the mapped pages' position lanes, the map and the clocks; operations:
    # the two score terms and the latent value product over the live rows
    nbytes = (esz * b * h * (2 * lat_d + r) + live * (lat_d + r) * esz
              + mapped * 4 + b * n_pp * 4 + b * 4)
    flops = 2.0 * live * h * (lat_d + r + lat_d)
    views = {}
    for ql, qr, lat, rope, pos, pm, t in sets:
        v = paged_view({"latent": lat, "rope": rope, "pos": pos}, pm)
        mask = (v["pos"] >= 0) & (v["pos"] <= t[:, None])
        views[lat.data_ptr()] = (
            torch.cat([v["latent"], v["rope"]], -1)[:, None].contiguous(),
            v["latent"][:, None].contiguous(), mask[:, None, None])

    def library(ql, qr, lat, rope, pos, pm, t):
        k1, v1, mask = views[lat.data_ptr()]
        q = torch.cat([ql, qr], -1)[:, :, None]
        return torch.nn.functional.scaled_dot_product_attention(
            q, k1, v1, attn_mask=mask, scale=MLA_SCALE,
            enable_gqa=True)[:, :, 0]

    return sets, nbytes, flops, library, {"kw": {"scale": MLA_SCALE}}


def _copy_case(n_pages, p_sz, hkv, dh, dt, dev, gen):
    """A COW flush on one outer bf16 pool leaf: 4 pairs and 4 (0, 0)
    padding pairs."""
    srcs = torch.tensor([5, 17, 100, 201, 0, 0, 0, 0], dtype=torch.int32,
                        device=dev)
    dsts = torch.tensor([250, 260, 270, 272, 0, 0, 0, 0], dtype=torch.int32,
                        device=dev)

    def make():
        pool = torch.randn((n_pages, p_sz, hkv, dh), generator=gen,
                           device=dev).to(dt)
        return pool, srcs, dsts

    esz = torch.finfo(dt).bits // 8
    row = p_sz * hkv * dh * esz
    sets = _copies(make, n_pages * row)
    # bytes: each real pair's page read once and written once, the pair
    # table once; no arithmetic
    nbytes = 2 * 4 * row + 2 * srcs.numel() * 4

    def library(pool, srcs, dsts):
        pool[dsts.long()] = pool[srcs.long()]
        return pool

    return sets, nbytes, 0.0, library, {"inplace": True}


def _ring_positions(ts, s, dev):
    """(B, s) positions of rings whose clocks ``ts`` passed ``s``: row l
    holds the newest position p <= t with p % s == l."""
    t = torch.tensor(ts, dtype=torch.int32, device=dev)[:, None]
    l = torch.arange(s, dtype=torch.int32, device=dev)[None]
    return (t - torch.remainder(t - l, s)).to(torch.int32)


def _rg_ring_case(b, s, g, dh, dt, t_base, window, dev, gen, paged=None):
    """recurrentgemma's outer decode read: MQA (one KV head, G query heads
    of dh) over rings of ``s`` rows whose clocks t_base.. have passed ``s``,
    so every ring has wrapped, with the attention window. ``paged`` (a page
    size) puts the same logical rows into shuffled pages of ``b * s/P + 1``
    pool rows (page 0 the null page) and returns the paged read's case."""
    ts = [t_base - 2 * i for i in range(b)]
    n_pp = s // paged if paged else 0
    n_pages = b * n_pp + 1

    def make():
        q = torch.randn((b, g, dh), generator=gen, device=dev).to(dt)
        k = torch.randn((b, s, 1, dh), generator=gen, device=dev).to(dt)
        v = torch.randn((b, s, 1, dh), generator=gen, device=dev).to(dt)
        pos = _ring_positions(ts, s, dev)
        t = torch.tensor(ts, dtype=torch.int32, device=dev)
        if not paged:
            return q, k, v, pos, t
        perm = 1 + torch.randperm(n_pages - 1, generator=gen, device=dev)
        pm = perm.view(b, n_pp).to(torch.int32)
        shape = (n_pages, paged, 1, dh)
        kp = torch.randn(shape, generator=gen, device=dev).to(dt)
        vp = torch.randn(shape, generator=gen, device=dev).to(dt)
        pp = torch.full((n_pages, paged), -1, dtype=torch.int32, device=dev)
        pp[0] = torch.arange(paged, dtype=torch.int32, device=dev)
        idx = pm.long().view(-1)
        kp[idx] = k.reshape(b * n_pp, paged, 1, dh)
        vp[idx] = v.reshape(b * n_pp, paged, 1, dh)
        pp[idx] = pos.reshape(b * n_pp, paged)
        return q, kp, vp, pp, pm, t

    esz = torch.finfo(dt).bits // 8
    sets = _copies(make, 2 * b * s * dh * esz)
    # every ring row is live (the window covers the whole ring) and read
    # once as K and once as V; q and out once; positions, map and clocks
    live = b * s
    nbytes = (2 * b * g * dh * esz + 2 * live * dh * esz + live * 4 + b * 4
              + (b * n_pp * 4 if paged else 0))
    flops = 4.0 * live * g * dh
    views = {}
    for st in sets:
        if paged:
            from repro_torch.models.attention import paged_view
            q, kp, vp, pp, pm, t = st
            dv = paged_view({"k": kp, "v": vp, "pos": pp}, pm)
            kd, vd, pd = (dv["k"].contiguous(), dv["v"].contiguous(),
                          dv["pos"].contiguous())
        else:
            q, kd, vd, pd, t = st
        mask = (pd >= 0) & (pd <= t[:, None]) & (pd > t[:, None] - window)
        views[st[1].data_ptr()] = (kd, vd, pd, mask[:, None, None])

    def library(q, k, *rest):
        kd, vd, _, mask = views[k.data_ptr()]
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)[:, :, 0]

    extra = {"kw": {"window": window}}
    if paged:
        extra["dense_view"] = views
    return sets, nbytes, flops, library, extra


def _lru_case(b, s, d, dt, dev, gen, h0=False):
    """The RG-LRU recurrence as prefill hands it over: decays in (0.5,
    0.999), inputs scaled by sqrt(1 - a^2); ``h0`` adds a start state."""

    def make():
        a = 0.5 + 0.499 * torch.rand((b, s, d), generator=gen, device=dev)
        x = torch.randn((b, s, d), generator=gen, device=dev) * torch.sqrt(
            1 - a * a)
        h = (torch.randn((b, d), generator=gen, device=dev) if h0
             else None)
        return a.to(dt), x.to(dt), h

    esz = torch.finfo(dt).bits // 8
    # a and x read once, h written once (and h0 read once); a product and
    # a sum per element
    nbytes = 3 * b * s * d * esz + (b * d * 4 if h0 else 0)
    sets = _copies(make, nbytes)
    # no single PyTorch call computes this recurrence: no library yardstick
    return sets, nbytes, 2.0 * b * s * d, None, {"exact_f32": True}


def _stmc_case(b, k, cin, cout, dt, dev, gen, bias=True):
    """One STMC conv contraction as the U-Net stream hands it over: a
    (B, K, Cin) window of activations against He-uniform (K, Cin, Cout)
    weights and a bias."""
    bound = (6.0 / (k * cin)) ** 0.5

    def make():
        win = torch.randn((b, k, cin), generator=gen, device=dev)
        w = (torch.rand((k, cin, cout), generator=gen, device=dev) * 2
             - 1) * bound
        bb = (0.1 * torch.randn((cout,), generator=gen, device=dev)
              if bias else None)
        return (win.to(dt), w.to(dt), None if bb is None else bb.to(dt))

    def library(win, w, bb):
        flat_w = w.view(k * cin, cout)
        if bb is None:
            return torch.mm(win.view(b, k * cin), flat_w)
        return torch.addmm(bb, win.view(b, k * cin), flat_w)

    esz = torch.finfo(dt).bits // 8
    # window, weights and bias read once, the output written once; a
    # multiply-add per window element and output column
    nbytes = (b * k * cin + k * cin * cout + (cout if bias else 0)
              + b * cout) * esz
    sets = _copies(make, nbytes)
    return sets, nbytes, 2.0 * b * k * cin * cout, library, {}


def _first(fn):
    """The ``h_all`` of an (h_all, h_last) scan."""
    return lambda *args: fn(*args)[0]


KERNEL_META = {
    "decode_attention": dict(
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:73"),
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:74"),
    "chunk_attention": dict(
        source="src/repro_torch/kernels/csrc/chunk_attention.cu",
        replaces="src/repro/kernels/chunk_attention.py:79"),
    "paged_decode_attention": dict(
        source="src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:155"),
    "copy_pages": dict(
        source="src/repro_torch/kernels/csrc/page_copy.cu",
        replaces="src/repro/kernels/page_copy.py:33"),
    "mla_chunk_attention": dict(
        source="src/repro_torch/kernels/csrc/mla_chunk_attention.cu",
        replaces="src/repro/kernels/chunk_attention.py:168"),
    "paged_mla_decode_attention": dict(
        source="src/repro_torch/kernels/csrc/paged_mla_decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:245"),
    "lru_scan": dict(
        source="src/repro_torch/kernels/csrc/lru_scan.cu",
        replaces="src/repro/kernels/lru_scan.py:41"),
    "stmc_conv": dict(
        source="src/repro_torch/kernels/csrc/stmc_conv.cu",
        replaces="src/repro/kernels/stmc_conv.py:27"),
}
# kernels whose path runs float32 (the rest: bfloat16)
F32_PATHS = ("lru_scan", "stmc_conv")
DECODE_READS = ("decode_attention", "paged_decode_attention")
CHUNK_KERNELS = ("chunk_attention", "mla_chunk_attention")
# the reads that split S and merge the ranges in a combine kernel
SPLIT_READS = DECODE_READS + ("paged_mla_decode_attention",)
# the kernels this slice redesigned, tabled at the end of phase 3
REDESIGNED = ("lru_scan", "copy_pages")



def _chunk_walk(name, args, kw, got) -> dict:
    """What the bf16 chunk body did on these inputs, counted by the kernel
    on the card (kernels/chunk_attention.py: chunk_walk, mla_chunk_walk):
    blocks of the main kernel, key tiles in reach of a block (summed over
    the blocks), the tiles it skipped and the tiles it walked again. The
    counted launch must give the wrapper's bits."""
    from repro_torch.kernels import chunk_attention as CA
    counted = (CA.chunk_walk if name == "chunk_attention"
               else CA.mla_chunk_walk)
    out, walk = counted(*args, **kw)
    check(torch.equal(out, got),
          f"{name}: the counted launch is not the wrapper's bit for bit")
    tiles, skipped, again = (int(x) for x in walk.sum(0).tolist())
    return {"blocks": walk.shape[0], "tiles": tiles,
            "tiles_skipped": skipped, "tiles_walked_again": again,
            "skipped_share": skipped / tiles}


def _check_only(case):
    """A phase-3 case held against its plain version, not timed."""
    case[4]["check_only"] = True
    return case


def _walk_text(r) -> str:
    return (f"{r['tiles_skipped']} / {r['tiles_walked_again']} of "
            f"{r['tiles']} ({r['skipped_share']:.3f})" if "tiles" in r
            else "-")


def _chunk_table(recs, log: str):
    """Phase 3's table of the chunk kernels: device ms [CUDA-event ms], x
    SDPA, plain, bound and its share, max|Δ| against its bound, blocks, key
    tiles skipped and walked again (counted on the card), the split; then
    their ptxas lines."""
    print("  chunk kernels (device ms [event ms]; x SDPA; plain; bound "
          "(share); max|Δ| / tol; blocks; tiles skipped / walked again of "
          "all, counted on the card; split):")
    for r in recs:
        split = (f"{r['n_split']} x {r['keys_per_split']}"
                 if "n_split" in r else "-")
        print(f"    {r['name']} {r['shape']} {r['dtype']}: {r['ms']:.4f} "
              f"[{r['event_ms']:.4f}]; x{r['ms'] / r['library_ms']:.2f}; "
              f"{r['plain_ms']:.4f}; {r['bound_ms']:.5f} "
              f"({r['bound_ms'] / r['ms']:.3f}); {r['max_abs_err']:.2e} / "
              f"{r['tol']:.2e}; {r.get('blocks', '-')}; {_walk_text(r)}; "
              f"{split}")
    for line in _ptxas_lines(log):
        if "chunk" in line:
            print("  " + line)


def _plan_text(r) -> str:
    """A redesigned kernel's plan as phase 3 prints it."""
    p = r.get("plan")
    if p is None:
        return "-"
    if r["name"] == "lru_scan":
        ring = ("edge path" if p["edge"] else
                f"ring of {p['stages']} stages of T {p['steps']} steps, "
                f"{p['smem'] // 1024} KB a block")
        return (f"{p['chains']} chain-warps, {p['warps']} a block, "
                f"{p['blocks']} blocks, {ring}; host {r['host_ms']:.4f} ms "
                f"a call")
    if r["name"] == "stmc_conv":
        return (f"{p['blocks']} blocks, cluster {p['splits']} x "
                f"{p['keys_per_split']} rows of K*Cin, {p['cols']} columns "
                f"a block, {p['rows']} rows of B, "
                f"{'16-byte' if p['vec16'] else 'edge-path'} loads; host "
                f"{r['host_ms']:.4f} ms a call")
    return (f"{p['blocks']} blocks = {p['groups']} head groups x "
            f"{p['n_split']} ranges of {p['keys_per_split']} keys x B; "
            f"split {r.get('split_ms', math.nan):.4f} + combine "
            f"{r.get('combine_ms', math.nan):.4f} ms, host "
            f"{r['host_ms']:.4f} ms a call")


def _redesign_table(recs, log: str):
    """Phase 3's table of the kernels this slice redesigned: device ms
    [CUDA-event ms], x the library call, plain, bound and its share,
    max|Δ| against its tolerance, and the plan; then their ptxas lines."""
    print("  redesigned kernels (device ms [event ms]; x library; plain; "
          "bound (share); max|Δ| / tol; plan):")
    for r in recs:
        lib = (f"x{r['ms'] / r['library_ms']:.2f}" if r["library_ms"]
               else "-")
        print(f"    {r['name']} {r['shape']} {r['dtype']}: {r['ms']:.4f} "
              f"[{r['event_ms']:.4f}]; {lib}; {r['plain_ms']:.4f}; "
              f"{r['bound_ms']:.5f} ({r['bound_ms'] / r['ms']:.3f}); "
              f"{r['max_abs_err']:.2e} / {r['tol']:.2e}; {_plan_text(r)}")
    for line in _ptxas_lines(log):
        if "lru_scan" in line or "copy_pages" in line:
            print("  " + line)


def _unet_conv_sweep(dev, gen) -> dict:
    """stmc_conv in float32 at B 1 (one live stream) on each of the 14
    convs of soi-unet-dns, beside torch.addmm and the bound (device ms from
    the profiler), each held to the plain version; their sums against the
    bound of a frame's weights. Returns the sums."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import stmc_conv as SC
    from repro_torch.models import unet as U
    f32 = torch.float32
    cfg = _unet_cfg(None)
    enc_io, dec_io = U._layer_io(cfg)
    convs = ([(f"enc{i + 1}", cfg.kernel, ci, co)
              for i, (ci, co) in enumerate(enc_io)]
             + [(f"dec{i + 1}", cfg.kernel, ci, co)
                for i, (ci, co) in enumerate(dec_io)])
    print(f"  stmc_conv f32 B 1 on the {len(convs)} convs of soi-unet-dns "
          f"(device ms; addmm; bound (share); plan; max|Δ|):")
    tot = {"ms": 0.0, "addmm_ms": 0.0, "bound_ms": 0.0}
    for label, k, cin, cout in convs:
        sets, nbytes, flops, library, _ = _stmc_case(1, k, cin, cout, f32,
                                                     dev, gen)
        got = SC.stmc_conv(*sets[0])
        err = float((got - ref.stmc_conv(*sets[0])).abs().max())
        check(err < TOL[f32], f"stmc_conv {label}: max|Δ| {err}")
        bound, _ = _bound(nbytes, flops, f32)
        ms = (_device_ms(SC.stmc_conv, sets, 20, bound_ms=bound)
              or _time_ms(SC.stmc_conv, sets, 50))
        lib = _device_ms(library, sets, 20) or _time_ms(library, sets, 50)
        plan = SC.stmc_plan(1, k * cin, cout, f32)
        print(f"    {label} ({k * cin}x{cout}): {ms:.4f}; {lib:.4f}; "
              f"{bound:.5f} ({bound / ms:.3f}); {plan.blocks} blocks = "
              f"{-(-cout // plan.cols)} x {plan.splits}, {plan.cols} "
              f"columns; {err:.1e}", flush=True)
        tot["ms"] += ms
        tot["addmm_ms"] += lib
        tot["bound_ms"] += bound
    print(f"    sum of the {len(convs)}: {tot['ms']:.4f} ms against addmm "
          f"{tot['addmm_ms']:.4f}; the frame's bound "
          f"{tot['bound_ms'] * 1e3:.1f} µs (share "
          f"{tot['bound_ms'] / tot['ms']:.3f})")
    return tot


# a COW flush's pairs in each page table: 4 real pairs (fresh pages near
# the pool's end as destinations) and 4 (0, 0) padding pairs
FLUSH_PAIRS = {273: ([5, 17, 100, 201, 0, 0, 0, 0],
                     [250, 260, 270, 272, 0, 0, 0, 0]),
               193: ([3, 40, 99, 150, 0, 0, 0, 0],
                     [180, 185, 190, 192, 0, 0, 0, 0])}


def _flush_case(tables, dev, gen):
    """A COW flush as the engine hands it to ``copy_pages_leaves``: for each
    page table ``(n_pages, layers, leaf shapes)``, every leaf of its
    attention layers with the table's pairs (``FLUSH_PAIRS``). A set is
    (pools, host srcs, host dsts, device srcs, device dsts); returns the
    sets, the bytes the flush must move and the leaves' count."""
    spec = [(n, shape, dt) for n, layers, leaves in tables
            for _ in range(layers) for shape, dt in leaves]
    ids = {n: tuple(torch.tensor(v, dtype=torch.int32, device=dev)
                    for v in FLUSH_PAIRS[n]) for n in FLUSH_PAIRS}

    def make():
        pools = [torch.randn((n,) + shape, generator=gen, device=dev).to(dt)
                 if dt.is_floating_point else
                 torch.randint(-1, 2048, (n,) + shape, generator=gen,
                               device=dev, dtype=dt) for n, shape, dt in spec]
        return (pools, [FLUSH_PAIRS[n][0] for n, _, _ in spec],
                [FLUSH_PAIRS[n][1] for n, _, _ in spec],
                [ids[n][0] for n, _, _ in spec],
                [ids[n][1] for n, _, _ in spec])

    rows = [math.prod(shape) * (torch.finfo(dt).bits if dt.is_floating_point
                                else torch.iinfo(dt).bits) // 8
            for _, shape, dt in spec]
    pool_bytes = sum(n * r for (n, _, _), r in zip(spec, rows))
    sets = _copies(make, pool_bytes)
    real = [sum(a != b for a, b in zip(*FLUSH_PAIRS[n])) for n, _, _ in spec]
    # bytes: each real pair's page read once and written once, the packed
    # table (5 fields a leaf, 2 ids a pair of each table, int64) once
    n_pairs = sum(len(FLUSH_PAIRS[n][0]) for n in {n for n, _, _ in spec})
    nbytes = (sum(2 * k * r for k, r in zip(real, rows))
              + 8 * (5 * len(spec) + 2 * n_pairs))
    return sets, nbytes, len(spec)


def _cow_flush_reading(label, tables, dev, gen) -> dict:
    """One ``copy_pages_leaves`` launch for a whole COW flush, held bit for
    bit against the plain version leaf by leaf, timed against the same
    flush as one ``copy_pages`` launch a leaf, against the indexed
    assignment a leaf summed (the library yardstick) and the bytes' bound;
    device ms (kernel and table upload apart), CUDA-event ms and host ms a
    call. Returns the record."""
    from repro_torch.kernels import page_copy as PC
    from repro_torch.kernels import ref
    sets, nbytes, n_leaves = _flush_case(tables, dev, gen)
    pools, srcs, dsts, dsrcs, ddsts = sets[0]
    got = [p.clone() for p in pools]
    n0 = PC.copy_pages.launches
    PC.copy_pages_leaves(got, srcs, dsts)
    torch.cuda.synchronize()
    check(PC.copy_pages.launches == n0 + 1,
          f"copy_pages_leaves {label}: {PC.copy_pages.launches - n0} "
          f"launches for one flush")
    for i, (g, p, s_, d_) in enumerate(zip(got, pools, dsrcs, ddsts)):
        check(torch.equal(g, ref.copy_pages(p.clone(), s_, d_)),
              f"copy_pages_leaves {label}: leaf {i} not bit-exact")

    def one(pools, srcs, dsts, *_):
        PC.copy_pages_leaves(pools, srcs, dsts)

    def per_leaf(pools, srcs, dsts, *_):
        for p, s_, d_ in zip(pools, srcs, dsts):
            PC.copy_pages(p, s_, d_)

    def plain(pools, _s, _d, dsrcs, ddsts):
        for p, s_, d_ in zip(pools, dsrcs, ddsts):
            ref.copy_pages(p, s_, d_)

    longs = {id(t): t.long() for st in sets for t in st[3] + st[4]}

    def library(pools, _s, _d, dsrcs, ddsts):
        for p, s_, d_ in zip(pools, dsrcs, ddsts):
            p[longs[id(d_)]] = p[longs[id(s_)]]

    def kernel_and_copy(parts):
        kern = sum(v for k, v in parts.items() if "copy_pages_kernel" in k)
        return kern, sum(parts.values()) - kern

    rec = {"name": "copy_pages", "shape": label, "dtype": "bfloat16",
           "max_abs_err": 0.0, "leaves": n_leaves}
    rec["bound_ms"], rec["bound_by"] = _bound(nbytes, 0.0, torch.bfloat16)
    for key, fn, iters in (("", one, 20), ("per_leaf_", per_leaf, 5)):
        parts: dict = {}
        rec[key + "ms"] = (_device_ms(fn, sets, iters, parts,
                                      bound_ms=rec["bound_ms"])
                           or _time_ms(fn, sets, iters))
        rec[key + "kernel_ms"], rec[key + "upload_ms"] = kernel_and_copy(
            parts)
        rec[key + "event_ms"] = _time_ms(fn, sets, iters)
        rec[key + "host_ms"] = _host_ms(fn, sets, 4 * iters)
    # the host's share of a call: packing the table, and its upload
    table = PC.pack_leaves(pools, srcs, dsts)
    rec["host_pack_ms"] = _host_ms(
        lambda pools, srcs, dsts, *_: PC.pack_leaves(pools, srcs, dsts), sets,
        80)
    rec["host_upload_ms"] = _host_ms(lambda *_: PC._upload(table, dev), sets,
                                     80)
    rec["plain_ms"] = (_device_ms(plain, sets, 5, bound_ms=rec["bound_ms"])
                       or _time_ms(plain, sets, 5))
    rec["library_ms"] = (_device_ms(library, sets, 5)
                         or _time_ms(library, sets, 5))
    rec["bytes"] = nbytes
    print(json.dumps({"kernels": [rec]}), flush=True)
    print(f"  copy_pages {label}: {n_leaves} leaves, 1 launch: "
          f"{rec['ms']:.4f} ms on the device (kernel {rec['kernel_ms']:.4f}"
          f", upload {rec['upload_ms']:.4f}) [{rec['event_ms']:.4f}], host "
          f"{rec['host_ms']:.4f} ms a call (packing {rec['host_pack_ms']:.4f}"
          f", upload {rec['host_upload_ms']:.4f}); a launch a leaf: "
          f"{rec['per_leaf_ms']:.4f} (kernels {rec['per_leaf_kernel_ms']:.4f}"
          f", uploads {rec['per_leaf_upload_ms']:.4f}) "
          f"[{rec['per_leaf_event_ms']:.4f}], host "
          f"{rec['per_leaf_host_ms']:.4f}; indexed assignment "
          f"{rec['library_ms']:.4f}; plain {rec['plain_ms']:.4f}; bound "
          f"{rec['bound_ms']:.5f} ({rec['bound_ms'] / rec['ms']:.3f}); "
          f"bit for bit", flush=True)
    return rec


def kernels_phase(dev) -> dict:
    """Returns {kernel name: record of its serving-path bf16 case}; the
    flash kernel's deepseek-v2 shape is keyed "flash_attention (MLA)", the
    decode kernels' recurrentgemma outer shapes "<name> (RG)" and the
    middle ring "decode_attention (RG middle)"; lru_scan's and
    stmc_conv's records are their first float32 case, the dtype their
    paths run (stmc_conv: decoder 2 of the U-Net at B 1, one live stream)."""
    phase("3 kernels")
    from repro_torch.kernels import _build
    from repro_torch.kernels import chunk_attention as CA
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import lru_scan as LS
    from repro_torch.kernels import page_copy as PC
    from repro_torch.kernels import ref
    from repro_torch.kernels import stmc_conv as SC
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        # outer ring (4, 1088, 8, 128) and compressed middle (4, 768, 8, 128)
        # at serving step ~32: clocks 1056.. and frames 528..
        cases.append(("decode_attention", "outer (4,1088,8,128)", dt,
                      _decode_case(4, 1088, 8, 2, 128, dt, 1056, dev, gen),
                      DA.decode_attention, ref.decode_attention))
        cases.append(("decode_attention", "middle (4,768,8,128)", dt,
                      _decode_case(4, 768, 8, 2, 128, dt, 528, dev, gen),
                      DA.decode_attention, ref.decode_attention))
        cases.append(("flash_attention", "prefill (1,1024,16,128)", dt,
                      _flash_case(1, 1024, 8, 2, 128, dt, dev, gen),
                      FA.flash_attention, ref.flash_attention))
        cases.append(("flash_attention", "middle (1,512,16,128)", dt,
                      _flash_case(1, 512, 8, 2, 128, dt, dev, gen),
                      FA.flash_attention, ref.flash_attention))
        # the last chunk of a 1024-token prompt: 256 queries at 768.. against
        # the 1088-row ring (768 live) plus the chunk; the middle's 128
        # frames at 384.. against 768 + 128. Every query at a real position,
        # as the serving path sends them (models/attention.py); then the
        # outer chunk with 6 pad queries at -1, held but not timed
        cases.append(("chunk_attention", "outer q(1,256,16,128) Sk 1344", dt,
                      _chunk_case(1, 256, 1088, 8, 2, 128, dt, 768, 768, 0,
                                  dev, gen),
                      CA.chunk_attention, ref.chunk_attention))
        cases.append(("chunk_attention", "middle q(1,128,16,128) Sk 896", dt,
                      _chunk_case(1, 128, 768, 8, 2, 128, dt, 384, 384, 0,
                                  dev, gen),
                      CA.chunk_attention, ref.chunk_attention))
        cases.append(("chunk_attention",
                      "outer q(1,256,16,128) Sk 1344, 6 pad queries", dt,
                      _check_only(_chunk_case(1, 256, 1088, 8, 2, 128, dt,
                                              768, 768, 6, dev, gen)),
                      CA.chunk_attention, ref.chunk_attention))
        # the serving pools (slots * pages_per_slot + 1 pages) at clocks
        # 1056.. (outer) and frames 528.. (middle)
        cases.append(("paged_decode_attention",
                      "outer pools (273,16,8,128) map (4,68)", dt,
                      _paged_case(4, 68, 16, 8, 2, 128, dt, 1056, dev, gen),
                      DA.paged_decode_attention, ref.paged_decode_attention))
        cases.append(("paged_decode_attention",
                      "middle pools (193,16,8,128) map (4,48)", dt,
                      _paged_case(4, 48, 16, 8, 2, 128, dt, 528, dev, gen),
                      DA.paged_decode_attention, ref.paged_decode_attention))
        # deepseek-v2's exact-length prefill: 128 heads, q/k 192, v 128
        cases.append(("flash_attention", "MLA prefill (1,1024,128,192/128)",
                      dt, _flash_case(1, 1024, 128, 1, 192, dt, dev, gen,
                                      dv=128),
                      FA.flash_attention, ref.flash_attention))
        # the MLA stack's serving chunk (as chunk_attention's above, the
        # pad queries' case held but not timed) and the paged decode read
        # at clocks 1056.. / frames 528..
        cases.append(("mla_chunk_attention",
                      "outer q(1,256,128,512+64) Sk 1344", dt,
                      _mla_chunk_case(1, 256, 1088, 128, 512, 64, dt, 768,
                                      768, 0, dev, gen),
                      CA.mla_chunk_attention, ref.mla_chunk_attention))
        cases.append(("mla_chunk_attention",
                      "middle q(1,128,128,512+64) Sk 896", dt,
                      _mla_chunk_case(1, 128, 768, 128, 512, 64, dt, 384,
                                      384, 0, dev, gen),
                      CA.mla_chunk_attention, ref.mla_chunk_attention))
        cases.append(("mla_chunk_attention",
                      "outer q(1,256,128,512+64) Sk 1344, 6 pad queries", dt,
                      _check_only(_mla_chunk_case(1, 256, 1088, 128, 512, 64,
                                                  dt, 768, 768, 6, dev,
                                                  gen)),
                      CA.mla_chunk_attention, ref.mla_chunk_attention))
        cases.append(("paged_mla_decode_attention",
                      "outer pools (273,16,512+64) map (4,68) H 128", dt,
                      _paged_mla_case(4, 68, 16, 128, 512, 64, dt, 1056,
                                      dev, gen),
                      DA.paged_mla_decode_attention,
                      ref.paged_mla_decode_attention))
        cases.append(("paged_mla_decode_attention",
                      "middle pools (193,16,512+64) map (4,48) H 128", dt,
                      _paged_mla_case(4, 48, 16, 128, 512, 64, dt, 528, dev,
                                      gen),
                      DA.paged_mla_decode_attention,
                      ref.paged_mla_decode_attention))
        # recurrentgemma: MQA (G 16, dh 256) on the outer rings of 2048 at
        # serving step ~32 (clocks 2072.., wrapped), window 2048, dense and
        # paged (page 16); the middle's 1280-frame rings at frames 1036..
        cases.append(("decode_attention",
                      "RG outer ring (4,2048,1,256) G 16 t 2072 w 2048", dt,
                      _rg_ring_case(4, 2048, 16, 256, dt, 2072, 2048, dev,
                                    gen),
                      DA.decode_attention, ref.decode_attention))
        cases.append(("decode_attention", "RG middle (4,1280,1,256) G 16",
                      dt, _decode_case(4, 1280, 1, 16, 256, dt, 1036, dev,
                                       gen),
                      DA.decode_attention, ref.decode_attention))
        cases.append(("paged_decode_attention",
                      "RG outer pools (513,16,1,256) map (4,128) G 16 t 2072 "
                      "w 2048", dt,
                      _rg_ring_case(4, 2048, 16, 256, dt, 2072, 2048, dev,
                                    gen, paged=16),
                      DA.paged_decode_attention, ref.paged_decode_attention))
    # recurrentgemma's prefill recurrence: float32 a and x (the path's
    # dtype) at the outer (2040 tokens) and middle (1020 frames) shapes,
    # then a start state and an odd shape; bfloat16 inputs too
    for dt in (torch.float32, torch.bfloat16):
        for shape, args in (("outer (1,2040,4096)", (1, 2040, 4096)),
                            ("middle (1,1020,4096)", (1, 1020, 4096))):
            cases.append(("lru_scan", shape, dt,
                          _lru_case(*args, dt, dev, gen), _first(LS.lru_scan),
                          _first(ref.lru_scan)))
    cases.append(("lru_scan", "h0 (2,300,4096)", torch.float32,
                  _lru_case(2, 300, 4096, torch.float32, dev, gen, h0=True),
                  _first(LS.lru_scan), _first(ref.lru_scan)))
    cases.append(("lru_scan", "odd (3,37,100)", torch.float32,
                  _lru_case(3, 37, 100, torch.float32, dev, gen),
                  _first(LS.lru_scan), _first(ref.lru_scan)))
    # more chains than SMs: 512 chain-warps, four a block
    cases.append(("lru_scan", "B 4 (4,2040,4096)", torch.float32,
                  _lru_case(4, 2040, 4096, torch.float32, dev, gen),
                  _first(LS.lru_scan), _first(ref.lru_scan)))
    # the streaming U-Net (soi-unet-dns): decoder 2, the layer with the
    # most weights (K*Cin 7248, Cout 664: 19.25 MB in float32), at B 1 (one
    # live stream) and B 32; encoder 7 (Cout 1296) at B 32; a ragged case
    # without bias. float32 is the path's dtype
    for dt in (torch.float32, torch.bfloat16):
        for shape, args, bias in (
                ("dec2 (1,3,2416)x(3,2416,664)", (1, 3, 2416, 664), True),
                ("dec2 (32,3,2416)x(3,2416,664)", (32, 3, 2416, 664), True),
                ("enc7 (32,3,1208)x(3,1208,1296)", (32, 3, 1208, 1296),
                 True),
                ("ragged (3,3,64)x(3,64,129) no bias", (3, 3, 64, 129),
                 False)):
            cases.append(("stmc_conv", shape, dt,
                          _stmc_case(*args, dt, dev, gen, bias=bias),
                          SC.stmc_conv, ref.stmc_conv))
    # one leaf as the parent launched a leaf; the kernel takes host ids
    copy_case = _copy_case(273, 16, 8, 128, torch.bfloat16, dev, gen)
    host_ids = [t.cpu() for t in copy_case[0][0][1:]]
    cases.append(("copy_pages", "one leaf (273,16,8,128), 4+4 pairs",
                  torch.bfloat16, copy_case,
                  lambda pool, _s, _d: PC.copy_pages(pool, *host_ids),
                  ref.copy_pages))
    main, chunk_recs, redesigned = {}, [], []
    for (name, shape, dt, (sets, nbytes, flops, library, extra), kern,
         plain) in cases:
        kw = extra.get("kw", {})
        if kw:                         # the MLA kernels' scale, a window
            kern = functools.partial(kern, **kw)
            plain = functools.partial(plain, **kw)
        args = sets[0]
        if extra.get("inplace"):
            # in-place kernels: each version gets its own copy of the pool
            def fresh():
                return (args[0].clone(),) + tuple(args[1:])
        else:
            def fresh():
                return args
        got = kern(*fresh())
        torch.cuda.synchronize()
        want = plain(*fresh())
        err = float((got.float() - want.float()).abs().max())
        check(bool(torch.isfinite(got.float()).all()),
              f"{name} {shape}: non-finite")
        if extra.get("inplace"):
            check(torch.equal(got, want), f"{name} {shape}: not bit-exact")
        is_read = name in SPLIT_READS
        is_chunk = name in CHUNK_KERNELS
        tol = TOL[dt]
        if (is_read or is_chunk) and dt == torch.bfloat16:
            tol = min(tol, READ_REL_TOL * float(want.float().abs().max()))
        check(err < tol, f"{name} {shape} {dt}: max|Δ| {err} >= {tol}")
        check_only = extra.get("check_only", False)
        lib_err = None
        if library is not None and not check_only:
            lib = library(*fresh()).float()
            rows = extra.get("rows")
            if rows is not None:
                lib, ref_rows = lib[:, rows], want.float()[:, rows]
            else:
                ref_rows = want.float()
            lib_err = float((lib - ref_rows).abs().max())
        rec_extra = {"tol": tol}
        if is_read:
            if name == "paged_mla_decode_attention":
                plan = DA.paged_mla_launch_plan(args[0], args[1], args[4],
                                                args[5])
                groups = -(-args[0].shape[1] // DA.MLA_HEADS_PER_BLOCK)
                rec_extra["plan"] = {
                    "n_split": plan[0], "keys_per_split": plan[1],
                    "groups": groups,
                    "blocks": groups * plan[0] * args[0].shape[0]}
            elif len(args) == 5:
                plan = DA.launch_plan(args[0], args[1])
            else:
                plan = DA.paged_launch_plan(args[0], args[1], args[4])
            rec_extra["n_split"], rec_extra["keys_per_split"] = plan[:2]
            if shape.startswith("RG"):
                rec_extra["split_coverage_err"] = _split_coverage(
                    kern, plain, args, plan, f"{name} {shape} {dt}")
            rec_extra["host_ms"] = _host_ms(kern, sets, 100)
        if is_chunk and dt == torch.bfloat16:
            rec_extra.update(_chunk_walk(name, args, kw, got))
            if name == "chunk_attention":
                plan = CA.launch_plan(args[0], args[1])
                rec_extra["n_split"], rec_extra["keys_per_split"] = plan[:2]
        if name == "stmc_conv":
            win, w = args[0], args[1]
            rec_extra["plan"] = SC.stmc_plan(
                win.shape[0], win.shape[1] * win.shape[2], w.shape[2],
                dt)._asdict()
            rec_extra["host_ms"] = _host_ms(kern, sets, 100)
        if name == "lru_scan":
            rec_extra["plan"] = LS.launch_plan(args[0], args[1])._asdict()
            rec_extra["host_ms"] = _host_ms(kern, sets, 20)
        if (dt == torch.bfloat16 and (name == "flash_attention" or is_read
                                      or is_chunk)) or name in (
                                          "stmc_conv", "lru_scan"):
            # the tensor-core bodies, the cluster's split-K and the scan's
            # chains add in a fixed order (no atomics): a second launch on
            # the same inputs gives the same bits
            again = kern(*fresh())
            rec_extra["repeats_bit_for_bit"] = bool(torch.equal(got, again))
            check(rec_extra["repeats_bit_for_bit"],
                  f"{name} {shape}: bf16 results differ run to run")
        if "dense_view" in extra:
            # the paged read against the dense kernel over the same logical
            # rows (gathered), bit for bit: the same split, key order and
            # combine
            kd, vd, posd, _ = extra["dense_view"][args[1].data_ptr()]
            dense = DA.decode_attention(args[0], kd, vd, posd, args[5], **kw)
            rec_extra["equals_dense_kernel"] = bool(torch.equal(got, dense))
            check(rec_extra["equals_dense_kernel"],
                  f"{name} {shape} {dt}: not the dense kernel's read bit "
                  f"for bit")
        if extra.get("exact_f32") and dt == torch.float32:
            # the scan's product and sum round as the plain version's do
            rec_extra["equals_plain"] = bool(torch.equal(got, want))
            check(rec_extra["equals_plain"],
                  f"{name} {shape}: float32 not bit for bit the plain's")
        if check_only:
            print(f"  held, not timed: {name} {shape} {str(dt)[6:]}: "
                  f"max|Δ| {err:.2e} / {tol:.2e}; tiles skipped / walked "
                  f"again of all: {_walk_text(rec_extra)}", flush=True)
            continue
        # ms: device time per call from the profiler (the call's kernels,
        # host launch gaps excluded) — the plain version and the library
        # call spend more time in host dispatch than on the card, which
        # CUDA events over back-to-back calls would charge to them;
        # *_event_ms keep that view
        has_lib = library is not None
        event = {"event_ms": _time_ms(kern, sets, 50),
                 "plain_event_ms": _time_ms(plain, sets, 5),
                 "library_event_ms": (_time_ms(library, sets, 50)
                                      if has_lib else None)}
        parts = {}
        bound_ms, bound_by = _bound(nbytes, flops, dt)
        # the kernel and its plain version compute the row's function: a
        # reading under its bound is a profile that lost events
        dev_ms = {"ms": _device_ms(kern, sets, 20, parts, bound_ms=bound_ms),
                  "plain_ms": _device_ms(plain, sets, 5, bound_ms=bound_ms),
                  "library_ms": (_device_ms(library, sets, 20)
                                 if has_lib else None)}
        for key, val in dev_ms.items():
            if val is None:            # the profiler saw no device activity
                dev_ms[key] = event[key.replace("ms", "event_ms")]
        if (is_read or is_chunk) and parts:
            # the split kernel and the combine apart
            rec_extra["combine_ms"] = sum(
                v for k_, v in parts.items()
                if "decode_combine" in k_ or "chunk_combine" in k_)
            rec_extra["split_ms"] = sum(parts.values()) - rec_extra[
                "combine_ms"]
        rec = {"name": name, "shape": shape, "dtype": str(dt)[6:],
               "max_abs_err": err, **dev_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, **event,
               "library_max_abs_err": lib_err, "bytes": nbytes,
               "flops": flops, **rec_extra}
        print(json.dumps({"kernels": [rec]}), flush=True)
        if is_chunk:
            chunk_recs.append(rec)
        if name in REDESIGNED:
            redesigned.append(rec)
        key = name + (" (MLA)" if shape.startswith("MLA") else
                      " (RG middle)" if shape.startswith("RG middle") else
                      " (RG)" if shape.startswith("RG") else
                      " (middle)" if is_chunk and shape.startswith("middle")
                      else "")
        serving_dt = (torch.float32 if name in F32_PATHS
                      else torch.bfloat16)
        if dt == serving_dt and key not in main:
            main[key] = rec
    _chunk_table(chunk_recs, _build.build_info().log)
    _redesign_table(redesigned, _build.build_info().log)
    # a whole COW flush: qwen3's serving pools (28 layers, SOI 7..21: 14 on
    # the outer table's 273 pages, 14 on the middle's 193), k, v and pos;
    # then an MLA flush (latent, rope, pos) of 2 + 2 layers
    kv = ((16, 8, 128), torch.bfloat16)
    pos = ((16,), torch.int32)
    main["copy_pages"] = _cow_flush_reading(
        "qwen3 flush 28 layers x (k, v, pos)",
        [(273, 14, (kv, kv, pos)), (193, 14, (kv, kv, pos))], dev, gen)
    mla = (((16, 512), torch.bfloat16), ((16, 64), torch.bfloat16), pos)
    _cow_flush_reading("MLA flush 4 layers x (latent, rope, pos)",
                       [(273, 2, mla), (193, 2, mla)], dev, gen)
    _unet_conv_sweep(dev, gen)
    return main


# ---------------------------------------------------------------------------
# 4. end-to-end parity, card vs CPU
# ---------------------------------------------------------------------------

def _parity_cfg(mode):
    from repro_torch.configs import qwen3_1_7b
    from repro_torch.configs.base import SOILMCfg
    full = qwen3_1_7b.config(soi=mode)
    seg = dataclasses.replace(full.segments[0], n_layers=4)
    return dataclasses.replace(
        full, segments=(seg,), dtype="float32",
        soi=SOILMCfg(first_layer=1, last_layer=3, mode=mode))


def _greedy(engine, params, prompts, n_steps=8, late_at=3):
    """Slots 0 and 1 from the start, slot 2 after ``late_at`` steps,
    greedy. Returns per step (logits of the active slots, their tokens,
    the active slots)."""
    ds = engine.init_decode_state(params)
    steps = []
    active = []
    for slot in (0, 1):
        ds = engine.insert(engine.prefill(params, prompts[slot]), ds, slot)
        active.append(slot)
    for k in range(n_steps):
        if k == late_at:
            ds = engine.insert(engine.prefill(params, prompts[2]), ds, 2)
            active.append(2)
        ds, res = engine.generate(params, ds)
        toks = res.convert_to_numpy().data[:, 0]
        steps.append((res.logits[active].float().cpu(),
                      [int(toks[s]) for s in active], list(active)))
    return steps


def _compare_runs(runs, label):
    """Tokens identical and logits within 1e-3 at every step of a
    (CPU run, card run) pair; returns the largest logit difference."""
    worst = 0.0
    for k, ((lc, tc, act), (lg, tg, _)) in enumerate(zip(*runs)):
        err = float((lc - lg).abs().max())
        worst = max(worst, err)
        if tc != tg:
            top = torch.topk(lc, 2, dim=-1).values
            gaps = (top[:, 0] - top[:, 1]).tolist()
            raise RuntimeError(
                f"parity {label} step {k}: tokens differ (cpu {tc}, cuda "
                f"{tg}, slots {act}); top-2 logit gaps on the CPU {gaps}")
        check(err < 1e-3, f"parity {label} step {k}: logits differ by "
                          f"{err} >= 1e-3")
    return worst


def parity_phase(dev) -> dict:
    """Returns the launch counts of the paged prefix-cache engine's card
    run (the path that copies pages on write)."""
    phase("4 parity (full-width qwen3, 4 layers, f32, card vs CPU)")
    from repro_torch.engine import SOIEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    paged_counts = None
    for mode in ("pp", "fp"):
        cfg = _parity_cfg(mode)
        cpu_model = T.init(cfg, generator=torch.Generator().manual_seed(1),
                           device="cpu")
        dev_model = copy.deepcopy(cpu_model).to(dev)
        gen = torch.Generator().manual_seed(2)
        prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen,
                                 dtype=torch.int32) for n in (200, 201, 150)]
        runs = []
        for where, model in ((torch.device("cpu"), cpu_model),
                             (dev, dev_model)):
            eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=256,
                            device=where)
            t0 = time.perf_counter()
            runs.append(_greedy(eng, model, [p.to(where) for p in prompts]))
            print(f"  {mode} {where}: 3 prefills + 8 steps in "
                  f"{time.perf_counter() - t0:.2f} s (host clock)")
        worst = _compare_runs(runs, mode)
        print(f"  {mode}: 8 steps, tokens identical, max|Δlogit| {worst:.3e}")
        if mode == "pp":
            # paged + chunked + prefix cache: 3 prompts sharing 128 tokens,
            # 66 steps, so each ring wraps (position 256, frame 128) onto
            # pages the index still shares and copies them on write
            shared = prompts[0][:128]
            pp = [torch.cat([shared, torch.randint(
                0, cfg.vocab, (n - 128,), generator=gen, dtype=torch.int32)])
                for n in (200, 201, 199)]
            runs, stats, flushes = [], [], []
            for where, model in ((torch.device("cpu"), cpu_model),
                                 (dev, dev_model)):
                eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=256,
                                device=where, paged=True, page_size=16,
                                prefill_chunk=64, prefix_cache=True)
                if where.type == "cuda":
                    ops.reset_launch_counts()
                t0 = time.perf_counter()
                runs.append(_greedy(eng, model, [p.to(where) for p in pp],
                                    n_steps=66))
                if where.type == "cuda":
                    torch.cuda.synchronize(dev)
                    paged_counts = ops.launch_counts()
                stats.append(eng.prefix_cache_stats)
                flushes.append(eng.cow_flushes)
                print(f"  paged {where}: 3 chunked prefills + 66 steps in "
                      f"{time.perf_counter() - t0:.2f} s (host clock); "
                      f"prefix cache {stats[-1]}; {flushes[-1]} COW flushes")
            worst = _compare_runs(runs, "paged pp")
            check(stats[0] == stats[1], f"prefix-cache counters differ: cpu "
                                        f"{stats[0]}, cuda {stats[1]}")
            check(stats[1]["hits"] == 2 and stats[1]["cow_copies"] > 0,
                  f"expected 2 hits and copies on write: {stats[1]}")
            # one copy_pages launch a COW flush, every pool leaf in it
            check(paged_counts["copy_pages"] == flushes[1] == flushes[0] > 0,
                  f"copy_pages launches {paged_counts['copy_pages']} != COW "
                  f"flushes (cpu {flushes[0]}, cuda {flushes[1]})")
            check(paged_counts["chunk_attention"] > 0
                  and paged_counts["paged_decode_attention"] > 0,
                  f"paged run launches {paged_counts}")
            check(paged_counts["decode_attention"] == 0
                  and paged_counts["flash_attention"] == 0,
                  f"the paged chunked run used a dense kernel: "
                  f"{paged_counts}")
            print(f"  paged pp: 66 steps, tokens identical, max|Δlogit| "
                  f"{worst:.3e}; card launches {paged_counts}")
        del cpu_model, dev_model
    return paged_counts


# ---------------------------------------------------------------------------
# 5. serve
# ---------------------------------------------------------------------------

# the plain serve runs' tokens (phases 5 and 6), which the speculative
# serves of phase 15 must equal
PLAIN_SEQS: dict = {}
# the kernels phase 15's speculative serves launch, and which run's count
# the kernels line gives
SPEC_PATHS = {"decode_attention": "dense",
              "paged_decode_attention": "paged",
              "copy_pages": "paged"}


def serve_phase(dev):
    phase("5 serve (qwen3-1.7b full width, SOI pp, 4 requests)")
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = configs.get("qwen3-1.7b", soi="pp")
    torch.cuda.reset_peak_memory_stats(dev)
    args = serve.parse_args(SERVE_ARGV)
    ops.reset_launch_counts()
    res = serve.run(args)
    counts = ops.launch_counts()
    n_req = len(res.seqs)
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    want_flash = cfg.n_layers * n_req
    want_decode = n_outer * res.steps + n_mid * res.mid_steps
    print(f"  prefill {res.prefill_s:.3f} s for {n_req} requests, decode "
          f"{res.decoded} tokens in {res.decode_s:.3f} s = "
          f"{res.decoded / res.decode_s:.1f} tok/s (host clock); "
          f"{res.steps} steps, {res.mid_steps} with the middle; peak device "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print(f"  launches {counts}; expected flash_attention {want_flash}, "
          f"decode_attention {want_decode}")
    check(res.seqs.shape == (4, 64), f"tokens shape {res.seqs.shape}")
    check(((res.seqs >= 0) & (res.seqs < cfg.vocab)).all(),
          "token ids outside [0, vocab)")
    check(counts["flash_attention"] == want_flash,
          f"flash_attention launches {counts['flash_attention']} != "
          f"{want_flash}")
    check(counts["decode_attention"] == want_decode,
          f"decode_attention launches {counts['decode_attention']} != "
          f"{want_decode}")
    PLAIN_SEQS["dense"] = res.seqs
    # the same traffic again under the profiler (CUDA activity only; the
    # weights are built before it starts): device busy and idle share of
    # the prefill window and of the decode loop, which starts after the
    # last prefill kernel; kernel time by name over each window
    print("  profiled rerun:")
    _cfg, params, prompt, plens, engine = serve.setup(args)
    ev = _device_events(lambda: serve.serve(engine, params, prompt, plens,
                                            args.gen_len))
    check(ev, "the profiler saw no device activity")
    _prefill_profile(ev, n_req, "flash_attention_kernel")
    _decode_profile(ev, res.steps, "flash_attention_kernel")
    del params, engine
    return counts


def _named(name: str, kernels) -> bool:
    """Is the device event ``name`` one of ``kernels`` (a name or a tuple
    of names)?"""
    kernels = (kernels,) if isinstance(kernels, str) else kernels
    return any(k in name for k in kernels)


def _prefill_profile(ev, n_req: int, kernel):
    """Device busy time and idle share of a serve run's prefill window,
    from its first device event to the end of the last ``kernel`` (the
    prefill attention: a name or a tuple of names, e.g. a kernel and its
    merge), kernel time by name over it, and ``kernel``'s own device time
    in it; returns that time a request, in ms."""
    prefill_end = max(e for _s, e, n in ev if _named(n, kernel))
    window = [(s_, min(e, prefill_end), n) for s_, e, n in ev
              if s_ < prefill_end]
    busy = _window_profile(window, n_req, "prefill", "request")
    mine = sum(e - s_ for s_, e, n in window if _named(n, kernel))
    label = kernel if isinstance(kernel, str) else " + ".join(kernel)
    print(f"  {label} in the prefill window: {mine / 1e3:.3f} ms on the "
          f"device, {mine / busy:.3f} of its busy time, "
          f"{mine / 1e3 / n_req:.4f} ms a request")
    return mine / 1e3 / n_req


def _decode_profile(ev, steps: int, prefill_kernel):
    """Device busy time and idle share of a serve run's decode loop, which
    starts after the last ``prefill_kernel`` (a name or a tuple of names);
    kernel time by name over that window. Returns the loop's device
    events."""
    prefill_end = max(e for _s, e, n in ev if _named(n, prefill_kernel))
    loop = [(s_, e, n) for s_, e, n in ev if s_ >= prefill_end]
    _window_profile(loop, steps, "decode", "step")
    return loop


# the decode reads' device kernels: the split body (bf16 or float32) and
# the combine
READ_KERNELS = {"split": ("decode_mma_kernel", "decode_scalar_kernel"),
                "combine": ("decode_combine_kernel",)}
# the paged MLA read's: its split body (both dtypes share the name) and
# the same combine
MLA_READ_KERNELS = {"split": ("paged_mla_decode_attention_kernel",),
                    "combine": ("decode_combine_kernel",)}


def _reads_per_step(loop, steps: int, label: str,
                    kernels=READ_KERNELS) -> float:
    """Print and return the decode reads' device ms per step in a decode
    loop's events, split kernel and combine apart."""
    ms = {part: sum(e - s_ for s_, e, n in loop
                    if any(k in n for k in needles)) / 1e3
          for part, needles in kernels.items()}
    total = sum(ms.values())
    check(total > 0, f"{label}: no decode read in the decode loop")
    print(f"  {label} decode reads: {total:.3f} ms on the device in "
          f"{steps} steps = {total / steps:.4f} ms a step (split "
          f"{ms['split'] / steps:.4f}, combine {ms['combine'] / steps:.4f})")
    return total / steps


def _window_profile(ev, n: int, label: str, unit: str):
    """Print the device busy time and idle share of the window the device
    events ``ev`` span, busy time per ``unit`` (``n`` of them), and kernel
    time by name; returns the busy µs."""
    window = max(e for _s, e, _n in ev) - min(s_ for s_, _e, _n in ev)
    busy = _busy_us([(s_, e) for s_, e, _n in ev])
    by_name: dict = {}
    for s_, e, name in ev:
        key = name.removeprefix("void ")[:70]
        by_name[key] = by_name.get(key, 0.0) + (e - s_)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"  {label} window {window / 1e3:.2f} ms on the device clock, "
          f"busy {busy / 1e3:.2f} ms, idle share {1 - busy / window:.3f}; "
          f"per {unit} busy {busy / 1e3 / n:.3f} ms")
    for key, us in top:
        print(f"    {us / 1e3:9.3f} ms  {key}")
    return busy


@torch.no_grad()
def _warm_equals_cold(args, cold_args, cfg=None):
    """The random model's greedy tokens barely vary, so hold the bits
    instead: request 1 of the serve traffic (a hit at 768 tokens) prefills
    to the same logits and prefill caches with the prefix cache as without,
    and one generate step over requests 0 and 1 (one reading shared pages)
    gives the same logits. ``cfg`` replaces the config ``--arch`` names."""
    from repro_torch.launch import serve
    out = []
    for a in (args, cold_args):
        _cfg, params, prompt, plens, engine = serve.setup(a, cfg)
        ds = engine.init_decode_state(params)
        prefixes = []
        for slot in (0, 1):
            prefixes.append(engine.prefill(params, prompt[slot, :plens[slot]]))
            ds = engine.insert(prefixes[-1], ds, slot)
        _ds, res = engine.generate(params, ds)
        out.append((prefixes[1], res.logits[:2].clone(),
                    engine.prefix_cache_stats["hits"]))
        del params, ds, _ds
    (pw, lw, hits), (pc, lc, _) = out
    check(hits == 1, f"request 1 did not hit the prefix cache ({hits})")
    check(torch.equal(pw.logits, pc.logits),
          "a hit's prefill logits differ from the cold prefill's")
    for group in ("pre", "mid", "post"):
        for i, (cw, cc) in enumerate(zip(pw.state[group], pc.state[group])):
            for name in cc:              # k, v, pos / latent, rope, pos
                check(torch.equal(cw[name], cc[name]),
                      f"prefill cache {group}[{i}].{name}: warm != cold")
    for name in ("conv_buf", "queue"):
        check(torch.equal(pw.state[name], pc.state[name]),
              f"prefill {name}: warm != cold")
    check(torch.equal(lw, lc), "decode logits over shared pages differ "
                               "from the cold run's")
    print("  bit for bit with the cold run: a hit's prefill logits, caches, "
          "conv window and queue, and a decode step's logits")


def paged_serve_phase(dev):
    phase("6 paged serve (qwen3-1.7b full width, SOI pp, --paged "
          "--chunk-size 256 --prefix-cache, shared prefix 768)")
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = configs.get("qwen3-1.7b", soi="pp")
    args = serve.parse_args(PAGED_ARGV + ["--prefix-cache"])
    cold_args = serve.parse_args(PAGED_ARGV)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    res = serve.run(args)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    chunk = 256
    # the miss computes every chunk of its prompt; a hit at 768 computes
    # the chunks past it (one, for prompts of 1018..1022 tokens)
    plens = res.plens
    hit_at = 768
    want_chunks = (-(-plens[0] // chunk)
                   + sum(-(-p // chunk) - hit_at // chunk for p in plens[1:]))
    want_chunk = (n_outer + n_mid) * want_chunks
    want_paged = n_outer * res.steps + n_mid * res.mid_steps
    pc = res.prefix_cache
    print(f"  prefill {res.prefill_s:.3f} s for {len(res.seqs)} requests, "
          f"decode {res.decoded} tokens in {res.decode_s:.3f} s = "
          f"{res.decoded / res.decode_s:.1f} tok/s (host clock); "
          f"{res.steps} steps, {res.mid_steps} with the middle; peak device "
          f"memory {peak:.2f} GiB")
    print(f"  prefix cache {pc}; pools {res.pools}")
    print(f"  launches {counts}; expected chunk_attention {want_chunk} "
          f"({want_chunks} chunks x {n_outer + n_mid} layers), "
          f"paged_decode_attention {want_paged}, copy_pages "
          f"{res.cow_flushes} (COW flushes)")
    check(res.seqs.shape == (4, 64), f"tokens shape {res.seqs.shape}")
    check(((res.seqs >= 0) & (res.seqs < cfg.vocab)).all(),
          "token ids outside [0, vocab)")
    check(pc["hits"] == 3 and pc["misses"] == 1
          and pc["tokens_skipped"] == 3 * hit_at,
          f"prefix-cache counters {pc}")
    check(want_chunk == 196 and counts["chunk_attention"] == want_chunk,
          f"chunk_attention launches {counts['chunk_attention']} != "
          f"{want_chunk}")
    check(counts["paged_decode_attention"] == want_paged,
          f"paged_decode_attention launches "
          f"{counts['paged_decode_attention']} != {want_paged}")
    check(counts["decode_attention"] == 0 and counts["flash_attention"] == 0,
          f"the paged chunked path launched a dense kernel: {counts}")
    check(counts["copy_pages"] == res.cow_flushes,
          f"copy_pages launches {counts['copy_pages']} != COW flushes "
          f"{res.cow_flushes}")
    PLAIN_SEQS["paged"] = res.seqs
    cold = serve.run(cold_args)
    check(cold.prefix_cache == {} and (cold.seqs == res.seqs).all(),
          "tokens with the prefix cache differ from the cold run")
    print(f"  tokens identical to the cold run (no prefix cache: prefill "
          f"{cold.prefill_s:.3f} s, decode "
          f"{cold.decoded / cold.decode_s:.1f} tok/s, host clock)")
    _warm_equals_cold(args, cold_args)
    print("  profiled rerun:")
    ev = _device_events(lambda: serve.run(args))
    check(ev, "the profiler saw no device activity")
    # the chunks' range kernel and, split, their merge
    chunk = ("chunk_attention_kernel", "chunk_combine_kernel")
    _prefill_profile(ev, len(res.seqs), chunk)
    _decode_profile(ev, res.steps, chunk)
    return counts


# ---------------------------------------------------------------------------
# 7-9. deepseek-v2: MLA and MoE on the SOI engine
# ---------------------------------------------------------------------------

def _cpu_copy(model, cfg):
    """The same weights on the host (built on the card, where random init
    is fast, and copied)."""
    from repro_torch.models import transformer as T
    cpu = T.Transformer(cfg, generator=torch.Generator(), device="meta")
    cpu.load_state_dict({k: v.to("cpu") for k, v in
                         model.state_dict().items()}, assign=True)
    return cpu


def _free(dev):
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()


def deepseek_parity_phase(dev) -> dict:
    """Returns the launch counts of the paged engine's card run."""
    phase("7 ds-parity (full-width deepseek-v2, 2 layers: dense layer 0 + "
          "one MoE middle, f32, SOI pp, card vs CPU)")
    from repro_torch.configs import deepseek_v2_236b as DS
    from repro_torch.engine import SOIEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(DS.config(soi="pp", n_layers=2),
                              dtype="float32")
    t0 = time.perf_counter()
    dev_model = T.init(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(1), device=dev)
    cpu_model = _cpu_copy(dev_model, cfg)
    n_par = sum(p.numel() for p in dev_model.parameters())
    print(f"  {n_par / 1e9:.2f} B float32 parameters, 160 routed experts "
          f"(no cut), on the card and on the host "
          f"({time.perf_counter() - t0:.1f} s to build and copy)")
    gen = torch.Generator().manual_seed(2)
    # odd prompt lengths: one MoE dispatch group, so the host's expert
    # products stay small (the card's are the same computation)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen,
                             dtype=torch.int32) for n in (41, 43, 37)]
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    out = {}
    for layout, kw in (("dense", {}),
                       ("paged", dict(paged=True, page_size=16))):
        runs = []
        for where, model in ((torch.device("cpu"), cpu_model),
                             (dev, dev_model)):
            eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=64,
                            device=where, **kw)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            runs.append(_greedy(eng, model, [p.to(where) for p in prompts]))
            torch.cuda.synchronize(dev)
            counts = ops.launch_counts()          # the card run's, last
            print(f"  {layout} {where}: 3 prefills + 8 steps in "
                  f"{time.perf_counter() - t0:.2f} s (host clock)")
        worst = _compare_runs(runs, f"deepseek {layout}")
        want_paged = (n_outer * eng.steps + n_mid * eng.mid_steps
                      if layout == "paged" else 0)
        print(f"  {layout}: 8 steps, tokens identical, max|Δlogit| "
              f"{worst:.3e}; card launches {counts}")
        check(counts["flash_attention"] == 3 * cfg.n_layers,
              f"flash_attention launches {counts['flash_attention']} != "
              f"{3 * cfg.n_layers} (3 prefills x {cfg.n_layers} layers)")
        check(counts["paged_mla_decode_attention"] == want_paged,
              f"paged_mla_decode_attention launches "
              f"{counts['paged_mla_decode_attention']} != {want_paged}")
        out[layout] = counts
    del cpu_model, dev_model
    _free(dev)
    return out["paged"]


DS_SERVE_ARGV = ["--arch", "deepseek-v2-236b", "--layers", "4", "--soi",
                 "pp", "--batch", "4", "--prompt-len", "1024", "--stagger",
                 "2", "--gen-len", "64", "--seed", "0", "--paged",
                 "--page-size", "16"]


@torch.no_grad()
def _phase_step_ms(engine, params, prompt, plens, n_steps=16):
    """Prefill every request, then time ``n_steps`` generate steps one by
    one (host clock, each ended by a synchronize); returns the median ms
    of the steps that ran the SOI middle and of those that skipped it."""
    ds = engine.init_decode_state(params)
    for slot, n in enumerate(plens):
        ds = engine.insert(engine.prefill(params, prompt[slot, :n]), ds, slot)
    torch.cuda.synchronize(engine.device)
    on, off = [], []
    for _ in range(n_steps):
        mid0 = engine.mid_steps
        t0 = time.perf_counter()
        ds, _res = engine.generate(params, ds)
        torch.cuda.synchronize(engine.device)
        (on if engine.mid_steps > mid0 else off).append(
            (time.perf_counter() - t0) * 1e3)
    check(on and off, f"steps with the middle {len(on)}, without {len(off)}")
    return sorted(on)[len(on) // 2], sorted(off)[len(off) // 2]


def deepseek_serve_phase(dev) -> dict:
    phase("8 ds-serve (deepseek-v2 full width, 4 layers = 1 dense + 3 MoE, "
          "bf16, SOI pp, --paged --page-size 16, exact-length prefill)")
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve.parse_args(DS_SERVE_ARGV)
    t0 = time.perf_counter()
    cfg, params, prompt, plens, engine = serve.setup(args)
    torch.cuda.synchronize(dev)
    print(f"  {sum(p.numel() for p in params.parameters()) / 1e9:.2f} B "
          f"bf16 parameters built in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    res = serve.serve(engine, params, prompt, plens, args.gen_len)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    want_flash = cfg.n_layers * len(res.seqs)
    want_paged = n_outer * res.steps + n_mid * res.mid_steps
    print(f"  prefill {res.prefill_s:.3f} s for {len(res.seqs)} requests "
          f"(lens {plens}), decode {res.decoded} tokens in "
          f"{res.decode_s:.3f} s = {res.decoded / res.decode_s:.1f} tok/s "
          f"(host clock); {res.steps} steps, {res.mid_steps} with the "
          f"middle; peak device memory {peak:.2f} GiB; pools {res.pools}")
    print(f"  launches {counts}; expected flash_attention {want_flash} "
          f"({cfg.n_layers} layers x {len(res.seqs)} requests), "
          f"paged_mla_decode_attention {want_paged} ({n_outer} outer "
          f"layers x {res.steps} steps + {n_mid} middle x {res.mid_steps})")
    check(res.seqs.shape == (4, 64), f"tokens shape {res.seqs.shape}")
    check(((res.seqs >= 0) & (res.seqs < cfg.vocab)).all(),
          "token ids outside [0, vocab)")
    check(want_flash == 16 and counts["flash_attention"] == want_flash,
          f"flash_attention launches {counts['flash_attention']} != 16")
    check(want_paged == 192
          and counts["paged_mla_decode_attention"] == want_paged,
          f"paged_mla_decode_attention launches "
          f"{counts['paged_mla_decode_attention']} != 192")
    others = {k: v for k, v in counts.items()
              if k not in ("flash_attention", "paged_mla_decode_attention")}
    check(not any(others.values()), f"unexpected launches {others}")
    on, off = _phase_step_ms(engine, params, prompt, plens)
    print(f"  step time (host clock after a synchronize, median): "
          f"{on:.3f} ms with the SOI middle (phase 0), {off:.3f} ms "
          f"without; ratio {on / off:.3f}")
    print("  profiled rerun:")
    ev = _device_events(lambda: serve.serve(engine, params, prompt, plens,
                                            args.gen_len))
    check(ev, "the profiler saw no device activity")
    _prefill_profile(ev, len(res.seqs), "flash_attention_kernel")
    loop = _decode_profile(ev, res.steps, "flash_attention_kernel")
    _reads_per_step(loop, res.steps, "paged MLA", MLA_READ_KERNELS)
    del params, engine
    _free(dev)
    return counts


MLA_ARGV = ["--arch", "deepseek-v2-236b", "--soi", "pp", "--batch", "4",
            "--prompt-len", "1024", "--stagger", "2", "--gen-len", "64",
            "--seed", "0", "--paged", "--page-size", "16", "--chunk-size",
            "256", "--shared-prefix", "768"]


def mla_phase(dev) -> tuple:
    """Returns the launch counts of the card's parity run (the path whose
    rings wrap and copy MLA pages on write) and of the serve run."""
    phase("9 mla (deepseek-v2 layer-0 block: MLA + SwiGLU 12288, full "
          "width, SOI pp, chunked prefill + prefix cache)")
    from repro_torch.configs import deepseek_v2_236b as DS
    from repro_torch.engine import SOIEngine
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    # card against CPU, f32, 2 layers: 3 prompts of ~100 tokens sharing
    # their first 64, 34 steps, so every ring wraps (position 128, frame 64)
    # onto pages the index still shares and copies latent/rope/pos pages
    cfg = dataclasses.replace(DS.mla_dense_config(soi="pp", n_layers=2),
                              dtype="float32")
    dev_model = T.init(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(3), device=dev)
    cpu_model = _cpu_copy(dev_model, cfg)
    gen = torch.Generator().manual_seed(4)
    shared = torch.randint(0, cfg.vocab, (64,), generator=gen,
                           dtype=torch.int32)
    prompts = [torch.cat([shared, torch.randint(
        0, cfg.vocab, (n - 64,), generator=gen, dtype=torch.int32)])
        for n in (100, 101, 99)]
    runs, stats, flushes = [], [], []
    for where, model in ((torch.device("cpu"), cpu_model), (dev, dev_model)):
        eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=128,
                        device=where, paged=True, page_size=16,
                        prefill_chunk=32, prefix_cache=True)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        runs.append(_greedy(eng, model, [p.to(where) for p in prompts],
                            n_steps=34))
        torch.cuda.synchronize(dev)
        cow_counts = ops.launch_counts()          # the card run's, last
        stats.append(eng.prefix_cache_stats)
        flushes.append(eng.cow_flushes)
        print(f"  parity {where}: 3 chunked prefills + 34 steps in "
              f"{time.perf_counter() - t0:.2f} s (host clock); prefix cache "
              f"{stats[-1]}; {flushes[-1]} COW flushes")
    worst = _compare_runs(runs, "mla paged")
    check(stats[0] == stats[1], f"prefix-cache counters differ: cpu "
                                f"{stats[0]}, cuda {stats[1]}")
    check(stats[1]["hits"] == 2 and stats[1]["cow_copies"] > 0,
          f"expected 2 hits and copies on write: {stats[1]}")
    check(cow_counts["copy_pages"] == flushes[1] == flushes[0] > 0,
          f"copy_pages launches {cow_counts['copy_pages']} != COW flushes "
          f"(cpu {flushes[0]}, cuda {flushes[1]})")
    check(cow_counts["mla_chunk_attention"] > 0
          and cow_counts["paged_mla_decode_attention"] > 0,
          f"parity run launches {cow_counts}")
    gqa = ("decode_attention", "flash_attention", "chunk_attention",
           "paged_decode_attention")
    check(not any(cow_counts[k] for k in gqa),
          f"the MLA run launched a GQA kernel: {cow_counts}")
    print(f"  parity: 34 steps, tokens identical, max|Δlogit| {worst:.3e}; "
          f"card launches {cow_counts} (copy_pages on the latent, rope and "
          f"pos pools)")
    del cpu_model, dev_model
    _free(dev)

    cfg = DS.mla_dense_config(soi="pp", n_layers=4)
    args = serve.parse_args(MLA_ARGV + ["--prefix-cache"])
    cold_args = serve.parse_args(MLA_ARGV)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    res = serve.run(args, cfg)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    chunk, hit_at = 256, 768
    plens = res.plens
    want_chunks = (-(-plens[0] // chunk)
                   + sum(-(-p // chunk) - hit_at // chunk for p in plens[1:]))
    want_chunk = cfg.n_layers * want_chunks
    want_paged = n_outer * res.steps + n_mid * res.mid_steps
    pc = res.prefix_cache
    print(f"  serve, 4 bf16 layers: prefill {res.prefill_s:.3f} s for "
          f"{len(res.seqs)} requests, decode {res.decoded} tokens in "
          f"{res.decode_s:.3f} s = {res.decoded / res.decode_s:.1f} tok/s "
          f"(host clock); {res.steps} steps, {res.mid_steps} with the "
          f"middle; peak device memory {peak:.2f} GiB")
    print(f"  prefix cache {pc}; pools {res.pools}")
    print(f"  launches {counts}; expected mla_chunk_attention {want_chunk} "
          f"({want_chunks} chunks x {cfg.n_layers} layers), "
          f"paged_mla_decode_attention {want_paged}")
    check(res.seqs.shape == (4, 64), f"tokens shape {res.seqs.shape}")
    check(pc["hits"] == 3 and pc["misses"] == 1
          and pc["tokens_skipped"] == 3 * hit_at,
          f"prefix-cache counters {pc}")
    check(want_chunk == 28 and counts["mla_chunk_attention"] == want_chunk,
          f"mla_chunk_attention launches {counts['mla_chunk_attention']} "
          f"!= 28")
    check(counts["paged_mla_decode_attention"] == want_paged,
          f"paged_mla_decode_attention launches "
          f"{counts['paged_mla_decode_attention']} != {want_paged}")
    check(not any(counts[k] for k in gqa),
          f"the MLA serve launched a GQA kernel: {counts}")
    check(counts["copy_pages"] == res.cow_flushes,
          f"copy_pages launches {counts['copy_pages']} != COW flushes "
          f"{res.cow_flushes}")
    cold = serve.run(cold_args, cfg)
    check(cold.prefix_cache == {} and (cold.seqs == res.seqs).all(),
          "tokens with the prefix cache differ from the cold run")
    print(f"  tokens identical to the cold run (no prefix cache: prefill "
          f"{cold.prefill_s:.3f} s, decode "
          f"{cold.decoded / cold.decode_s:.1f} tok/s, host clock)")
    _warm_equals_cold(args, cold_args, cfg)
    print("  profiled rerun:")
    ev = _device_events(lambda: serve.run(args, cfg))
    check(ev, "the profiler saw no device activity")
    _prefill_profile(ev, len(res.seqs), "mla_chunk_attention_kernel")
    _decode_profile(ev, res.steps, "mla_chunk_attention_kernel")
    _free(dev)
    return cow_counts, counts


# ---------------------------------------------------------------------------
# 10-11. recurrentgemma: RG-LRU and windowed MQA on the SOI engine
# ---------------------------------------------------------------------------

def _rg_counts(cfg):
    """(outer attention layers, middle attention layers, RG-LRU layers) of
    an SOI config."""
    from repro_torch.models import transformer as T
    parts = T.soi_partition(cfg)
    blocks = [T.layer_blocks(dataclasses.replace(cfg, segments=tuple(p)))
              for p in parts]
    n_att = [sum(b.attn is not None for b in bl) for bl in blocks]
    n_rec = sum(b.rglru is not None for b in T.layer_blocks(cfg))
    return n_att[0] + n_att[2], n_att[1], n_rec


def rg_parity_phase(dev) -> dict:
    """Returns the launch counts of the paged pp engine's card run."""
    phase("10 rg-parity (full-width recurrentgemma-9b, 12 layers, f32, SOI "
          "pp/fp, dense and paged, card vs CPU)")
    from repro_torch.configs import recurrentgemma_9b as RG
    from repro_torch.engine import SOIEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    cfgs = {mode: dataclasses.replace(RG.config(soi=mode, n_layers=12),
                                      dtype="float32")
            for mode in ("pp", "fp")}
    t0 = time.perf_counter()
    dev_model = T.init(cfgs["pp"], generator=torch.Generator(device=dev)
                       .manual_seed(5), device=dev)
    cpu_model = _cpu_copy(dev_model, cfgs["pp"])
    n_par = sum(p.numel() for p in dev_model.parameters())
    soi = cfgs["pp"].soi
    print(f"  {n_par / 1e9:.2f} B float32 parameters (SOI pre "
          f"0..{soi.first_layer - 1}, middle {soi.first_layer}.."
          f"{soi.last_layer - 1}, post {soi.last_layer}..11), on the card "
          f"and on the host "
          f"({time.perf_counter() - t0:.1f} s to build and copy)")
    gen = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, cfgs["pp"].vocab, (n,), generator=gen,
                             dtype=torch.int32) for n in (41, 43, 37)]
    n_outer, n_mid, n_rec = _rg_counts(cfgs["pp"])
    out = {}
    for mode, cfg in cfgs.items():
        for layout, kw in (("dense", {}),
                           ("paged", dict(paged=True, page_size=16))):
            runs = []
            for where, model in ((torch.device("cpu"), cpu_model),
                                 (dev, dev_model)):
                eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=64,
                                device=where, **kw)
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                runs.append(_greedy(eng, model,
                                    [p.to(where) for p in prompts]))
                torch.cuda.synchronize(dev)
                counts = ops.launch_counts()      # the card run's, last
                print(f"  {mode} {layout} {where}: 3 prefills + 8 steps in "
                      f"{time.perf_counter() - t0:.2f} s (host clock)")
            worst = _compare_runs(runs, f"recurrentgemma {mode} {layout}")
            read = ("paged_decode_attention" if layout == "paged"
                    else "decode_attention")
            want = {"lru_scan": 3 * n_rec,
                    read: n_outer * eng.steps + n_mid * eng.mid_steps}
            print(f"  {mode} {layout}: 8 steps, tokens identical, "
                  f"max|Δlogit| {worst:.3e}; card launches {counts}")
            for name, n in counts.items():
                check(n == want.get(name, 0),
                      f"{mode} {layout}: {name} launches {n} != "
                      f"{want.get(name, 0)} (expected {want})")
            out[(mode, layout)] = counts
    del cpu_model, dev_model
    _free(dev)
    return out[("pp", "paged")]


RG_ARGV = ["--arch", "recurrentgemma-9b", "--soi", "pp", "--batch", "4",
           "--prompt-len", "2040", "--stagger", "2", "--gen-len", "64",
           "--seed", "0"]


def rg_serve_phase(dev) -> dict:
    """Returns {"dense": counts, "paged": counts} of the two serve runs."""
    phase("11 rg-serve (recurrentgemma-9b full depth, 38 layers, bf16, SOI "
          "pp, 4 requests of 2040..2034 tokens, 64 generated: dense, then "
          "--paged --page-size 16)")
    from repro_torch.engine import SOIEngine
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve.parse_args(RG_ARGV)
    t0 = time.perf_counter()
    cfg, params, prompt, plens, engine = serve.setup(args)
    torch.cuda.synchronize(dev)
    print(f"  {sum(p.numel() for p in params.parameters()) / 1e9:.2f} B "
          f"bf16 parameters built in {time.perf_counter() - t0:.1f} s")
    n_outer, n_mid, n_rec = _rg_counts(cfg)
    engines = {"dense": engine,
               "paged": SOIEngine(cfg, max_concurrent_decodes=args.batch,
                                  max_len=args.prompt_len + args.gen_len,
                                  device=dev, paged=True, page_size=16)}
    out, seqs = {}, {}
    for layout, eng in engines.items():
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        res = serve.serve(eng, params, prompt, plens, args.gen_len)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        read = ("paged_decode_attention" if layout == "paged"
                else "decode_attention")
        want = {"lru_scan": n_rec * len(res.seqs),
                read: n_outer * res.steps + n_mid * res.mid_steps}
        print(f"  {layout}: prefill {res.prefill_s:.3f} s for "
              f"{len(res.seqs)} requests (lens {plens}), decode "
              f"{res.decoded} tokens in {res.decode_s:.3f} s = "
              f"{res.decoded / res.decode_s:.1f} tok/s (host clock); "
              f"{res.steps} steps, {res.mid_steps} with the middle; peak "
              f"device memory {peak:.2f} GiB; pools {res.pools}")
        print(f"  {layout} launches {counts}; expected {want} ({n_rec} "
              f"RG-LRU layers x {len(res.seqs)} prefills; {n_outer} outer "
              f"attention layers x {res.steps} steps + {n_mid} middle x "
              f"{res.mid_steps})")
        check(res.seqs.shape == (4, 64), f"tokens shape {res.seqs.shape}")
        check(((res.seqs >= 0) & (res.seqs < cfg.vocab)).all(),
              "token ids outside [0, vocab)")
        check(want["lru_scan"] == 104 and want[read] == 576,
              f"expected counts moved: {want}")
        for name, n in counts.items():
            check(n == want.get(name, 0),
                  f"{layout}: {name} launches {n} != {want.get(name, 0)}")
        out[layout], seqs[layout] = counts, res.seqs
        on, off = _phase_step_ms(eng, params, prompt, plens)
        print(f"  {layout} step time (host clock after a synchronize, "
              f"median): {on:.3f} ms with the SOI middle (phase 0), "
              f"{off:.3f} ms without; ratio {on / off:.3f}")
    check((seqs["dense"] == seqs["paged"]).all(),
          "paged tokens differ from the dense run's")
    print("  tokens identical between the dense and the paged run")
    for layout in ("dense", "paged"):
        print(f"  profiled rerun ({layout}):")
        ev = _device_events(lambda: serve.serve(engines[layout], params,
                                                prompt, plens, args.gen_len))
        check(ev, "the profiler saw no device activity")
        _prefill_profile(ev, len(res.seqs), "lru_scan_kernel")
        loop = _decode_profile(ev, res.steps, "lru_scan_kernel")
        _reads_per_step(loop, res.steps, layout)
    del params, engines, engine
    _free(dev)
    return out


# ---------------------------------------------------------------------------
# 12-13. the paper's streaming U-Net: the STMC/SOI stream on stmc_conv
# ---------------------------------------------------------------------------

# the 11 SOI configurations of tests/test_soi_unet.py
UNET_SOIS = (None, dict(pairs=(1,)), dict(pairs=(2,)), dict(pairs=(4,)),
             dict(pairs=(1, 3)), dict(pairs=(2, 4)),
             dict(pairs=(2,), mode="fp"), dict(pairs=(1,), mode="fp"),
             dict(pairs=(1,), mode="fp", shift_pos=3),
             dict(pairs=(2,), extrapolation="tconv"),
             dict(pairs=(2,), mode="fp", extrapolation="tconv"))
UNET_TOL = 1e-4
# (label, SOI, stmc_conv launches for 512 frames, reckoned by hand from the
# freshness predicates of models/unet.py; the check uses the plans' count)
STREAM_SOIS = (("STMC baseline", None, 7168),
               ("PP S-CC (3,)", dict(pairs=(3,)), 4608),
               ("PP 2xS-CC (1,3)", dict(pairs=(1, 3)), 2304),
               ("FP SS-CC (3,)", dict(pairs=(3,), mode="fp"), 4608))
STREAM_FRAMES = 512
FRAME_MS = 16.0                    # 62.5 fps: 256-sample hop at 16 kHz


def _soi_label(kw) -> str:
    if kw is None:
        return "none"
    return " ".join(f"{k}={v}" for k, v in kw.items())


def _unet_cfg(kw):
    from repro_torch.configs import soi_unet_dns as UD
    from repro_torch.core.soi import SOIConvCfg
    return UD.config(None if kw is None else SOIConvCfg(**kw))


def _unet_models(dev):
    """Full-width soi-unet-dns, float32, random from seed 7, on the host
    and on the card: the dup model, and the tconv model (the same layers —
    the same generator draws them first — plus the extrapolator up[2]).
    The reference's offline graph applies an ``up`` conv wherever the model
    has one, so the dup configurations get the model without."""
    from repro_torch.models import unet as U
    out = {}
    for kind, kw in (("dup", dict(pairs=(2,))),
                     ("tconv", dict(pairs=(2,), extrapolation="tconv"))):
        cpu = U.init(_unet_cfg(kw), generator=torch.Generator()
                     .manual_seed(7), device="cpu")
        out[kind] = (cpu, copy.deepcopy(cpu).to(dev))
    return out


def _planned_convs(cfg, n_frames: int) -> int:
    from repro_torch.models import unet as U
    per_phase = U.convs_per_phase(cfg)
    return sum(per_phase[t % cfg.period] for t in range(n_frames))


def _held_launches(counts: dict, want: int, label: str):
    for name, n in counts.items():
        expect = want if name == "stmc_conv" else 0
        check(n == expect, f"{label}: {name} launches {n} != {expect}")


def unet_parity_phase(dev):
    phase("12 unet-parity (full-width soi-unet-dns, f32, B 2, 48 frames, 11 "
          "SOI configs: card stream vs CPU stream vs card offline)")
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models import unet as U
    t0 = time.perf_counter()
    models = _unet_models(dev)
    n_par = sum(p.numel() for p in models["dup"][1].parameters())
    print(f"  {n_par / 1e6:.2f} M float32 parameters ({n_par * 4 / 1e6:.1f} "
          f"MB), on the card and on the host "
          f"({time.perf_counter() - t0:.1f} s to build and copy)")
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 48, 128)).astype(np.float32))
    x_dev = x.to(dev)
    for kw in UNET_SOIS:
        cfg = _unet_cfg(kw)
        tconv = kw is not None and kw.get("extrapolation") == "tconv"
        cpu_model, dev_model = models["tconv" if tconv else "dup"]
        label = _soi_label(kw)
        ops.reset_launch_counts()
        y_dev = U.stream_infer(dev_model, x_dev, cfg)
        torch.cuda.synchronize(dev)
        counts = ops.launch_counts()
        want = _planned_convs(cfg, 48)
        _held_launches(counts, want, f"unet stream {label}")
        y_cpu = U.stream_infer(cpu_model, x, cfg)
        y_off, _ = U.apply_offline(dev_model, x_dev, cfg)
        check(y_dev.shape == (2, 48, 128), f"{label}: shape {y_dev.shape}")
        check(bool(torch.isfinite(y_dev).all()), f"{label}: non-finite")
        d_cpu = float((y_dev.cpu() - y_cpu).abs().max())
        d_off = float((y_dev - y_off).abs().max())
        print(f"  {label}: max|Δ| card vs CPU {d_cpu:.3e}, stream vs offline "
              f"{d_off:.3e}; stmc_conv {counts['stmc_conv']} launches "
              f"(planned {want}); max|y| {float(y_dev.abs().max()):.3f}")
        check(d_cpu < UNET_TOL and d_off < UNET_TOL,
              f"{label}: max|Δ| {d_cpu} / {d_off} >= {UNET_TOL}")
    del models
    _free(dev)


def unet_stream_phase(dev) -> dict:
    """Returns the launch counts of the B 1 STMC-baseline stream."""
    phase(f"13 unet-stream (full-width soi-unet-dns, f32, "
          f"{STREAM_FRAMES} frames at B 1 and B 32; STMC baseline, PP "
          f"S-CC (3,), PP 2xS-CC (1,3), FP SS-CC (3,))")
    from repro_torch.engine.session import unet_stream_session
    from repro_torch.kernels import ops
    from repro_torch.models import unet as U
    cfg0 = _unet_cfg(None)
    model = U.init(cfg0, generator=torch.Generator(device=dev).manual_seed(9),
                   device=dev)
    gen = torch.Generator(device=dev).manual_seed(10)
    main_counts = None
    for b in (1, 32):
        x = torch.randn((b, STREAM_FRAMES, 128), generator=gen, device=dev)
        base_ms = None
        for label, kw, hand_count in STREAM_SOIS:
            cfg = _unet_cfg(kw)
            planned = _planned_convs(cfg, STREAM_FRAMES)
            check(planned == hand_count,
                  f"{label}: planned {planned} != {hand_count}")
            # two periods first: every phase's graph captured (the timed
            # frames start again at phase 0)
            sess = unet_stream_session(model, cfg, batch=b, device=dev)
            for t in range(2 * cfg.period):
                sess.push(x[:, t])
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            per_phase: list = [[] for _ in range(cfg.period)]
            ops.reset_launch_counts()
            t_all = time.perf_counter()
            for t in range(STREAM_FRAMES):
                t0 = time.perf_counter()
                y = sess.push(x[:, t])
                torch.cuda.synchronize(dev)
                per_phase[t % cfg.period].append(
                    (time.perf_counter() - t0) * 1e3)
            total_s = time.perf_counter() - t_all
            counts = ops.launch_counts()
            _held_launches(counts, planned, f"{label} B {b}")
            check(y.shape == (b, 128) and bool(torch.isfinite(y).all()),
                  f"{label} B {b}: last frame {tuple(y.shape)} not finite")
            check(sess.graph.captures == cfg.period
                  and sess.graph.replays == STREAM_FRAMES + cfg.period,
                  f"{label} B {b}: {sess.graph.captures} captures, "
                  f"{sess.graph.replays} replays")
            if b == 1 and kw is None:
                main_counts = counts
            mean_ms = total_s * 1e3 / STREAM_FRAMES
            base_ms = mean_ms if base_ms is None else base_ms
            med = [sorted(v)[len(v) // 2] for v in per_phase]
            retain = U.complexity_report(cfg).retain
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
            print(f"  B {b} {label}: stmc_conv {counts['stmc_conv']} "
                  f"launches (planned {planned}); median step per phase "
                  f"{', '.join(f'{m:.3f}' for m in med)} ms; mean "
                  f"{mean_ms:.3f} ms = {STREAM_FRAMES / total_s:.1f} "
                  f"frames/s ({b * STREAM_FRAMES / total_s:.1f} stream "
                  f"frames/s), {FRAME_MS / mean_ms:.1f}x real time "
                  f"(16 ms a frame), worst step "
                  f"{max(max(v) for v in per_phase):.3f} ms; MAC retain "
                  f"{retain:.3f}, step-time ratio to the baseline "
                  f"{mean_ms / base_ms:.3f}; peak device memory "
                  f"{peak:.1f} MiB (host clock after a synchronize)")
        for label, kw, _n in (STREAM_SOIS[0], STREAM_SOIS[2]):
            cfg = _unet_cfg(kw)
            sess = unet_stream_session(model, cfg, batch=b, device=dev)
            for t in range(cfg.period):
                sess.push(x[:, t])            # the captures, unprofiled
            n_prof = 64

            def run():
                for t in range(n_prof):
                    sess.push(x[:, t])
            ev = _device_events(run)
            check(ev, "the profiler saw no device activity")
            print(f"  profiled rerun, B {b} {label}, {n_prof} frames:")
            busy = _window_profile(ev, n_prof, "stream", "frame")
            conv = sum(e - s_ for s_, e, n in ev if "stmc_conv_kernel" in n)
            print(f"  stmc_conv: {conv / 1e3:.3f} ms on the device in "
                  f"{n_prof} frames = {conv / 1e3 / n_prof:.4f} ms a frame, "
                  f"{conv / busy:.3f} of the busy time")
    del model
    _free(dev)
    return main_counts


# ---------------------------------------------------------------------------
# 14. graphs: the captured step programs against the eager steps
# ---------------------------------------------------------------------------

def _eager_twin(engine, ds):
    """A deep copy of ``engine`` (host tables, prefix index, clocks) and of
    its live decode state ``ds``, taken before the engine's first step,
    whose step runs ``gen_step`` — ``generate_step``, the argmax and the
    result rows — eagerly: the same host decisions, the same COW flushes
    and page-map copies, no graph."""
    from repro_torch.engine import soi_engine as SE
    twin, twin_ds = copy.deepcopy((engine, ds))
    cfg = twin.cfg
    twin.graph = lambda params, d, mid: SE.gen_step(params, cfg, d, mid)
    return twin, twin_ds


# the leaves of an attention cache: in a paged state, pools whose row 0 is
# the null page
POOL_LEAVES = ("['k']", "['v']", "['pos']", "['latent']", "['rope']")


def _state_equal(a, b, label, paged=False) -> tuple:
    """Every leaf of two state trees equal bit for bit; returns the count of
    leaves and of null-page elements that differ. In a paged state the null
    page (row 0 of every pool) takes the writes of slots that must not
    write (mid-window middle rows, shared prefix pages at insert), several
    to one row at once, so which lands is the scatter's choice; every read
    masks it. It is left out of the comparison and counted."""
    from repro_torch.engine.contracts import state_leaves
    la, lb = state_leaves(a), state_leaves(b)
    check([p for p, _ in la] == [p for p, _ in lb],
          f"{label}: the state trees differ")
    null_diff = 0
    for (path, x), (_, y) in zip(la, lb):
        if paged and path.startswith("['model']") and path.endswith(
                POOL_LEAVES):
            null_diff += int((x[0] != y[0]).sum())
            x, y = x[1:], y[1:]
        check(torch.equal(x, y),
              f"{label}: state leaf {path} differs from the eager step's")
    return len(la), null_diff


def _raises(exc, fn) -> str:
    try:
        fn()
    except exc as e:
        return str(e)
    raise RuntimeError(f"{exc.__name__} was not raised")


def _graph_parity(label, engine, params, prompts, n_steps, late_at, dev):
    """The graphed engine against its eager twin, bit for bit: tokens and
    logits every step, every leaf of the decode state at the end; a late
    insert after ``late_at`` steps. Returns the graphed state."""
    import numpy as np
    ds = engine.init_decode_state(params)
    for slot in (0, 1):
        ds = engine.insert(engine.prefill(params, prompts[slot].to(dev)), ds,
                           slot)
    twin, tds = _eager_twin(engine, ds)
    flushes0 = engine.cow_flushes
    t0 = time.perf_counter()
    for k in range(n_steps):
        if k == late_at:
            prefix = engine.prefill(params, prompts[2].to(dev))
            ds = engine.insert(prefix, ds, 2)
            tds = twin.insert(prefix, tds, 2)
        ds, res = engine.generate(params, ds)
        tds, tres = twin.generate(params, tds)
        check(torch.equal(res.logits, tres.logits),
              f"{label} step {k}: logits differ from the eager step's")
        check(np.array_equal(res.convert_to_numpy().data,
                             tres.convert_to_numpy().data),
              f"{label} step {k}: tokens differ from the eager step's")
    n_leaves, null_diff = _state_equal(ds, tds, label,
                                       paged=engine._paged)
    g = engine.graph
    want = 2 if engine.cfg.soi is not None else 1
    check(g.captures == want and g.replays == n_steps - want,
          f"{label}: {g.captures} captures, {g.replays} replays in "
          f"{n_steps} steps (want {want} captures)")
    stats = {str(k[0]): {"capture_s": round(v["capture_s"], 4),
                         "pool_MiB": round(v["pool_bytes"] / 2 ** 20, 2),
                         "copy_back_B": v["copy_back_bytes"]}
             for k, v in g.stats().items()}
    print(f"  {label}: {n_steps} steps graphed == eager bit for bit (tokens, "
          f"logits, {n_leaves} state leaves"
          f"{f'; null pages: {null_diff} elements differ' if engine._paged else ''}"
          f") in {time.perf_counter() - t0:.2f} s; {g.captures} captures, "
          f"{g.replays} replays, {engine.cow_flushes - flushes0} COW "
          f"flushes between replays; graphs {stats}", flush=True)
    return ds


def _refusals(label, engine, params, ds):
    """A rebound >= 16 KiB state leaf (the largest) and another params
    object are refused before a replay; the captured ones replay."""
    from repro_torch.engine import contracts as C
    g = engine.graph
    steps = C._steps(ds, [])
    path, big = max(steps, key=lambda st: st[1].nbytes)
    check(big.nbytes >= C.BIG_BYTES, f"{label}: no leaf of >= 16 KiB")
    branch = next(iter(g.stats()))[0]
    C._set_path(ds, path, big.clone())
    msg = _raises(C.DroppedDonationError,
                  lambda: g(params, ds, branch))
    C._set_path(ds, path, big)
    _raises(ValueError, lambda: g(copy.copy(params), ds, branch))
    print(f"  {label}: rebinding {''.join(f'[{s!r}]' for s in path)} "
          f"({big.nbytes} B) raised DroppedDonationError ({msg[:70]}...); "
          f"another params object ValueError", flush=True)


def _lm_graph_parity(dev):
    from repro_torch.configs import deepseek_v2_236b as DS
    from repro_torch.configs import recurrentgemma_9b as RG
    from repro_torch.engine import SOIEngine
    from repro_torch.models import transformer as T
    gen = torch.Generator().manual_seed(21)

    def draw(cfg, lens, shared=0):
        out = [torch.randint(0, cfg.vocab, (n,), generator=gen,
                             dtype=torch.int32) for n in lens]
        for p in out[1:]:
            p[:shared] = out[0][:shared]
        return out

    # qwen3 at 4 layers, f32: dense pp and fp (prompts in one SOI phase
    # class, the late one too, so steps alternate between the branches),
    # then paged + chunked + prefix cache: prompts sharing 128 tokens, 60
    # steps, so the rings wrap onto shared pages and COW flushes run
    # between replays
    for mode in ("pp", "fp"):
        cfg = _parity_cfg(mode)
        params = T.init(cfg, generator=torch.Generator(device=dev)
                        .manual_seed(22), device=dev)
        prompts = draw(cfg, (200, 202, 203))
        st = cfg.soi.stride
        label = f"qwen3 4 layers f32 {mode} dense"
        eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=256,
                        device=dev)
        ds = _graph_parity(label, eng, params, prompts, 2 * st + 5, 3, dev)
        _refusals(label, eng, params, ds)
        if mode == "pp":
            prompts = draw(cfg, (200, 202, 203), shared=128)
            eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=256,
                            device=dev, paged=True, page_size=16,
                            prefill_chunk=64, prefix_cache=True)
            _graph_parity("qwen3 4 layers f32 pp paged, chunk 64, prefix "
                          "cache", eng, params, prompts, 60, 3, dev)
            pc = eng.prefix_cache_stats
            check(pc["hits"] == 2 and pc["cow_copies"] > 0
                  and eng.cow_flushes > 0,
                  f"expected hits and COW flushes: {pc}, "
                  f"{eng.cow_flushes} flushes")
        del params
    _free(dev)
    # deepseek-v2 at 2 layers (dense layer 0, one MoE middle), bf16, paged
    cfg = DS.config(soi="pp", n_layers=2)
    params = T.cast_params(T.init(cfg, generator=torch.Generator(device=dev)
                                  .manual_seed(23), device=dev,
                                  dtype=torch.bfloat16), cfg)
    label = "deepseek-v2 2 layers bf16 pp paged"
    eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=64, device=dev,
                    paged=True, page_size=16)
    ds = _graph_parity(label, eng, params, draw(cfg, (41, 43, 44)),
                       2 * cfg.soi.stride + 5, 3, dev)
    _refusals(label, eng, params, ds)
    del params
    _free(dev)
    # recurrentgemma-9b at 12 layers, bf16, dense and paged
    cfg = RG.config(soi="pp", n_layers=12)
    params = T.cast_params(T.init(cfg, generator=torch.Generator(device=dev)
                                  .manual_seed(24), device=dev,
                                  dtype=torch.bfloat16), cfg)
    prompts = draw(cfg, (41, 43, 44))
    for layout, kw in (("dense", {}),
                       ("paged", dict(paged=True, page_size=16))):
        label = f"recurrentgemma-9b 12 layers bf16 pp {layout}"
        eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=64,
                        device=dev, **kw)
        ds = _graph_parity(label, eng, params, prompts,
                           2 * cfg.soi.stride + 5, 3, dev)
        _refusals(label, eng, params, ds)
    del params
    _free(dev)


def _unet_graph_parity(model, dev):
    """The graphed session against the eager steppers at B 1 and B 32 for
    phase 13's configs: every frame and the final stream state bit for
    bit, ``stmc_conv`` launches from the replays equal to the plans'."""
    from repro_torch.engine.session import unet_stream_session
    from repro_torch.kernels import ops
    from repro_torch.models import unet as U
    gen = torch.Generator(device=dev).manual_seed(25)
    for b in (1, 32):
        for label, kw, _n in STREAM_SOIS:
            cfg = _unet_cfg(kw)
            n = 3 * cfg.period + 2
            x = torch.randn((b, n, 128), generator=gen, device=dev)
            sess = unet_stream_session(model, cfg, batch=b, device=dev)
            ops.reset_launch_counts()
            ys = [sess.push(x[:, t]) for t in range(n)]
            torch.cuda.synchronize(dev)
            counts = ops.launch_counts()
            _held_launches(counts, _planned_convs(cfg, n),
                           f"graphed {label} B {b}")
            steppers = U.make_phase_steppers(cfg)
            state = U.init_stream_state(b, cfg, device=dev)
            for t in range(n):
                state, y = steppers[t % cfg.period](model, state, x[:, t])
                check(torch.equal(ys[t], y),
                      f"graphed {label} B {b} frame {t}: differs from the "
                      f"eager stepper's")
            n_leaves, _ = _state_equal(sess.state["inner"], state,
                                       f"graphed {label} B {b}")
            g = sess.graph
            check(g.captures == cfg.period and g.replays == n - cfg.period,
                  f"{label} B {b}: {g.captures} captures, {g.replays} "
                  f"replays")
            st = g.stats().values()
            print(f"  U-Net B {b} {label}: {n} frames graphed == eager bit "
                  f"for bit ({n_leaves} state leaves), stmc_conv "
                  f"{counts['stmc_conv']} launches (planned); "
                  f"{g.captures} captures "
                  f"({sum(v['capture_s'] for v in st) * 1e3:.1f} ms, pool "
                  f"{sum(v['pool_bytes'] for v in st) / 2 ** 20:.1f} MiB)",
                  flush=True)


def _loop_profile(step, n: int, kernel, launches: str, label: str):
    """Device busy ms a step, idle share and device kernels a step of
    ``n`` calls of ``step`` under the profiler (device clock: first
    kernel's start to last kernel's end), and the events of ``kernel`` (a
    name or a tuple of names) on the device, held to the ``launches``
    counter's count: every counted launch ran, graph node or not. One step
    runs first, then a marker kernel (``torch.cuda._sleep``): the profiler
    can miss the start of the first graph replay after it starts, so only
    the events after the marker are read. A profile that still lost
    events is taken again; a second one that disagrees raises."""
    from repro_torch.kernels import ops

    def run():
        step()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        ops.reset_launch_counts()
        for _ in range(n):
            step()
    for _ in range(2):
        ev = _device_events(run)
        marks = [e for _s, e, name in ev if "spin_kernel" in name]
        check(marks, f"{label}: the profiler saw no marker kernel")
        ev = [x for x in ev if x[0] >= marks[-1]]
        check(ev, f"{label}: the profiler saw no device activity")
        seen = sum(1 for _s, _e, name in ev if _named(name, kernel))
        counted = ops.launch_counts()[launches]
        if seen == counted:
            break
    check(seen == counted, f"{label}: {seen} {kernel} kernels on the device "
                           f"in two profiles, {counted} {launches} counted")
    window = max(e for _s, e, _n in ev) - min(s_ for s_, _e, _n in ev)
    busy = _busy_us([(s_, e) for s_, e, _n in ev])
    return busy / 1e3 / n, 1 - busy / window, len(ev) / n, seen


def _enqueue_ms(step, n: int) -> float:
    """Host ms a call of ``n`` calls of ``step`` enqueued back to back
    after a synchronize, the synchronize that drains them left out: the
    host's own cost a step while the card has work queued."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / n


def _lm_graph_timing(dev):
    """Full-width qwen3-1.7b at phase 5's traffic: the graphed engine and
    its eager twin from one state, steps interleaved (host clock after a
    synchronize), then a profiled window of each."""
    from repro_torch.launch import serve
    args = serve.parse_args(SERVE_ARGV + ["--gen-len", "192"])
    cfg, params, prompt, plens, engine = serve.setup(args)
    ds = engine.init_decode_state(params)
    for slot, n in enumerate(plens):
        ds = engine.insert(engine.prefill(params, prompt[slot, :n]), ds, slot)
    twin, tds = _eager_twin(engine, ds)
    torch.cuda.synchronize(dev)
    times = {"graphed": {True: [], False: []},
             "eager": {True: [], False: []}}
    n_steps = 64
    for _ in range(n_steps):
        for mode, eng in (("graphed", engine), ("eager", twin)):
            mid0 = eng.mid_steps
            t0 = time.perf_counter()
            if mode == "graphed":
                ds, res = engine.generate(params, ds)
            else:
                tds, res = twin.generate(params, tds)
            res.convert_to_numpy()
            torch.cuda.synchronize(dev)
            times[mode][eng.mid_steps > mid0].append(
                (time.perf_counter() - t0) * 1e3)
    check(engine.graph.captures == 2, f"{engine.graph.captures} captures")
    out = {}
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    for mode, eng in (("graphed", engine), ("eager", twin)):
        allt = sorted(times[mode][True] + times[mode][False])
        on, off = sorted(times[mode][True]), sorted(times[mode][False])
        st = {"ds": ds if mode == "graphed" else tds, "prev": None}

        def step():
            st["ds"], res = eng.generate(params, st["ds"])
            if st["prev"] is not None:
                st["prev"].convert_to_numpy()
            st["prev"] = res
        n_prof = 16
        busy, idle, kern, reads = _loop_profile(
            step, n_prof, READ_KERNELS["split"], "decode_attention", mode)

        def enqueue():
            st["ds"], _res = eng.generate(params, st["ds"])
        host = _enqueue_ms(enqueue, n_prof)
        if mode == "graphed":
            ds = st["ds"]
        out[mode] = {"median_ms": allt[len(allt) // 2],
                     "mid_ms": on[len(on) // 2], "off_ms": off[len(off) // 2],
                     "busy_ms": busy, "idle": idle, "kernels": kern,
                     "host_ms": host}
        print(f"  qwen3-1.7b {mode}: median step {out[mode]['median_ms']:.3f}"
              f" ms ({out[mode]['mid_ms']:.3f} with the SOI middle, "
              f"{out[mode]['off_ms']:.3f} without; {n_steps} steps, host "
              f"clock after a synchronize); profiled {n_prof} steps: busy "
              f"{busy:.3f} ms a step, idle share {idle:.3f}, {kern:.0f} "
              f"device kernels a step, decode reads {reads} on the device "
              f"== counted; host {host:.3f} ms a step (enqueued "
              f"back to back, no drain)", flush=True)
    g = out["graphed"]
    e = out["eager"]
    stats = engine.graph.stats()
    print(f"  qwen3-1.7b graphed / eager: median step "
          f"{g['median_ms'] / e['median_ms']:.3f}, busy "
          f"{g['busy_ms'] / e['busy_ms']:.3f}; step ratio with / without "
          f"the middle {g['mid_ms'] / g['off_ms']:.3f} graphed, "
          f"{e['mid_ms'] / e['off_ms']:.3f} eager")
    for (mid,), v in stats.items():
        print(f"  qwen3-1.7b graph {'middle' if mid else 'no middle'}: "
              f"capture {v['capture_s'] * 1e3:.1f} ms, pool "
              f"{v['pool_bytes'] / 2 ** 20:.1f} MiB, copy-back "
              f"{v['copy_back_bytes']} B a replay, launches a replay "
              f"{v['launches']} (expected decode_attention "
              f"{n_outer + (n_mid if mid else 0)})")
        check(v["launches"].get("decode_attention")
              == n_outer + (n_mid if mid else 0),
              f"graph launches {v['launches']}")
    del params, engine, twin, ds, tds
    _free(dev)
    return out


def _unet_graph_timing(model, dev):
    """soi-unet-dns at B 1 and B 32, STMC baseline and PP S-CC (3,): the
    graphed session and the eager steppers from one stream, frames
    interleaved (host clock after a synchronize), then a profiled window
    of each."""
    from repro_torch.engine.session import unet_stream_session
    from repro_torch.models import unet as U
    gen = torch.Generator(device=dev).manual_seed(26)
    n = 192
    out = {}
    for b in (1, 32):
        x = torch.randn((b, n, 128), generator=gen, device=dev)
        base = {}
        for label, kw, _n in STREAM_SOIS[:2]:
            cfg = _unet_cfg(kw)
            sess = unet_stream_session(model, cfg, batch=b, device=dev)
            for t in range(2 * cfg.period):
                sess.push(x[:, t])           # every phase captured
            steppers = U.make_phase_steppers(cfg)
            state = U.init_stream_state(b, cfg, device=dev)
            times = {"graphed": [[] for _ in range(cfg.period)],
                     "eager": [[] for _ in range(cfg.period)]}
            torch.cuda.synchronize(dev)
            for t in range(n):
                ph = t % cfg.period
                t0 = time.perf_counter()
                sess.push(x[:, t])
                torch.cuda.synchronize(dev)
                times["graphed"][ph].append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                state, _y = steppers[ph](model, state, x[:, t])
                torch.cuda.synchronize(dev)
                times["eager"][ph].append((time.perf_counter() - t0) * 1e3)
            retain = U.complexity_report(cfg).retain
            for mode in ("graphed", "eager"):
                med = [sorted(v)[len(v) // 2] for v in times[mode]]
                mean = sum(map(sum, times[mode])) / n
                base.setdefault(mode, mean)
                run = {"t": 0, "state": state}

                def step():
                    t = run["t"]
                    if mode == "graphed":
                        sess.push(x[:, t % n])
                    else:
                        run["state"], _ = steppers[t % cfg.period](
                            model, run["state"], x[:, t % n])
                    run["t"] = t + 1
                busy, idle, kern, _ = _loop_profile(
                    step, 64, "stmc_conv_kernel", "stmc_conv",
                    f"{mode} {label} B {b}")
                host = _enqueue_ms(step, 64)
                out[(b, label, mode)] = {"median_ms": med, "mean_ms": mean,
                                         "busy_ms": busy, "idle": idle,
                                         "host_ms": host}
                print(f"  U-Net B {b} {label} {mode}: median step per phase "
                      f"{', '.join(f'{m:.3f}' for m in med)} ms, mean "
                      f"{mean:.3f} ms, {FRAME_MS / mean:.1f}x real time, "
                      f"step ratio to the baseline {mean / base[mode]:.3f} "
                      f"(MAC retain {retain:.3f}); profiled 64 frames: busy "
                      f"{busy:.3f} ms a frame, idle share {idle:.3f}, "
                      f"{kern:.1f} device kernels a frame; host {host:.3f} ms "
                      f"a frame enqueued back to back ({n} frames, host "
                      f"clock after a synchronize)", flush=True)
    return out


def graphs_phase(dev):
    phase("14 graphs (the captured step graphs against the eager steps: "
          "qwen3, deepseek-v2, recurrentgemma, the U-Net; timing)")
    from repro_torch.models import unet as U
    _lm_graph_parity(dev)
    model = U.init(_unet_cfg(None), generator=torch.Generator(device=dev)
                   .manual_seed(9), device=dev)
    _unet_graph_parity(model, dev)
    lm = _lm_graph_timing(dev)
    _unet_graph_timing(model, dev)
    del model
    _free(dev)
    # the graphed qwen3 step's device kernels, which phase 16 holds
    return lm["graphed"]["kernels"]


# ---------------------------------------------------------------------------
# 15. self-speculative windows
# ---------------------------------------------------------------------------

SPEC_K = 4


def _spec_start(cfg, model, prompts, where, paged):
    """A speculative engine on ``where`` with ``prompts`` inserted and, on
    pools, the K positions of a window backed: ``(engine, state, first
    tokens)``."""
    from repro_torch.engine import SOIEngine
    kw = (dict(paged=True, page_size=16, prefill_chunk=64, prefix_cache=True)
          if paged else {})
    eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=256, device=where,
                    speculate=SPEC_K, **kw)
    ds = eng.init_decode_state(model)
    for slot, p in enumerate(prompts):
        ds = eng.insert(eng.prefill(model, p.to(where)), ds, slot)
    if paged:
        ds = eng._back_spec_window(ds)
        eng._flush_cow(ds)
        eng._refresh_page_maps(ds["model"])
    return eng, ds["model"], ds["tokens"].clone()


def _spec_parity(dev):
    """(a) qwen3 at 4 layers, f32, dense and paged with the prefix cache:
    a rejection forced at every depth n through ``verify_commit`` on the
    card and on the CPU from the same inputs (the card's greedy
    continuation, its guess at n corrupted) — committed tokens equal,
    logits within 1e-3, and the card's state bit for bit that of n
    sequential card steps (pools: outside the null page)."""
    from repro_torch.engine.speculative import verify_commit
    from repro_torch.engine.step import generate_step
    from repro_torch.models import transformer as T
    cfg = _parity_cfg("pp")
    cpu_model = T.init(cfg, generator=torch.Generator().manual_seed(31),
                       device="cpu")
    dev_model = copy.deepcopy(cpu_model).to(dev)
    gen = torch.Generator().manual_seed(32)
    shared = torch.randint(0, cfg.vocab, (128,), generator=gen,
                           dtype=torch.int32)
    for paged in (False, True):
        prompts = [torch.cat([shared, torch.randint(
            0, cfg.vocab, (n - 128,), generator=gen, dtype=torch.int32)])
            for n in (200, 201, 199)]
        label = "paged, prefix cache" if paged else "dense"
        t0 = time.perf_counter()
        _e, st0, cur = _spec_start(cfg, dev_model, prompts, dev, paged)
        _c, cst0, ccur = _spec_start(cfg, cpu_model, prompts,
                                     torch.device("cpu"), paged)
        check(torch.equal(cur.cpu(), ccur), f"spec parity {label}: first "
                                            f"tokens differ card vs CPU")
        ones = torch.ones(3, dtype=torch.bool, device=dev)
        seq, snaps, st, c = [cur], [], copy.deepcopy(st0), cur
        for _ in range(SPEC_K):
            lg, st = generate_step(dev_model, cfg, st, c, active=ones)
            c = torch.argmax(lg, -1).to(torch.int32)
            seq.append(c)
            snaps.append(copy.deepcopy(st))
        seq = torch.stack(seq, 1)
        worst, null_diff = 0.0, 0
        for n in range(1, SPEC_K + 1):
            inputs = seq[:, :SPEC_K].clone()
            if n < SPEC_K:
                inputs[:, n] = (inputs[:, n] + 1) % cfg.vocab
            sv, csv = copy.deepcopy(st0), copy.deepcopy(cst0)
            _, comm, n_acc, nxt, lg = verify_commit(
                dev_model, cfg, sv, inputs, active=ones, spec=ones)
            cones = ones.cpu()
            _, ccomm, cn, cnxt, clg = verify_commit(
                cpu_model, cfg, csv, inputs.cpu(), active=cones, spec=cones)
            check(n_acc.tolist() == cn.tolist() == [n] * 3,
                  f"spec parity {label} n={n}: accepted {n_acc.tolist()} "
                  f"on the card, {cn.tolist()} on the CPU")
            check(torch.equal(comm.cpu(), ccomm)
                  and torch.equal(comm[:, :n], seq[:, 1:1 + n])
                  and torch.equal(nxt.cpu(), cnxt),
                  f"spec parity {label} n={n}: committed tokens differ "
                  f"(card {comm.tolist()}, cpu {ccomm.tolist()})")
            err = float((lg.cpu() - clg).abs().max())
            check(err < 1e-3, f"spec parity {label} n={n}: logits differ "
                              f"by {err} >= 1e-3")
            worst = max(worst, err)
            _n, nd = _state_equal({"model": sv}, {"model": snaps[n - 1]},
                                  f"spec parity {label} n={n}", paged=paged)
            null_diff += nd
        print(f"  spec parity qwen3 4 layers f32 {label}: rejection forced "
              f"at n = 1..{SPEC_K} — committed tokens equal card vs CPU, "
              f"max|Δlogit| {worst:.3e}, the card's state == {SPEC_K} x n "
              f"sequential card steps bit for bit"
              f"{f' (null pages: {null_diff} elements differ)' if paged else ''}"
              f" in {time.perf_counter() - t0:.2f} s", flush=True)
        del st0, cst0, snaps, st
    del cpu_model, dev_model
    _free(dev)


def _first_diff(got, want) -> str:
    """The first (slot, step) where two token arrays differ."""
    import numpy as np
    if got.shape != want.shape:
        return f"shapes {got.shape} and {want.shape}"
    slot, step = (int(x[0]) for x in np.nonzero(got != want))
    return (f"slot {slot}, step {step}: {int(got[slot, step])} against "
            f"{int(want[slot, step])}")


def _spec_serve(label, argv, plain_seqs, dev):
    """(b) one full-width speculative serve through ``launch/serve.py``'s
    own ``setup`` and ``serve``: tokens equal to the plain run's, the decode
    reads launched as the windows' branch patterns give them, copy_pages
    once a COW flush. Returns the launch counts."""
    from repro_torch.engine.speculative import draft_rows
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve.parse_args(argv)
    cfg, params, prompt, plens, engine = serve.setup(args)
    ops.reset_launch_counts()
    res = serve.serve(engine, params, prompt, plens, args.gen_len,
                      mixed_spec=args.mixed_spec)
    torch.cuda.synchronize(dev)
    counts = ops.launch_counts()
    if res.seqs.shape != plain_seqs.shape or (res.seqs != plain_seqs).any():
        raise RuntimeError(f"spec {label}: tokens differ from the plain "
                           f"run's at {_first_diff(res.seqs, plain_seqs)}")
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    sp = res.spec
    read = "paged_decode_attention" if args.paged else "decode_attention"
    want = (sp["windows"] * (2 * SPEC_K - 1) * n_outer
            + n_mid * engine.spec_mid_iters)
    g = engine.spec_graph
    pool = sum(v["pool_bytes"] for v in g.stats().values())
    rows = draft_rows(cfg, engine._live["model"], SPEC_K)
    gathered = sum(v.nbytes for _l, ix, v in rows if ix is not None)
    whole = sum(v.nbytes for _l, ix, v in rows if ix is None)
    print(f"  spec {label}: tokens identical to the plain run; {sp['windows']}"
          f" windows, {sp['committed']} tokens committed "
          f"({sp['tokens_per_window']:.3f} a slot-window), accept rate "
          f"{sp['accept_rate']:.4f} ({sp['draft_accepted']}/"
          f"{sp['draft_candidates']}); decode {res.decoded} tokens in "
          f"{res.decode_s:.3f} s = {res.decoded / res.decode_s:.1f} tok/s "
          f"(host clock, the serve loop); {g.captures} captures for "
          f"{len(engine.spec_keys)} window keys {sorted(engine.spec_keys)}, "
          f"pool {pool / 2 ** 20:.1f} MiB; the draft gathers "
          f"{gathered / 2 ** 10:.1f} KiB of ring rows + {whole / 2 ** 10:.1f}"
          f" KiB of whole leaves a window", flush=True)
    print(f"  spec {label}: launches {counts}; expected {read} {want} "
          f"({sp['windows']} windows x {2 * SPEC_K - 1} x {n_outer} outer + "
          f"{engine.spec_mid_iters} verify steps with the middle x {n_mid})"
          f"{f', copy_pages {res.cow_flushes} (COW flushes)' if args.paged else ''}")
    check(g.captures == len(engine.spec_keys) > 0,
          f"spec {label}: {g.captures} captures, {len(engine.spec_keys)} "
          f"window keys")
    check(counts[read] == want, f"spec {label}: {read} launches "
                                f"{counts[read]} != {want}")
    for (key,), st in g.stats().items():
        k, pattern = key
        per = (2 * k - 1) * n_outer + n_mid * sum(pattern)
        check(st["launches"].get(read) == per,
              f"spec {label}: window {key} launches {st['launches']}, "
              f"expected {read} {per}")
    if args.paged:
        check(counts["copy_pages"] == res.cow_flushes,
              f"spec {label}: copy_pages launches {counts['copy_pages']} != "
              f"COW flushes {res.cow_flushes}")
    del params, engine
    _free(dev)
    return counts


def _spec_timing(dev):
    """Full-width qwen3-1.7b at phase 5's traffic (192 tokens of room):
    speculative windows and plain graphed steps from the same prompts and
    weights, one of each in turn (host clock after a synchronize), then a
    profiled stretch of windows."""
    from repro_torch.engine import SOIEngine
    from repro_torch.launch import serve
    args = serve.parse_args(SERVE_ARGV + ["--gen-len", "192", "--speculate",
                                          str(SPEC_K)])
    cfg, params, prompt, plens, spec = serve.setup(args)
    plain = SOIEngine(cfg, max_concurrent_decodes=args.batch,
                      max_len=spec.max_len, device=dev)
    states = {}
    for name, eng in (("spec", spec), ("plain", plain)):
        ds = eng.init_decode_state(params)
        for slot, n in enumerate(plens):
            ds = eng.insert(eng.prefill(params, prompt[slot, :n]), ds, slot)
        states[name] = ds
    torch.cuda.synchronize(dev)
    times = {"spec": [], "plain": []}
    toks = 0
    n_iter = 24
    for _ in range(n_iter):
        for name, eng in (("spec", spec), ("plain", plain)):
            t0 = time.perf_counter()
            states[name], res = eng.generate(params, states[name])
            res = res.convert_to_numpy()
            torch.cuda.synchronize(dev)
            times[name].append((time.perf_counter() - t0) * 1e3)
            if name == "spec":
                toks += int(res.data[:, SPEC_K + 2].sum())
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    rate = {"spec": toks / (sum(times["spec"]) / 1e3),
            "plain": 4 * n_iter / (sum(times["plain"]) / 1e3)}
    st = {"ds": states["spec"]}

    def window():
        st["ds"], _res = spec.generate(params, st["ds"])
    n_prof = 4
    busy, idle, kern, reads = _loop_profile(
        window, n_prof, READ_KERNELS["split"], "decode_attention",
        "spec windows")
    print(f"  spec timing qwen3-1.7b, B 4, K {SPEC_K}: median window "
          f"{med['spec']:.3f} ms against the plain graphed step "
          f"{med['plain']:.3f} ms ({n_iter} each, in turn, host clock after "
          f"a synchronize); {toks / n_iter:.2f} tokens a window; "
          f"{rate['spec']:.1f} tok/s against {rate['plain']:.1f} plain "
          f"(ratio {rate['spec'] / rate['plain']:.3f}); profiled {n_prof} "
          f"windows: busy {busy:.3f} ms a window, idle share {idle:.3f}, "
          f"{kern:.0f} device kernels a window, decode reads {reads} on the "
          f"device == counted", flush=True)
    for (key,), v in spec.spec_graph.stats().items():
        print(f"  spec graph {key}: capture {v['capture_s'] * 1e3:.1f} ms, "
              f"pool {v['pool_bytes'] / 2 ** 20:.1f} MiB, copy-back "
              f"{v['copy_back_bytes']} B a replay, launches {v['launches']}")
    del params, spec, plain, states, st
    _free(dev)
    return med, rate


def spec_phase(dev, plain_seqs) -> dict:
    phase("15 spec (self-speculative windows: forced rejection card vs "
          "CPU; qwen3-1.7b full width --speculate 4, dense, then paged "
          "with the prefix cache and --mixed-spec)")
    _spec_parity(dev)
    k = ["--speculate", str(SPEC_K)]
    counts = {
        "dense": _spec_serve("dense", SERVE_ARGV + k, plain_seqs["dense"],
                             dev),
        "paged": _spec_serve("paged --mixed-spec",
                             PAGED_ARGV + ["--prefix-cache", "--mixed-spec"]
                             + k, plain_seqs["paged"], dev)}
    _spec_timing(dev)
    return counts


# ---------------------------------------------------------------------------
# 16. obs: the telemetry vector in the captured step, run_load, spans
# ---------------------------------------------------------------------------

# the vector's kernels a step (step_metrics: six; its buffer rides the
# result rows' copy)
MAX_VECTOR_KERNELS = 8
# the reference's telemetry budget (tests/test_obs.py): the least on/off
# ratio of interleaved trial pairs
TELEMETRY_BUDGET = 1.05
LOAD_TRACE = dict(n_tenants=4, zipf_a=1.1, prefix_len=768,
                  suffix_lens=(16, 256), gen_lens=(16, 64), burst_rate_hz=4.0,
                  burst_mean=2.0, seed=0)


def _host_vector(engine) -> list:
    """The telemetry vector of the engine's host clocks and occupancy."""
    import numpy as np
    st = engine.cfg.soi.stride
    occ = engine._occupied
    hist = np.bincount(engine._clock[occ] % st, minlength=st)
    return hist.tolist() + [int(hist[0] > 0), int(occ.sum())]


def _telemetry_on_off(dev, graph_kernels):
    """(a) phase 5's traffic through a dense engine with telemetry and one
    without, one process, the same weights: 64 steps of each (tokens,
    drained vectors against the host's clocks and branch, drains a step,
    launches), device kernels a step of each from a profiled window, then
    12 interleaved trial pairs of 8 drained steps (the reference's budget
    method). Returns the telemetry engine's launch counts."""
    from repro_torch.engine import SOIEngine, contracts
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.obs import EngineTelemetry, now
    args = serve.parse_args(SERVE_ARGV + ["--gen-len", "192"])
    cfg, params, prompt, plens, _eng = serve.setup(args)
    del _eng
    st = cfg.soi.stride
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    n_steps = 64
    runs = {}
    for tele in (False, True):
        eng = SOIEngine(cfg, max_concurrent_decodes=args.batch,
                        max_len=args.prompt_len + args.gen_len, device=dev,
                        telemetry=tele)
        ops.reset_launch_counts()
        ds = eng.init_decode_state(params)
        for slot, n in enumerate(plens):
            ds = eng.insert(eng.prefill(params, prompt[slot, :n]), ds, slot)
        toks = []
        d0, s0, m0 = contracts.drain_count(), eng.steps, eng.mid_steps
        for i in range(n_steps):
            want = _host_vector(eng)
            mid0 = eng.mid_steps
            ds, res = eng.generate(params, ds)
            res = res.convert_to_numpy()
            toks.append(res.data[:, 0].copy())
            if tele:
                check(res.metrics.tolist() == want,
                      f"obs (a) step {i}: drained vector "
                      f"{res.metrics.tolist()} != the host's {want}")
                check(int(res.metrics[st]) == eng.mid_steps - mid0,
                      f"obs (a) step {i}: mid_fired {int(res.metrics[st])} "
                      f"against the host's branch {eng.mid_steps - mid0}")
            else:
                check(res.metrics is None, "obs (a): telemetry off gave a "
                                           "metrics vector")
        torch.cuda.synchronize(dev)
        counts = ops.launch_counts()
        drains = contracts.drain_count() - d0
        steps, mids = eng.steps - s0, eng.mid_steps - m0
        check(drains == n_steps, f"obs (a) telemetry {tele}: {drains} "
                                 f"drains in {n_steps} steps")
        want_dec = n_outer * steps + n_mid * mids
        check(counts["decode_attention"] == want_dec
              and counts["flash_attention"] == cfg.n_layers * len(plens),
              f"obs (a) telemetry {tele}: launches {counts}, expected "
              f"decode_attention {want_dec}")
        check(eng.graph.captures == 2, f"obs (a) telemetry {tele}: "
                                       f"{eng.graph.captures} captures")
        runs[tele] = {"eng": eng, "ds": ds, "toks": toks, "counts": counts,
                      "graph": {k: v["launches"]
                                for k, v in eng.graph.stats().items()}}
    off, on = runs[False], runs[True]
    check(all((a == b).all() for a, b in zip(on["toks"], off["toks"])),
          "obs (a): tokens with telemetry differ from tokens without")
    check(on["graph"] == off["graph"], f"obs (a): launches a replay "
                                       f"{on['graph']} != {off['graph']}")
    print(f"  (a) qwen3-1.7b dense B 4, {n_steps} steps each: tokens equal "
          f"with and without telemetry; every drained vector == the host "
          f"clocks' (mid_fired == the host's branch); one drain a step "
          f"either way; 2 captures each, the same launches a replay "
          f"{on['graph']}; launches on {on['counts']}", flush=True)
    kern = {}
    for tele, run in runs.items():
        r = {"ds": run["ds"], "prev": None}
        eng = run["eng"]

        def step():
            r["ds"], res = eng.generate(params, r["ds"])
            if r["prev"] is not None:
                r["prev"].convert_to_numpy()
            r["prev"] = res
        busy, idle, kern[tele], _seen = _loop_profile(
            step, 16, READ_KERNELS["split"], "decode_attention",
            f"obs telemetry {tele}")
        run["ds"] = r["ds"]
        print(f"  (a) telemetry {'on' if tele else 'off'}: profiled 16 "
              f"steps: {kern[tele]:.2f} device kernels a step, busy "
              f"{busy:.3f} ms a step, idle share {idle:.3f}", flush=True)
    extra = kern[True] - kern[False]
    print(f"  (a) device kernels a step: off {kern[False]:.2f} (phase 14: "
          f"{graph_kernels:.2f}; PERF.md records 2229), on "
          f"{kern[True]:.2f}: +{extra:.2f} for the vector (at most "
          f"{MAX_VECTOR_KERNELS})")
    check(round(kern[False]) == round(graph_kernels),
          f"obs (a): telemetry-off step {kern[False]} kernels, phase 14 "
          f"{graph_kernels}")
    check(0 < extra <= MAX_VECTOR_KERNELS,
          f"obs (a): the vector adds {extra} kernels a step")

    tel = EngineTelemetry(st)

    def trial(run, telemetry):
        eng, ds, pending = run["eng"], run["ds"], None
        t0 = now()
        for _ in range(8):
            ds, res = eng.generate(params, ds)
            if pending is not None:
                r = pending.convert_to_numpy()
                if telemetry is not None:
                    telemetry.observe_result(r)
            pending = res
        r = pending.convert_to_numpy()
        if telemetry is not None:
            telemetry.observe_result(r)
        run["ds"] = ds
        return (now() - t0) * 1e3 / 8
    import gc
    times = {True: [], False: []}
    ratios = []
    gc.collect()
    gc.disable()
    try:
        for _ in range(12):
            t_off = trial(off, None)
            t_on = trial(on, tel)
            times[False].append(t_off)
            times[True].append(t_on)
            ratios.append(t_on / t_off)
    finally:
        gc.enable()
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(f"  (a) median step {med[True]:.3f} ms with telemetry, "
          f"{med[False]:.3f} without (12 interleaved pairs of 8 drained "
          f"steps, host clock to the last drain); on/off per pair "
          f"{' '.join(f'{x:.3f}' for x in ratios)}; least "
          f"{min(ratios):.3f} (budget {TELEMETRY_BUDGET})", flush=True)
    check(min(ratios) <= TELEMETRY_BUDGET,
          f"obs (a): telemetry costs more than {TELEMETRY_BUDGET - 1:.0%} "
          f"in every pair: {ratios}")
    counts = on["counts"]
    del runs, off, on, params
    _free(dev)
    return counts


def _run_load(dev):
    """(b) run_load's multi-tenant trace through a paged prefix-cache
    engine with telemetry, first-come then phase-aligned: every request
    completes, the cache hits, the chunk, paged decode and copy kernels
    launch as the engine's counters and the spans give them; TTFT, TPOT,
    queue wait, occupancy and coherence; the trace and metrics files
    written and read back. Returns the launch counts of both runs."""
    import os
    import tempfile
    from repro_torch import configs
    from repro_torch.engine import SOIEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.obs import make_trace, run_load, write_metrics, \
        write_trace
    cfg = configs.get("qwen3-1.7b", soi="pp")
    params = T.cast_params(T.init(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev, dtype=T._dtype(cfg)), cfg)
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    chunk = 256
    eng = SOIEngine(cfg, max_concurrent_decodes=4, max_len=1152, device=dev,
                    paged=True, page_size=16, prefill_chunk=chunk,
                    prefix_cache=True, telemetry=True)
    reqs = make_trace(24, cfg.vocab, **LOAD_TRACE)
    total = {}
    for align in (False, True):
        label = "phase-aligned" if align else "first-come"
        s0, m0, f0 = eng.steps, eng.mid_steps, eng.cow_flushes
        ops.reset_launch_counts()
        res = run_load(eng, params, reqs, phase_align=align)
        torch.cuda.synchronize(dev)
        counts = ops.launch_counts()
        s = res.summary
        steps, mids = eng.steps - s0, eng.mid_steps - m0
        chunks = sum(-(-len(r.tokens) // chunk)
                     - res.tracer.get(r.rid).tokens_skipped // chunk
                     for r in reqs)
        want = {"chunk_attention": (n_outer + n_mid) * chunks,
                "paged_decode_attention": n_outer * steps + n_mid * mids,
                "copy_pages": eng.cow_flushes - f0,
                "decode_attention": 0, "flash_attention": 0}
        print(f"  (b) run_load {label}: {s['completed']}/{len(reqs)} "
              f"completed in {s['steps']} steps ({mids} with the middle); "
              f"TTFT p50 {s['ttft_p50_s'] * 1e3:.1f} / p99 "
              f"{s['ttft_p99_s'] * 1e3:.1f} ms, TPOT p50 "
              f"{s['tpot_p50_s'] * 1e3:.3f} / p99 {s['tpot_p99_s'] * 1e3:.3f}"
              f" ms, queue wait p50 {s['queue_wait_p50_s'] * 1e3:.1f} / p99 "
              f"{s['queue_wait_p99_s'] * 1e3:.1f} ms; {s['tok_s']:.1f} tok/s"
              f" over {s['elapsed_s']:.3f} s; hit rate {s['hit_rate']:.3f}, "
              f"{s['tokens_skipped']} prompt tokens skipped, deferred "
              f"{s['deferred_admissions']}, phase-deferred "
              f"{s['phase_deferred']} (host clock, virtual across idle gaps)",
              flush=True)
        # the prefill spans' host seconds (prefill calls, eager; the device
        # tail lands in the first token's read right after the insert)
        pre = sum(tr.prefill_end - tr.prefill_start
                  for tr in res.tracer.traces)
        print(f"  (b) {label}: prefill spans {pre:.3f} s of "
              f"{s['elapsed_s']:.3f} s ({pre / s['elapsed_s']:.3f}); decode "
              f"{s['decode_tokens']} tokens, "
              f"{s['elapsed_s'] / steps * 1e3:.3f} ms of the run a step",
              flush=True)
        occ = res.telemetry.off_phase_rate_by_occupancy()
        coh = res.telemetry.phase_coherence()
        print(f"  (b) {label}: off-phase rate by occupancy "
              f"{ {k: round(v, 4) for k, v in occ.items()} }; coherence "
              f"{coh['coherent_step_rate']:.4f} of active steps fully "
              f"aligned, modal fraction {coh['modal_fraction_mean']:.4f}; "
              f"launches {counts}, expected {want} ({chunks} chunks)",
              flush=True)
        check(s["completed"] == len(reqs), f"obs (b) {label}: "
              f"{s['completed']} of {len(reqs)} requests completed")
        check(s["hit_rate"] > 0, f"obs (b) {label}: no prefix-cache hit")
        for name, n in want.items():
            check(counts[name] == n, f"obs (b) {label}: {name} launches "
                                     f"{counts[name]} != {n}")
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
        with tempfile.TemporaryDirectory() as tmp:
            tpath = os.path.join(tmp, "trace.json")
            mpath = os.path.join(tmp, "metrics.json")
            write_trace(res.tracer, tpath)
            write_metrics(mpath, registry=res.telemetry.registry,
                          tracer=res.tracer, extra=s)
            with open(tpath) as fh:
                ev = json.load(fh)["traceEvents"]
            with open(mpath) as fh:
                met = json.load(fh)
            check(len({e["tid"] for e in ev}) == len(reqs)
                  and met["trace.completed"] == len(reqs)
                  and met["engine.steps"] == s["steps"],
                  f"obs (b) {label}: the trace or metrics file read back "
                  f"wrong")
            print(f"  (b) {label}: Chrome trace {os.path.getsize(tpath)} B "
                  f"({len(ev)} events, {len(reqs)} tracks), metrics JSON "
                  f"{os.path.getsize(mpath)} B ({len(met)} keys), read back",
                  flush=True)
    del eng, params
    _free(dev)
    return total


def _spec_telemetry(dev, plain_seqs):
    """(c) phase 15's dense traffic with --speculate 4 --trace-out
    --metrics-out through launch/serve.py: the plain run's tokens, one
    accepted-count sample a speculating slot a drained window, one
    telemetry step a drained window."""
    import os
    import tempfile
    from repro_torch.launch import serve
    with tempfile.TemporaryDirectory() as tmp:
        tpath = os.path.join(tmp, "trace.json")
        mpath = os.path.join(tmp, "metrics.json")
        args = serve.parse_args(SERVE_ARGV + [
            "--speculate", str(SPEC_K), "--trace-out", tpath,
            "--metrics-out", mpath])
        res = serve.run(args)
        with open(mpath) as fh:
            met = json.load(fh)
        with open(tpath) as fh:
            ev = json.load(fh)["traceEvents"]
    if (res.seqs.shape != plain_seqs.shape
            or (res.seqs != plain_seqs).any()):
        raise RuntimeError(f"obs (c): tokens differ from phase 5's at "
                           f"{_first_diff(res.seqs, plain_seqs)}")
    windows = res.spec["windows"]
    # the loop leaves the window dispatched last undrained once every
    # request is done (the reference's loop does the same)
    drained = met["engine.steps"]
    n_spec = len(res.seqs)
    acc = met["engine.spec_accepted_per_window.count"]
    print(f"  (c) --speculate {SPEC_K} --trace-out --metrics-out: tokens "
          f"equal to phase 5's; {windows} windows, {drained} drained "
          f"(engine.steps); engine.spec_accepted_per_window count {acc} "
          f"(mean {met['engine.spec_accepted_per_window.mean']:.3f}) for "
          f"{n_spec} speculating slots; mid_fired "
          f"{met['engine.mid_fired_steps']}, off-phase "
          f"{met['engine.off_phase_steps']}; TTFT p50 "
          f"{met['trace.ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
          f"{met['trace.tpot_p50_s'] * 1e3:.3f} ms; {len(ev)} trace events",
          flush=True)
    check(drained == windows - 1 and met["engine.spec.windows"] == windows,
          f"obs (c): engine.steps {drained} against {windows} windows")
    check(acc == drained * n_spec, f"obs (c): {acc} accepted-count samples "
                                   f"for {drained} windows x {n_spec} slots")
    _free(dev)


def _unet_registry(dev):
    """(d) the U-Net session with a registry: its pushes counted, its
    frames bit for bit those of the same session without one, the push
    dispatch latency. Returns the registry session's launch counts."""
    from repro_torch.engine.session import unet_stream_session
    from repro_torch.kernels import ops
    from repro_torch.models import unet as U
    from repro_torch.obs import MetricsRegistry
    cfg = _unet_cfg(STREAM_SOIS[0][1])
    model = U.init(cfg, generator=torch.Generator(device=dev).manual_seed(9),
                   device=dev)
    n = 192
    x = torch.randn((1, n, cfg.in_channels), generator=torch.Generator(
        device=dev).manual_seed(27), device=dev)
    plain = unet_stream_session(model, cfg, batch=1, device=dev)
    ys = [plain.push(x[:, t]) for t in range(n)]
    reg = MetricsRegistry()
    sess = unet_stream_session(model, cfg, batch=1, device=dev,
                               registry=reg)
    ops.reset_launch_counts()
    got = [sess.push(x[:, t]) for t in range(n)]
    torch.cuda.synchronize(dev)
    counts = ops.launch_counts()
    check(all(torch.equal(a, b) for a, b in zip(got, ys)),
          "obs (d): frames with a registry differ from frames without")
    d = reg.as_dict()
    want = _planned_convs(cfg, n)
    print(f"  (d) U-Net B 1 STMC baseline, {n} frames with a registry: "
          f"session.pushes {d['session.pushes']}, frames bit for bit those "
          f"without; push dispatch p50 "
          f"{d['session.push_dispatch_s.p50'] * 1e6:.1f} / p99 "
          f"{d['session.push_dispatch_s.p99'] * 1e6:.1f} us (host clock, "
          f"the first push captures); stmc_conv {counts['stmc_conv']} "
          f"launches (plan {want})", flush=True)
    check(d["session.pushes"] == n, f"obs (d): {d['session.pushes']} pushes")
    check(counts["stmc_conv"] == want, f"obs (d): stmc_conv launches "
                                       f"{counts['stmc_conv']} != {want}")
    del model, plain, sess
    _free(dev)
    return counts


def obs_phase(dev, plain_seqs, graph_kernels) -> dict:
    phase("16 obs (the telemetry vector in the captured step, on vs off; "
          "run_load's multi-tenant trace at full width; speculative "
          "windows with --trace-out/--metrics-out; the U-Net session's "
          "registry)")
    t0 = time.perf_counter()
    a = _telemetry_on_off(dev, graph_kernels)
    b = _run_load(dev)
    _spec_telemetry(dev, plain_seqs["dense"])
    d = _unet_registry(dev)
    print(f"  phase 16 in {time.perf_counter() - t0:.1f} s")
    return {"decode_attention": (a, "obs (a) dense, telemetry on"),
            "flash_attention": (a, "obs (a) dense, telemetry on"),
            "chunk_attention": (b, "obs (b) run_load, both runs"),
            "paged_decode_attention": (b, "obs (b) run_load, both runs"),
            "copy_pages": (b, "obs (b) run_load, both runs"),
            "stmc_conv": (d, "obs (d) U-Net session with a registry")}


def main():
    card = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    main_recs = kernels_phase(dev)
    cow_counts = parity_phase(dev)
    counts = serve_phase(dev)
    paged_counts = paged_serve_phase(dev)
    _free(dev)
    deepseek_parity_phase(dev)
    ds_counts = deepseek_serve_phase(dev)
    mla_cow_counts, mla_counts = mla_phase(dev)
    rg_parity_phase(dev)
    rg_counts = rg_serve_phase(dev)
    unet_parity_phase(dev)
    unet_counts = unet_stream_phase(dev)
    graph_kernels = graphs_phase(dev)
    spec_counts = spec_phase(dev, PLAIN_SEQS)
    obs_counts = obs_phase(dev, PLAIN_SEQS, graph_kernels)
    # launches: each kernel's count on its own path's run — the dense
    # serve (phase 5), the paged prefix-cache serve (phase 6), the
    # deepseek-v2 serve (phase 8), the MLA prefix-cache serve (phase 9),
    # the recurrentgemma serve (phase 11; paged run for lru_scan), and for
    # copy_pages the paged engine whose rings wrap (phase 4: the serve
    # command never wraps, max_len = prompt + generated), and the U-Net's
    # B 1 STMC-baseline stream of 512 frames (phase 13)
    launches = {"decode_attention": ("serve", counts),
                "flash_attention": ("serve", counts),
                "chunk_attention": ("paged serve", paged_counts),
                "paged_decode_attention": ("paged serve", paged_counts),
                "copy_pages": ("paged parity (ring wrap)", cow_counts),
                "mla_chunk_attention": ("mla serve", mla_counts),
                "paged_mla_decode_attention": ("deepseek serve",
                                               ds_counts),
                "lru_scan": ("rg serve (paged)", rg_counts["paged"]),
                "stmc_conv": ("unet stream", unet_counts)}
    # the decode kernels' second path: recurrentgemma's MQA at G 16 / dh 256
    rg_second = {"decode_attention": rg_counts["dense"],
                 "paged_decode_attention": rg_counts["paged"]}
    check(mla_cow_counts["copy_pages"] > 0,
          "copy_pages never ran on the MLA pools")
    summary = []
    for name in KERNEL_META:
        rec = main_recs[name]
        path, cnt = launches[name]
        check(cnt[name] > 0, f"{name} never launched on its path ({path})")
        summary.append({
            "name": name, "route": "cuda", **KERNEL_META[name],
            "launches": cnt[name], "launches_on": path,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "shape": rec["shape"],
            "dtype": rec["dtype"]})
        if name == "flash_attention":
            # its second path: deepseek-v2's exact-length MLA prefill
            mla = main_recs["flash_attention (MLA)"]
            summary[-1]["mla"] = {
                key: mla[key] for key in ("shape", "max_abs_err", "ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")}
            summary[-1]["mla"].update(
                launches=ds_counts["flash_attention"],
                launches_on="deepseek serve")
        if name in rg_second:
            rg = main_recs[name + " (RG)"]
            summary[-1]["rg"] = {
                key: rg[key] for key in ("shape", "max_abs_err", "ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")}
            summary[-1]["rg"].update(
                launches=rg_second[name][name],
                launches_on="rg serve (" + ("paged" if "paged" in name
                                            else "dense") + ")")
            check(rg_second[name][name] > 0,
                  f"{name} never launched on the recurrentgemma serve")
        if name in SPEC_PATHS:
            # the speculative windows' run of the same kernel (phase 15)
            run = SPEC_PATHS[name]
            summary[-1]["spec"] = {
                "launches": spec_counts[run][name],
                "launches_on": f"spec serve ({run})"}
        if name in obs_counts:
            # phase 16's run of the same kernel
            cnt_obs, on = obs_counts[name]
            summary[-1]["obs"] = {"launches": cnt_obs[name],
                                  "launches_on": on}
        if name in CHUNK_KERNELS:
            # the same wrapper on the middle's chunk of compressed frames
            mid = main_recs[name + " (middle)"]
            summary[-1]["middle"] = {
                key: mid[key] for key in ("shape", "max_abs_err", "ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")}
            summary[-1]["middle"].update(
                launches=cnt[name],
                launches_on=path + ", outer and middle layers")
        if name == "decode_attention":
            # the same wrapper on recurrentgemma's compressed middle rings
            mid = main_recs[name + " (RG middle)"]
            summary[-1]["rg_middle"] = {
                key: mid[key] for key in ("shape", "max_abs_err", "ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")}
            summary[-1]["rg_middle"].update(
                launches=rg_second[name][name],
                launches_on="rg serve (dense), outer and middle layers")
    print(f"== 17 done in {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
