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
             (max|Δ| < 2e-2 bf16, < 2e-5 f32; copy_pages bit-exact, and
             lru_scan bit-exact in f32), with
             its time, the plain version's and that of one PyTorch call
             computing the same function (a yardstick only) — device time
             from torch.profiler, and CUDA-event time per call beside it —
             and the least time the card could take (bytes or operations).
             The paged decode read is also compared bit for bit with the
             dense kernel over the gathered view. recurrentgemma's shapes:
             the decode reads at G 16 / dh 256 on wrapped rings of 2048
             with the window, lru_scan at (1, 2040, 4096) and (1, 1020,
             4096), with h0 and at an odd shape (no library yardstick: no
             single PyTorch call computes the recurrence). stmc_conv at the
             streaming U-Net's shapes, float32 and bfloat16 (torch.addmm as
             the yardstick).
4. parity  — full-width qwen3-1.7b cut to 4 layers (SOI over layers 1..3),
             float32, pp and fp: the port's SOIEngine with 3 slots (prompts
             of 200 and 201 tokens, a third of 150 after 3 steps), 8 greedy
             steps on the card and on the CPU: logits within 1e-3, tokens
             identical. Then, in pp, a paged chunked prefix-cache engine
             (page 16, chunk 64, max_len 256): 3 prompts of ~200 tokens
             sharing their first 128, 66 greedy steps, so every ring wraps
             onto shared pages and copies them on write — tokens identical,
             logits within 1e-3, prefix-cache counters equal, COW on the
             card through copy_pages.
5. serve   — the serving driver on full-width qwen3-1.7b, SOI pp, 4
             requests of 1024..1018 tokens, 64 generated each, dense rings
             and bucketed prefill; every kernel launch is counted and held
             to the count the host clocks give. A second, profiled run
             gives the decode loop's device busy time and idle share, and
             its kernel time by name.
6. paged   — the same traffic with a shared 768-token prefix through
             --paged --chunk-size 256 --prefix-cache: prefix-cache counters
             and chunk/paged-decode launch counts held to their expected
             values, tokens identical to the same command without the
             prefix cache, then a profiled rerun as in phase 5.
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
             a synchronize); a profiled rerun for the idle share.
9. mla     — deepseek-v2's layer-0 block (MLA + SwiGLU 12288) at full
             width, SOI pp. Card against CPU in float32 (2 layers): a
             paged, chunked prefix-cache engine whose rings wrap onto
             shared pages and copy the MLA pools on write — tokens
             identical, logits within 1e-3, counters equal. Then the serve
             traffic of phase 6 through 4 bfloat16 layers: mla_chunk
             attention launches held to 28 (4 layers x 7 computed chunks),
             prefix-cache counters, warm against cold bit for bit, and a
             profiled rerun.
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
             profiled rerun.
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
             rerun the idle share and kernel time by name.
14. the kernels JSON line, the card line, and last {"ok": true, ...}.

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
L2_BYTES = 50 * 2 ** 20

SERVE_ARGV = ["--arch", "qwen3-1.7b", "--soi", "pp", "--batch", "4",
              "--prompt-len", "1024", "--stagger", "2", "--gen-len", "64",
              "--seed", "0"]
PAGED_ARGV = SERVE_ARGV + ["--paged", "--page-size", "16", "--chunk-size",
                           "256", "--shared-prefix", "768"]


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(name):
    print(f"== {name}", flush=True)


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

# (label, mangled-name needle, template needle) of the serving path's
# instantiations (head dim 128; decode kernels at G = 2 query heads per KV
# head); the mangled names carry the identifier's length before it
PATH_KERNELS = (
    ("decode_attention", "23decode_attention_kernel", "Li2ELi128E"),
    ("paged_decode_attention", "29paged_decode_attention_kernel",
     "Li2ELi128E"),
    ("flash_attention", "22flash_attention_kernel", "Li128ELi128E"),
    ("flash_attention (MLA)", "22flash_attention_kernel", "Li192ELi128E"),
    ("chunk_attention", "22chunk_attention_kernel", "Li128E"),
    ("copy_pages", "17copy_pages_kernel", ""),
    ("mla_chunk_attention", "26mla_chunk_attention_kernel", "Li512ELi64E"),
    ("paged_mla_decode_attention", "33paged_mla_decode_attention_kernel",
     "Li512ELi64E"),
    ("decode_attention (MQA)", "23decode_attention_kernel", "Li16ELi256E"),
    ("paged_decode_attention (MQA)", "29paged_decode_attention_kernel",
     "Li16ELi256E"),
    ("lru_scan", "15lru_scan_kernel", "kernelI"),
    ("stmc_conv (B 1)", "16stmc_conv_kernel", "Li1E"),
    ("stmc_conv (B 8 tile)", "16stmc_conv_kernel", "Li8E"),
)


def _ptxas_lines(log: str) -> list:
    """One line per compiled kernel of the serving path, from nvcc
    -Xptxas -v."""
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
            for kind, needle, targs in PATH_KERNELS:
                if needle in name and targs in name:
                    dt = "bf16" if "bfloat16" in name else (
                        "f32" if targs else "bytes")   # copy_pages: bytes
                    smem = re.search(r"(\d+) bytes smem", line)
                    out.append(f"  {kind}[{dt}]: {m.group(1)} registers, "
                               f"{smem.group(1) if smem else 0} B static "
                               f"smem, {spill}")
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


def _device_ms(fn, sets, iters: int):
    """Mean device time per call (the summed durations of the call's
    kernels, host launch gaps excluded); None if the profiler saw no
    device activity."""
    def run():
        for i in range(iters):
            fn(*sets[i % len(sets)])
    ev = _device_events(run)
    if not ev:
        return None
    return sum(e - s for s, e, _ in ev) / iters / 1e3


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


def kernels_phase(dev) -> dict:
    """Returns {kernel name: record of its serving-path bf16 case}; the
    flash kernel's deepseek-v2 shape is keyed "flash_attention (MLA)", the
    decode kernels' recurrentgemma shapes "<name> (RG)"; lru_scan's and
    stmc_conv's records are their first float32 case, the dtype their
    paths run (stmc_conv: decoder 2 of the U-Net at B 1, one live stream)."""
    phase("3 kernels")
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
        # frames at 384.. against 768 + 128; 6 pad query rows each
        cases.append(("chunk_attention", "outer q(1,256,16,128) Sk 1344", dt,
                      _chunk_case(1, 256, 1088, 8, 2, 128, dt, 768, 768, 6,
                                  dev, gen),
                      CA.chunk_attention, ref.chunk_attention))
        cases.append(("chunk_attention", "middle q(1,128,16,128) Sk 896", dt,
                      _chunk_case(1, 128, 768, 8, 2, 128, dt, 384, 384, 6,
                                  dev, gen),
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
        # the MLA stack's serving chunk (as chunk_attention's above) and
        # the paged decode read at clocks 1056.. / frames 528..
        cases.append(("mla_chunk_attention",
                      "outer q(1,256,128,512+64) Sk 1344", dt,
                      _mla_chunk_case(1, 256, 1088, 128, 512, 64, dt, 768,
                                      768, 6, dev, gen),
                      CA.mla_chunk_attention, ref.mla_chunk_attention))
        cases.append(("mla_chunk_attention",
                      "middle q(1,128,128,512+64) Sk 896", dt,
                      _mla_chunk_case(1, 128, 768, 128, 512, 64, dt, 384,
                                      384, 6, dev, gen),
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
    cases.append(("copy_pages", "outer pool (273,16,8,128), 4+4 pairs",
                  torch.bfloat16,
                  _copy_case(273, 16, 8, 128, torch.bfloat16, dev, gen),
                  PC.copy_pages, ref.copy_pages))
    main = {}
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
        check(err < TOL[dt], f"{name} {shape} {dt}: max|Δ| {err} >= "
                             f"{TOL[dt]}")
        lib_err = None
        if library is not None:
            lib = library(*fresh()).float()
            rows = extra.get("rows")
            if rows is not None:
                lib, ref_rows = lib[:, rows], want.float()[:, rows]
            else:
                ref_rows = want.float()
            lib_err = float((lib - ref_rows).abs().max())
        rec_extra = {}
        if "dense_view" in extra:
            # the paged read against the dense kernel over the same logical
            # rows (gathered): bit for bit?
            kd, vd, posd, _ = extra["dense_view"][args[1].data_ptr()]
            dense = DA.decode_attention(args[0], kd, vd, posd, args[5], **kw)
            rec_extra["equals_dense_kernel"] = bool(torch.equal(got, dense))
        if extra.get("exact_f32") and dt == torch.float32:
            # the scan's product and sum round as the plain version's do
            rec_extra["equals_plain"] = bool(torch.equal(got, want))
            check(rec_extra["equals_plain"],
                  f"{name} {shape}: float32 not bit for bit the plain's")
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
        dev_ms = {"ms": _device_ms(kern, sets, 20),
                  "plain_ms": _device_ms(plain, sets, 5),
                  "library_ms": (_device_ms(library, sets, 20)
                                 if has_lib else None)}
        for key, val in dev_ms.items():
            if val is None:            # the profiler saw no device activity
                dev_ms[key] = event[key.replace("ms", "event_ms")]
        bound_ms, bound_by = _bound(nbytes, flops, dt)
        rec = {"name": name, "shape": shape, "dtype": str(dt)[6:],
               "max_abs_err": err, **dev_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, **event,
               "library_max_abs_err": lib_err, "bytes": nbytes,
               "flops": flops, **rec_extra}
        print(json.dumps({"kernels": [rec]}), flush=True)
        key = name + (" (MLA)" if shape.startswith("MLA") else
                      " (RG)" if shape.startswith("RG") else "")
        serving_dt = (torch.float32 if name in F32_PATHS
                      else torch.bfloat16)
        if dt == serving_dt and key not in main:
            main[key] = rec
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
            runs, stats = [], []
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
                print(f"  paged {where}: 3 chunked prefills + 66 steps in "
                      f"{time.perf_counter() - t0:.2f} s (host clock); "
                      f"prefix cache {stats[-1]}")
            worst = _compare_runs(runs, "paged pp")
            check(stats[0] == stats[1], f"prefix-cache counters differ: cpu "
                                        f"{stats[0]}, cuda {stats[1]}")
            check(stats[1]["hits"] == 2 and stats[1]["cow_copies"] > 0,
                  f"expected 2 hits and copies on write: {stats[1]}")
            check(paged_counts["copy_pages"] > 0
                  and paged_counts["chunk_attention"] > 0
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
    # the same run again under the profiler (CUDA activity only): device
    # busy and idle share of the decode loop, which starts after the last
    # prefill kernel; kernel time by name over that window
    print("  profiled rerun:")
    ev = _device_events(lambda: serve.run(args))
    check(ev, "the profiler saw no device activity")
    _decode_profile(ev, res.steps, "flash_attention_kernel")
    return counts


def _decode_profile(ev, steps: int, prefill_kernel: str):
    """Device busy time and idle share of a serve run's decode loop, which
    starts after the last ``prefill_kernel``; kernel time by name over that
    window."""
    prefill_end = max(e for _s, e, n in ev if prefill_kernel in n)
    _window_profile([(s_, e, n) for s_, e, n in ev if s_ >= prefill_end],
                    steps, "decode", "step")


def _window_profile(ev, n: int, label: str, unit: str):
    """Print the device busy time and idle share of the window the device
    events ``ev`` span, busy time per ``unit`` (``n`` of them), and kernel
    time by name."""
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
          f"paged_decode_attention {want_paged}")
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
    _decode_profile(ev, res.steps, "chunk_attention_kernel")
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
    _decode_profile(ev, res.steps, "flash_attention_kernel")
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
    runs, stats = [], []
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
        print(f"  parity {where}: 3 chunked prefills + 34 steps in "
              f"{time.perf_counter() - t0:.2f} s (host clock); prefix cache "
              f"{stats[-1]}")
    worst = _compare_runs(runs, "mla paged")
    check(stats[0] == stats[1], f"prefix-cache counters differ: cpu "
                                f"{stats[0]}, cuda {stats[1]}")
    check(stats[1]["hits"] == 2 and stats[1]["cow_copies"] > 0,
          f"expected 2 hits and copies on write: {stats[1]}")
    check(cow_counts["copy_pages"] > 0
          and cow_counts["mla_chunk_attention"] > 0
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
    print("  profiled rerun (paged):")
    ev = _device_events(lambda: serve.serve(engines["paged"], params, prompt,
                                            plens, args.gen_len))
    check(ev, "the profiler saw no device activity")
    _decode_profile(ev, res.steps, "lru_scan_kernel")
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
            warm = unet_stream_session(model, cfg, batch=b, device=dev)
            for t in range(2 * cfg.period):
                warm.push(x[:, t])
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            sess = unet_stream_session(model, cfg, batch=b, device=dev)
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
            n_prof = 64

            def run():
                for t in range(n_prof):
                    sess.push(x[:, t])
            ev = _device_events(run)
            check(ev, "the profiler saw no device activity")
            print(f"  profiled rerun, B {b} {label}, {n_prof} frames:")
            _window_profile(ev, n_prof, "stream", "frame")
    del model
    _free(dev)
    return main_counts


def main():
    t_start = time.perf_counter()
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
    print(f"== 14 done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
