"""The reading behind ``chip_smoke._device_events``'s ``markers``: a
torch.profiler session of a process that has already profiled a lot drops
the first device records it should hand back, on one CUDA card.

    python3 tools/profiler_drop_reading.py

Prints the card's name and power limit, then, fresh, after
``chip_smoke.py``'s phase 3 and after its phases 4 to 6 (run in this
process): for the bf16 ``flash_attention_bwd`` at (8, 128, 16/8, 128) and
(1, 4096, 16/8, 128), two profiled runs of 256 spin kernels followed by
the calls (50 and 20): how many spin kernels the profiler kept, how many
dK/dV and dQ kernels it kept after the last of them, the device ms a call
read from those, the device ms a call read from every event of a run
without the spin kernels (``_device_ms`` without ``markers``), and the
CUDA-event ms a call (host gaps included).
"""

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as smoke                                     # noqa: E402
from repro_torch.kernels import flash_attention as FA          # noqa: E402

MARKERS = 256
SHAPES = ((8, 128, 50), (1, 4096, 20))


def _probe(tag, dev, gen):
    for b, s, iters in SHAPES:
        make, nbytes = smoke._bwd_inputs(b, s, torch.bfloat16, dev, gen)
        sets = smoke._copies(make, nbytes)
        FA.flash_attention_bwd(*sets[0])

        def run():
            for _ in range(MARKERS):
                torch.cuda._sleep(100)
            for i in range(iters):
                FA.flash_attention_bwd(*sets[i % len(sets)])
        for rep in range(2):
            ev = smoke._device_events(run)
            marks = [x[0] for x in ev if "spin_kernel" in x[2]]
            kept = [x for x in ev if marks and x[0] > marks[-1]]
            parts = {k: sum(k in x[2] for x in kept)
                     for k in ("dkdv_kernel", "dq_kernel")}
            ms = sum(e - s_ for s_, e, _ in kept) / iters / 1e3
            plain = smoke._device_ms(FA.flash_attention_bwd, sets, iters)
            event = smoke._time_ms(FA.flash_attention_bwd, sets, iters)
            print(f"[{tag}] ({b},{s},16/8,128) run {rep}: spin kernels kept "
                  f"{len(marks)}/{MARKERS}; after them {parts} of {iters} "
                  f"each, {ms:.4f} ms; without markers {plain:.4f} ms; CUDA "
                  f"events {event:.4f} ms", flush=True)
        del sets
        smoke._free(dev)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    smoke.device_phase()
    dev = torch.device("cuda", 0)
    smoke.build_phase()
    gen = torch.Generator(device=dev).manual_seed(3)
    _probe("fresh", dev, gen)
    smoke.kernels_phase(dev)
    _probe("after phase 3", dev, gen)
    smoke.parity_phase(dev)
    smoke.serve_phase(dev)
    smoke.paged_serve_phase(dev)
    _probe("after phases 4-6", dev, gen)


if __name__ == "__main__":
    main()
