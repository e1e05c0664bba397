"""The reading behind bf16 ``chunk_attention``'s split of the keys: at
qwen3's serving chunks (every query at a real position, as
``models/attention.py`` sends them) the kernel over the wrapper's split
(``chunk_split``: ranges merged in split order) and over one range of all
keys, on one CUDA card.

    python3 tools/chunk_split_reading.py

Prints the card's name and power limit, then per chunk the device ms
(torch.profiler) and CUDA-event ms of each plan and its max|Δ| against the
plain version. A measurement only: ``chip_smoke.py`` times the serving
plan alone.
"""

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as smoke                                     # noqa: E402
from repro_torch.kernels import chunk_attention as CA          # noqa: E402
from repro_torch.kernels import ref                            # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    for label, shape in (("outer q(1,256,16,128) Sk 1344",
                          (1, 256, 1088, 8, 2, 128, bf, 768, 768, 0)),
                         ("middle q(1,128,16,128) Sk 896",
                          (1, 128, 768, 8, 2, 128, bf, 384, 384, 0))):
        sets = smoke._chunk_case(*shape, dev, gen)[0]
        q, k = sets[0][0], sets[0][1]
        want = ref.chunk_attention(*sets[0]).float()
        split = CA.launch_plan(q, k)
        one = (1, split[0] * split[1], None)
        for name, plan in ((f"split {split[0]} x {split[1]}", split),
                           (f"one range of {one[1]}", one)):
            def run(*a, plan=plan):
                return CA._run_plan(*a, plan)
            err = float((run(*sets[0]).float() - want).abs().max())
            event = smoke._time_ms(run, sets, 50)
            ms = smoke._device_ms(run, sets, 20) or event
            print(f"{label}: {name}: {ms:.4f} ms [{event:.4f}], "
                  f"max|Δ| {err:.2e}", flush=True)


if __name__ == "__main__":
    main()
