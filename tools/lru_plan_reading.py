"""The reading behind ``lru_plan``'s choices: ``lru_scan`` at
recurrentgemma's prefill shapes (width 4096; S 2040 outer, 1020 middle; B 1
and B 4) at the wrapper's plan and at the plans its rules turn down, on one
CUDA card.

    python3 tools/lru_plan_reading.py

Prints the card's name and power limit, then per shape and plan the
chain-warps a block, blocks, stages and steps a stage (T), the ring's
shared memory, the device ms (torch.profiler) and CUDA-event ms, and
whether the result is the plain version's bit for bit (float32). The plans
turned down: shorter and longer stages, fewer and more of them, the edge
path's plain loads at a shape the ring takes, and at B 4 other numbers of
chain-warps a block. A measurement only: ``chip_smoke.py`` times the
wrapper's plan alone.
"""

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as smoke                                     # noqa: E402
from repro_torch.kernels import lru_scan as LS                 # noqa: E402
from repro_torch.kernels import ref                            # noqa: E402

SMEM_PER_BLOCK = 232448
# (label, B, S, D, dtype, [(warps, stages, KB a stage a warp)] turned down)
F32, BF16 = torch.float32, torch.bfloat16
B1 = [(1, 3, 16), (1, 4, 32), (1, 6, 32), (1, 3, 64), (1, 8, 16),
      (1, 8, 8)]
SHAPES = (("outer", 1, 2040, 4096, F32, B1),
          ("outer", 1, 2040, 4096, BF16, B1),
          ("middle", 1, 1020, 4096, F32, B1),
          ("B 4", 4, 2040, 4096, F32,
           [(1, 3, 32), (2, 3, 32), (4, 3, 8), (8, 3, 8)]))


def _plan(b, s, d, dt, warps, stages, kib):
    """A ring plan of ``warps`` chain-warps a block and ``stages`` stages of
    ``kib`` KB of a and x a warp."""
    esz = torch.finfo(dt).bits // 8
    row = 2 * LS.CHAIN * esz
    steps = kib * 1024 // row
    chains = b * -(-d // LS.CHAIN)
    return LS.LruPlan(chains, warps, -(-chains // warps), steps, stages,
                      warps * stages * steps * row, False)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, b, s, d, dt, others in SHAPES:
        sets, nbytes = smoke._lru_case(b, s, d, dt, dev, gen)[:2]
        bound, _ = smoke._bound(nbytes, 2.0 * b * s * d, dt)
        want = ref.lru_scan(*sets[0])[0]
        mine = LS.lru_plan(b, s, d, dt)
        plans = ([("plan", mine)]
                 + [("not", _plan(b, s, d, dt, *o)) for o in others]
                 + [("not", mine._replace(steps=0, stages=0, smem=0,
                                          edge=True))])
        for tag, plan in plans:
            if plan.smem > SMEM_PER_BLOCK:
                continue

            def run(*args, plan=plan):
                return LS._launch(*args, plan)
            exact = bool(torch.equal(run(*sets[0]), want))
            event = smoke._time_ms(run, sets, 30)
            ms = smoke._device_ms(run, sets, 15) or event
            how = ("edge path" if plan.edge else
                   f"{plan.stages} stages of T {plan.steps}, "
                   f"{plan.smem // 1024} KB")
            print(f"{label} ({b},{s},{d}) {str(dt)[6:]} {tag} "
                  f"{plan.warps} warps a block, {plan.blocks} blocks, {how}: "
                  f"{ms:.4f} ms [{event:.4f}], bound {bound:.4f} "
                  f"({bound / ms:.3f}), bit for bit {exact}", flush=True)


if __name__ == "__main__":
    main()
