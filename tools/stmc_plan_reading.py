"""The reading behind ``stmc_plan``'s choices: float32 ``stmc_conv`` on
convs of soi-unet-dns (and the ragged test shape) at the wrapper's plan and
at the plans its rules turn down, on one CUDA card.

    python3 tools/stmc_plan_reading.py

Prints the card's name and power limit, then per shape and plan the blocks,
the device ms (torch.profiler) and CUDA-event ms, and max|Δ| against the
plain version. The plans turned down: more splits than the SMs hold at
once (B 1: two blocks an SM; B 32: three), a tile of 16-byte row pieces
(decoder 7), half the blocks at B 32, fewer splits, and no cluster. A
measurement only: ``chip_smoke.py`` times the wrapper's plan alone.
"""

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as smoke                                     # noqa: E402
from repro_torch.kernels import ref                            # noqa: E402
from repro_torch.kernels import stmc_conv as SC                # noqa: E402

# (label, B, K, Cin, Cout, (cols, splits) of the plans turned down)
SHAPES = (("dec2 B 1", 1, 3, 2416, 664, ((32, 4), (16, 8))),
          ("enc7 B 1", 1, 3, 1208, 1296, ((32, 8),)),
          ("enc6 B 1", 1, 3, 664, 1208, ((32, 8),)),
          ("dec7 B 1", 1, 3, 1232, 128, ((4, 8),)),
          ("enc1 B 1", 1, 3, 128, 616, ((32, 4), (32, 1))),
          ("dec2 B 32", 32, 3, 2416, 664, ((32, 8),)),
          ("enc7 B 32", 32, 3, 1208, 1296, ((32, 4),)),
          ("ragged B 3", 3, 3, 64, 129, ((8, 1),)))


def _plan(b, kc, cout, cols, splits):
    """A plan at these columns and splits, the wrapper's rows."""
    keys = -(-kc // splits)
    keys += keys % 2
    rows = SC.stmc_plan(b, kc, cout, torch.float32).rows
    return SC.StmcPlan(cols, splits, keys, rows,
                       -(-cout // cols) * splits * -(-b // rows),
                       cout % 4 == 0)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    f32 = torch.float32
    for label, b, k, cin, cout, others in SHAPES:
        sets = smoke._stmc_case(b, k, cin, cout, f32, dev, gen,
                                bias=label != "ragged B 3")[0]
        want = ref.stmc_conv(*sets[0])
        mine = SC.stmc_plan(b, k * cin, cout, f32)
        plans = [("plan", mine)] + [
            ("not", _plan(b, k * cin, cout, c, s)) for c, s in others]
        for tag, plan in plans:
            def run(*a, plan=plan):
                return SC._launch(*a, plan)
            err = float((run(*sets[0]) - want).abs().max())
            event = smoke._time_ms(run, sets, 50)
            ms = smoke._device_ms(run, sets, 20) or event
            print(f"{label} {k * cin}x{cout} {tag} cols {plan.cols} splits "
                  f"{plan.splits} ({plan.blocks} blocks): {ms:.4f} ms "
                  f"[{event:.4f}], max|Δ| {err:.2e}", flush=True)


if __name__ == "__main__":
    main()
