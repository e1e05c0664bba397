"""Quickstart on the PyTorch port: train a small LM (qwen3 family, reduced
config) with the production stack — host-sharded data, the microbatched
train step, async atomic checkpoints, the restart-safe supervisor — then
serve a few requests through the port's ``launch/serve.py`` (random weights,
as in ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] \\
        [--steps 120]

The card is the default device; ``--device cpu`` runs the plain kernels.
"""

import argparse
import tempfile

from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=120)
    args = ap.parse_args(argv)
    dev = ["--device", args.device]

    print(f"=== train (reduced qwen3, {args.steps} steps, ckpt/restart-safe) "
          f"===")
    with tempfile.TemporaryDirectory() as ckpt:
        losses = train_mod.main(dev + [
            "--arch", "qwen3-1.7b", "--smoke", "--steps", str(args.steps),
            "--batch", "8", "--seq", "96", "--ckpt-dir", ckpt,
            "--ckpt-every", "50", "--log-every", "30"])
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not decrease: {losses[0]} -> "
                           f"{losses[-1]}")

    print("\n=== serve (greedy decode, prefill + cached steps) ===")
    serve_mod.main(dev + ["--arch", "qwen3-1.7b", "--smoke", "--batch", "2",
                          "--prompt-len", "16", "--gen-len", "24"])

    print("\n=== serve with SOI scattered decode (the paper's pattern) ===")
    serve_mod.main(dev + ["--arch", "qwen3-1.7b", "--smoke", "--soi", "pp",
                          "--batch", "2", "--prompt-len", "16",
                          "--gen-len", "24"])


if __name__ == "__main__":
    main()
