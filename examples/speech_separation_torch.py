"""The paper's primary experiment on the PyTorch port, end to end at
reduced scale (the counterpart of ``examples/speech_separation.py``):
train a causal U-Net speech separator on the synthetic noisy-mixture
task, then show

  1. quality: the SOI variants' SI-SNRi against the baseline;
  2. complexity: the exact MAC accounting (retain and precomputed share);
  3. equivalence: the streamed phase-stepped inference (on the card, every
     computed conv one ``stmc_conv`` launch) equals the offline graph.

    PYTHONPATH=src python examples/speech_separation_torch.py \\
        [--device cpu] [--steps 250]
"""

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.soi import SOIConvCfg
from repro_torch.data.synthetic import si_snr, speech_mixture
from repro_torch.models import unet
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm

KW = dict(in_channels=24, out_channels=24, enc_channels=(16, 20, 24, 32))


def train(cfg, steps, dev, seed=0):
    rng = np.random.default_rng(seed)
    model = unet.init(cfg, generator=torch.Generator(device=dev)
                      .manual_seed(seed), device=dev)
    named = dict(model.named_parameters())
    opt = adamw_init(named)
    for i in range(steps):
        noisy, clean = (torch.from_numpy(a).to(dev) for a in
                        speech_mixture(rng, 8, 64, cfg.in_channels))
        y, _ = unet.apply_offline(model, noisy, cfg)
        loss = torch.mean(torch.square(y - clean))
        grads = dict(zip(named, torch.autograd.grad(loss,
                                                    list(named.values()))))
        grads, _ = clip_by_global_norm(grads, 1.0)
        adamw_update(grads, opt, named, lr=2e-3, weight_decay=0.0)
        if i % 50 == 0:
            print(f"  step {i:4d} loss {float(loss.detach()):.4f}")
    return model


@torch.no_grad()
def evaluate(model, cfg, dev, seed=777):
    noisy, clean = speech_mixture(np.random.default_rng(seed), 16, 64,
                                  cfg.in_channels)
    y, _ = unet.apply_offline(model, torch.from_numpy(noisy).to(dev), cfg)
    return float(np.mean(si_snr(y.cpu().numpy(), clean)
                         - si_snr(noisy, clean)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=250)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False   # 1e-3 parity
        torch.backends.cudnn.allow_tf32 = False

    results = []
    for label, soi in [("baseline (STMC)", None),
                       ("SOI PP S-CC 3", SOIConvCfg(pairs=(3,))),
                       ("SOI PP S-CC 1", SOIConvCfg(pairs=(1,))),
                       ("SOI FP SS-CC 3", SOIConvCfg(pairs=(3,), mode="fp"))]:
        cfg = unet.UNetConfig(soi=soi, **KW)
        print(f"training {label} ...")
        model = train(cfg, args.steps, dev)
        snr = evaluate(model, cfg, dev)
        rep = unet.complexity_report(cfg)
        results.append((label, snr, 100 * rep.retain,
                        100 * rep.precomputed_fraction))

        # deployment check: streamed inference == offline graph
        x = torch.from_numpy(speech_mixture(np.random.default_rng(1), 2, 32,
                                            cfg.in_channels)[0]).to(dev)
        with torch.no_grad():
            y_off, _ = unet.apply_offline(model, x, cfg)
        y_on = unet.stream_infer(model, x, cfg)
        err = float((y_off - y_on).abs().max())
        if not err < 1e-3:
            raise RuntimeError(f"stream differs from offline: {err}")
        print(f"  stream==offline max err {err:.2e}  OK")

    print(f"\n{'model':18s} {'SI-SNRi dB':>10s} {'MACs retain %':>13s} "
          f"{'precomputed %':>13s}")
    for label, snr, retain, pre in results:
        print(f"{label:18s} {snr:10.2f} {retain:13.1f} {pre:13.1f}")
    base = results[0][1]
    print(f"\nSOI S-CC 3 keeps {100 * results[1][1] / base:.0f}% of quality "
          f"at {results[1][2]:.0f}% of the compute; earlier placement "
          f"(S-CC 1) saves more but costs more quality — the paper's "
          "central trade-off.")


if __name__ == "__main__":
    main()
