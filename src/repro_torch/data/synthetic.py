"""Synthetic audio tasks standing in for the DNS / TAU-2020 datasets,
matching the paper's task *shapes* (the port's own numpy copy of
``repro.data.synthetic``: the same arrays bit for bit):

  * speech separation: clean = sum of harmonic tones with wandering pitch;
    noisy = clean + colored noise; model predicts a mask over feature bins.
    Quality metric: SI-SNR improvement (the paper's metric), computed on the
    feature-domain signals.
  * ASC: each class = a distinct spectral envelope + amplitude-modulation
    rate; model classifies the scene from the streamed features.
"""

from __future__ import annotations

import numpy as np


def speech_mixture(rng: np.random.Generator, batch: int, frames: int,
                   bins: int, snr_db: float = 5.0):
    """Returns (noisy, clean) feature-domain streams, shape (B, T, bins)."""
    t = np.arange(frames)[None, :, None] / frames
    f0 = rng.uniform(2.0, 8.0, (batch, 1, 1))
    drift = rng.uniform(-2.0, 2.0, (batch, 1, 1))
    centers = (f0 + drift * t) % bins
    k = np.arange(bins)[None, None, :]
    clean = np.zeros((batch, frames, bins), np.float32)
    for h in (1.0, 2.0, 3.0):
        c = (centers * h) % bins
        clean += np.exp(-0.5 * ((k - c) / 1.5) ** 2).astype(np.float32) / h
    am = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(1, 4, (batch, 1, 1)) * t)
    clean = (clean * am).astype(np.float32)
    # near-Nyquist temporal component (sign alternates every frame): real
    # speech onsets/transients live here — 2x input decimation aliases it
    # away entirely (why the paper's resampling baseline loses quality),
    # while SOI keeps full-rate input and only coarsens internal states.
    alt = ((-1.0) ** np.arange(frames))[None, :, None]
    gate = np.exp(-0.5 * ((k - (centers * 2.5) % bins) / 1.2) ** 2)
    clean = clean + (0.45 * alt * gate * am).astype(np.float32)

    noise = rng.standard_normal((batch, frames, bins)).astype(np.float32)
    # colored noise: smooth across bins + time
    noise = np.cumsum(noise, axis=2) / np.sqrt(np.arange(1, bins + 1))
    noise = np.abs(noise) * 0.5
    scale = (np.sqrt((clean ** 2).mean((1, 2), keepdims=True) /
                     ((noise ** 2).mean((1, 2), keepdims=True) + 1e-9))
             * 10 ** (-snr_db / 20))
    noisy = clean + noise * scale
    return noisy.astype(np.float32), clean


def si_snr(est: np.ndarray, ref: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Scale-invariant SNR in dB over flattened feature streams (B,)."""
    est = est.reshape(est.shape[0], -1)
    ref = ref.reshape(ref.shape[0], -1)
    ref_zm = ref - ref.mean(1, keepdims=True)
    est_zm = est - est.mean(1, keepdims=True)
    proj = (np.sum(est_zm * ref_zm, 1, keepdims=True) /
            (np.sum(ref_zm ** 2, 1, keepdims=True) + eps)) * ref_zm
    noise = est_zm - proj
    return 10 * np.log10((proj ** 2).sum(1) / ((noise ** 2).sum(1) + eps)
                         + eps)


def asc_scene(rng: np.random.Generator, batch: int, frames: int, bins: int,
              n_classes: int):
    """Returns (features (B,T,bins), labels (B,))."""
    labels = rng.integers(n_classes, size=batch)
    t = np.arange(frames)[None, :, None] / frames
    k = np.arange(bins)[None, None, :]
    envelopes = np.stack([
        np.exp(-0.5 * ((np.arange(bins) - (c + 1) * bins / (n_classes + 1))
                       / (bins / 8)) ** 2)
        for c in range(n_classes)])
    env = envelopes[labels][:, None, :]
    am_rate = 1.0 + labels[:, None, None] * 0.7
    am = 0.5 + 0.5 * np.sin(2 * np.pi * am_rate * t)
    x = env * am + 0.3 * np.abs(rng.standard_normal((batch, frames, bins)))
    return x.astype(np.float32), labels.astype(np.int32)
