"""The port's GPipe pipeline (``repro_torch.distributed.pipeline``) on 4
gloo ranks, spawned once (``_torch_ranks``): L 8 tanh layers of width 16,
batch 12, 3 microbatches — the reference's case (``tests/
test_pipeline.py``) with numpy-drawn weights. Every rank's output is
within 1e-5 of the sequential stack, and ``bubble_fraction(4, 3)`` is
0.5."""

import numpy as np
import pytest
import torch

import _torch_ranks as R
from repro_torch.distributed.pipeline import bubble_fraction

torch.set_num_threads(1)

WORLD, L, D, B = 4, 8, 16, 12


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    inp = {"w": (0.3 * rng.standard_normal((L, D, D))).astype(np.float32),
           "b": (0.01 * rng.standard_normal((L, D))).astype(np.float32),
           "x": rng.standard_normal((B, D)).astype(np.float32),
           "microbatches": 3}
    R._save(tmp, "pipeline_in.pkl", inp)
    R.spawn(WORLD, "pipeline", tmp)
    return inp, [R.load(tmp, f"pipeline_out_{r}.pkl") for r in range(WORLD)]


def test_pipeline_matches_sequential(run):
    inp, outs = run
    h = torch.from_numpy(inp["x"])
    for i in range(L):
        h = torch.tanh(h @ torch.from_numpy(inp["w"][i])
                       + torch.from_numpy(inp["b"][i]))
    for r in range(WORLD):
        assert outs[r].shape == (B, D)
        assert float(np.abs(outs[r] - h.numpy()).max()) < 1e-5, r


def test_bubble_fraction():
    assert abs(bubble_fraction(4, 3) - 0.5) < 1e-9
    assert bubble_fraction(1, 8) == 0.0
