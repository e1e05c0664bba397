"""The port's numpy copies of the data substrate against the reference,
bit for bit: ``ShardedLMPipeline`` (the synthetic Markov stream over hosts
and steps, and a memory-mapped token file) and ``speech_mixture`` /
``si_snr`` / ``asc_scene`` of ``data.synthetic``."""

import numpy as np
import pytest

from repro.data import synthetic as JS
from repro.data.pipeline import ShardedLMPipeline as JPipe
from repro_torch.data import synthetic as PS
from repro_torch.data.pipeline import ShardedLMPipeline as PPipe


def _same_batches(kw, steps):
    for step in steps:
        want, got = JPipe(**kw).batch(step), PPipe(**kw).batch(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("host_id", [0, 3])
def test_synthetic_stream_bit_for_bit(host_id):
    _same_batches(dict(global_batch=8, seq_len=24, vocab=97, seed=5,
                       host_id=host_id, num_hosts=4), steps=(0, 1, 7))


def test_token_file_bit_for_bit(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 1000, 5000).astype(
        np.int32).tofile(path)
    _same_batches(dict(global_batch=4, seq_len=32, vocab=1000, seed=2,
                       token_file=str(path)), steps=(0, 3))


def test_host_rows_and_refused_split():
    kw = dict(global_batch=8, seq_len=4, vocab=11, num_hosts=4, host_id=1)
    np.testing.assert_array_equal(PPipe(**kw).host_rows(3),
                                  JPipe(**kw).host_rows(3))
    with pytest.raises(ValueError, match="multiple"):
        PPipe(global_batch=6, seq_len=4, vocab=11, num_hosts=4)


@pytest.mark.parametrize("seed", [0, 7])
def test_speech_mixture_and_si_snr_bit_for_bit(seed):
    jn, jc = JS.speech_mixture(np.random.default_rng(seed), 3, 40, 16)
    pn, pc = PS.speech_mixture(np.random.default_rng(seed), 3, 40, 16)
    np.testing.assert_array_equal(pn, jn)
    np.testing.assert_array_equal(pc, jc)
    assert pn.dtype == np.float32
    np.testing.assert_array_equal(PS.si_snr(pn, pc), JS.si_snr(jn, jc))


def test_asc_scene_bit_for_bit():
    jx, jy = JS.asc_scene(np.random.default_rng(3), 5, 20, 12, 4)
    px, py = PS.asc_scene(np.random.default_rng(3), 5, 20, 12, 4)
    np.testing.assert_array_equal(px, jx)
    np.testing.assert_array_equal(py, jy)
