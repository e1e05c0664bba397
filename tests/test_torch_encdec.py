"""whisper-tiny on repro_torch, on the CPU, against the JAX package on the
same weights (its ``smoke_config`` in float32: 2 + 2 layers, 16 frames,
weights from the JAX ``init`` through ``from_jax_params``):

  * the configs equal the reference's; ``n_layers`` cuts the decoder only;
  * ``encode`` (bidirectional blocks, final LayerNorm) and the forward over
    its output (learned positions, cross attention) against
    ``repro.models.transformer``;
  * prefill -> insert -> generate with forced tokens against the offline
    forward, dense and paged (as tests/test_paged.py's round trip);
  * greedy tokens of the port's engine against the JAX engine's, dense and
    paged (pages of 4), each request with its own frames — tokens
    identical, logits within 5e-4, the paged engine bit for bit the dense
    one, a freed and re-inserted slot included;
  * the reference's errors: prefill without frames, a prefix whose frame
    count does not fit the decode state, a state without encoder K/V,
    ``max_len`` past the learned position table, chunked prefill with an
    encoder, an SOI prefill with an encoder; and the serving driver, which
    has no flag for frames, raising the missing-frames error.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.whisper_tiny as JW
from repro.distributed.sharding import split_axes
from repro.engine import SOIEngine as JEngine
from repro.models import transformer as JT
from repro_torch import configs as pconfigs
from repro_torch.configs import whisper_tiny as PW
from repro_torch.convert import from_jax_params
from repro_torch.engine import SOIEngine
from repro_torch.launch import serve as pserve
from repro_torch.models import decode as PD
from repro_torch.models import transformer as PT

torch.set_num_threads(1)

ATOL = 5e-4
FWD_ATOL = 1e-4
ENC_ATOL = 1e-5
S = 12


@functools.lru_cache(maxsize=None)
def _setup(soi=None):
    jc = dataclasses.replace(JW.smoke_config(soi=soi), dtype="float32")
    pc = dataclasses.replace(PW.smoke_config(soi=soi), dtype="float32")
    jparams, _ = split_axes(JT.init(jax.random.PRNGKey(0), jc))
    model = from_jax_params(jax.tree.map(np.asarray, jparams), pc,
                            device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jc.vocab, (3, S)).astype(np.int32)
    frames = (0.1 * rng.standard_normal(
        (3, jc.encoder.n_frames, jc.encoder.d_model))).astype(np.float32)
    return jc, pc, jparams, model, tokens, frames


def test_configs_match_reference_and_cut_decoder_only():
    for soi in (None, "pp"):
        assert (dataclasses.asdict(PW.config(soi=soi))
                == dataclasses.asdict(JW.config(soi=soi)))
        assert (dataclasses.asdict(PW.smoke_config(soi=soi))
                == dataclasses.asdict(JW.smoke_config(soi=soi)))
    cut = pconfigs.get("whisper-tiny", n_layers=2)
    assert cut.n_layers == 2 and cut.encoder == PW.config().encoder
    assert "whisper-tiny" in pconfigs.ARCHS


def test_encode_and_forward_match_reference():
    jc, pc, jparams, model, tokens, frames = _setup()
    ref_enc = np.asarray(JT.encode(jparams, jc, jnp.asarray(frames)))
    got_enc = PT.encode(model, pc, torch.from_numpy(frames))
    assert got_enc.shape == (3, jc.encoder.n_frames, jc.d_model)
    assert float(np.max(np.abs(got_enc.numpy() - ref_enc))) < ENC_ATOL
    ref = np.asarray(JT.forward(jparams, jc, jnp.asarray(tokens),
                                enc_out=jnp.asarray(ref_enc)))
    got = PT.forward(model, pc, torch.from_numpy(tokens),
                     enc_out=got_enc).numpy()
    assert float(np.max(np.abs(got - ref))) < FWD_ATOL


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_insert_generate_roundtrip(paged):
    """Per-slot encoder K/V survives prefill -> insert -> generate: every
    step's logits equal the offline forward's at that position."""
    jc, pc, jparams, model, tokens, frames = _setup()
    tt = torch.from_numpy(tokens[:2, :10])
    ft = torch.from_numpy(frames[:2])
    full = PT.forward(model, pc, tt, enc_out=torch.cat(
        [PT.encode(model, pc, ft[i:i + 1]) for i in range(2)])).numpy()
    kw = dict(paged=True, page_size=4) if paged else {}
    eng = SOIEngine(pc, max_concurrent_decodes=3, max_len=12, device="cpu",
                    **kw)
    ds = eng.init_decode_state(model)
    cur = {}
    for slot, off in enumerate((4, 6)):
        prefix = eng.prefill(model, tt[slot, :off],
                             encoder_frames=ft[slot:slot + 1])
        assert float(np.max(np.abs(prefix.logits[0].numpy()
                                   - full[slot, off - 1]))) < ATOL
        ds = eng.insert(prefix, ds, slot)
        cur[slot] = off
    while min(cur.values()) < 10:
        for r, c in cur.items():
            if c < 10:
                ds["tokens"][r] = tt[r, c]
        ds, res = eng.generate(model, ds)
        for r, c in list(cur.items()):
            if c < 10:
                err = float(np.max(np.abs(res.logits[r].numpy()
                                          - full[r, c])))
                assert err < ATOL, (r, c, err)
                cur[r] = c + 1


def _greedy(eng, params, tokens, frames, conv, n_steps=8):
    """Prompts of 5 and 7 tokens in slots 0 and 1 (each with its frames),
    one of 6 in slot 2 after 2 steps; slot 0 freed after 4 steps and
    re-inserted with request 2's prompt and frames."""
    ds = eng.init_decode_state(params)

    def prefill(i, n):
        return eng.prefill(params, conv(tokens[i, :n]),
                           encoder_frames=conv(frames[i:i + 1]))

    active = [0, 1]
    ds = eng.insert(prefill(0, 5), ds, 0)
    ds = eng.insert(prefill(1, 7), ds, 1)
    out = []
    for k in range(n_steps):
        if k == 2:
            ds = eng.insert(prefill(2, 6), ds, 2)
            active.append(2)
        if k == 4:
            ds = eng.free_slot(ds, 0)
            ds = eng.insert(prefill(2, 4), ds, 0)
        ds, res = eng.generate(params, ds)
        data = np.asarray(res.convert_to_numpy().data)
        out.append((np.asarray(res.logits)[active],
                    [int(data[s, 0]) for s in active]))
    return out


KW = dict(max_concurrent_decodes=3, max_len=16)
PAGED = dict(paged=True, page_size=4)


@functools.lru_cache(maxsize=None)
def _runs(paged):
    jc, pc, jparams, model, tokens, frames = _setup()
    kw = dict(KW, **PAGED) if paged else KW
    ref = _greedy(JEngine(jc, **kw), jparams, tokens, frames, jnp.asarray)
    got = _greedy(SOIEngine(pc, device="cpu", **kw), model, tokens, frames,
                  torch.from_numpy)
    return ref, got


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_matches_reference_engine(paged):
    ref, got = _runs(paged)
    for step, ((rl, rt), (gl, gt)) in enumerate(zip(ref, got)):
        assert gt == rt, (paged, step)
        assert float(np.max(np.abs(gl - rl))) < ATOL, (paged, step)


def test_paged_engine_bit_exact_vs_dense_engine():
    dense, paged = _runs(False)[1], _runs(True)[1]
    for step, ((dl, dt), (pl, pt)) in enumerate(zip(dense, paged)):
        assert dt == pt and np.array_equal(dl, pl), step


def test_mismatched_encoder_state_rejected():
    jc, pc, jparams, model, tokens, frames = _setup()
    eng = SOIEngine(pc, max_concurrent_decodes=2, max_len=8, device="cpu")
    ds = eng.init_decode_state(model)
    toks = torch.tensor([1, 2, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="encoder"):
        eng.prefill(model, toks)                       # no frames
    bad = torch.from_numpy(
        (0.1 * np.random.default_rng(4).standard_normal(
            (1, 8, jc.encoder.d_model))).astype(np.float32))
    prefix = eng.prefill(model, toks, encoder_frames=bad)
    with pytest.raises(ValueError, match="encoder state mismatch"):
        eng.insert(prefix, ds, 0)
    # the refused insert wrote nothing
    assert int(ds["model"]["t"][0]) == 0
    good = eng.prefill(model, toks,
                       encoder_frames=torch.from_numpy(frames[:1]))
    no_enc = {k: v for k, v in ds["model"].items() if k != "cross_kv"}
    with pytest.raises(ValueError, match="encoder state mismatch"):
        eng.insert(good, dict(ds, model=no_enc), 0)


def test_learned_pos_table_overflow_raises():
    _, pc, *_ = _setup()
    assert pc.learned_pos_len == 128
    with pytest.raises(ValueError, match="learned position table"):
        SOIEngine(pc, max_concurrent_decodes=2, max_len=256, device="cpu")
    SOIEngine(pc, max_concurrent_decodes=2, max_len=128, device="cpu")


def test_chunked_and_soi_prefill_refused():
    jc, pc, jparams, model, tokens, frames = _setup()
    with pytest.raises(ValueError, match="decoder-only"):
        JEngine(jc, max_concurrent_decodes=2, max_len=16, prefill_chunk=4)
    with pytest.raises(ValueError, match="decoder-only"):
        SOIEngine(pc, max_concurrent_decodes=2, max_len=16, prefill_chunk=4,
                  device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        PD.prefill_chunk(model, pc, PD.init_decode_state(model, pc, 1, 16),
                         torch.from_numpy(tokens[:1, :4]), 0, 4)
    jcs, pcs, jps, ms, *_ = _setup("pp")
    with pytest.raises(NotImplementedError, match="SOI prefill"):
        PD.prefill(ms, pcs, torch.from_numpy(tokens[:1, :6]),
                   encoder_frames=torch.from_numpy(frames[:1]))


def test_serve_driver_raises_the_missing_frames_error():
    argv = ["--arch", "whisper-tiny", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen-len", "4"]
    with pytest.raises(ValueError, match="encoder_frames"):
        pserve.main(argv)
