"""paligemma-3b on repro_torch, on the CPU, against the JAX package on the
same weights (its ``smoke_config`` in float32: 4 layers, MQA at dh 16, an
image prefix of 8 positions, weights from the JAX ``init`` through
``from_jax_params``):

  * the configs equal the reference's; ``n_layers`` cuts the depth only;
  * the forward, with and without ``prefix_embeds``, against
    ``repro.models.transformer.forward`` within 1e-4;
  * ``decode.prefill`` with and without ``prefix_embeds``, then two
    ``decode_step`` calls, against the forward over the grown sequence
    within 3e-4 and against the reference's prefill logits (as
    tests/test_decode.py's prefix-LM case);
  * greedy tokens of the port's engine against the JAX engine's (exact
    prompt length, the first ``frontend_len`` positions bidirectional),
    dense and paged — tokens identical, logits within 5e-4, paged bit for
    bit the dense engine;
  * an SOI prefill of a prefix-LM config refused, as in the reference;
  * the serving driver at ``--arch paligemma-3b --smoke``, dense equal to
    paged;
  * ``check_trainable`` accepting the three families of this file's slice
    (their training is held in tests/test_torch_train_zoo.py) and the mesh
    step refusing each on more than one rank.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.paligemma_3b as JPG
from repro.distributed.sharding import split_axes
from repro.engine import SOIEngine as JEngine
from repro.models import decode as JD
from repro.models import transformer as JT
from repro_torch import configs as pconfigs
from repro_torch.configs import paligemma_3b as PPG
from repro_torch.convert import from_jax_params
from repro_torch.engine import SOIEngine
from repro_torch.launch import serve as pserve
from repro_torch.models import decode as PD
from repro_torch.models import transformer as PT

torch.set_num_threads(1)

ATOL = 5e-4
FWD_ATOL = 1e-4
DECODE_ATOL = 3e-4      # tests/test_decode.py's prefix-LM bound


@functools.lru_cache(maxsize=None)
def _setup(soi=None):
    jc = dataclasses.replace(JPG.smoke_config(soi=soi), dtype="float32")
    pc = dataclasses.replace(PPG.smoke_config(soi=soi), dtype="float32")
    jparams, _ = split_axes(JT.init(jax.random.PRNGKey(0), jc))
    model = from_jax_params(jax.tree.map(np.asarray, jparams), pc,
                            device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jc.vocab, (3, 16)).astype(np.int32)
    patches = (0.1 * rng.standard_normal(
        (3, jc.frontend_len, jc.d_model))).astype(np.float32)
    return jc, pc, jparams, model, tokens, patches


def test_configs_match_reference_and_cut_depth_only():
    for soi in (None, "pp", "fp"):
        assert (dataclasses.asdict(PPG.config(soi=soi))
                == dataclasses.asdict(JPG.config(soi=soi)))
        assert (dataclasses.asdict(PPG.smoke_config(soi=soi))
                == dataclasses.asdict(JPG.smoke_config(soi=soi)))
    cut = pconfigs.get("paligemma-3b", n_layers=4)
    assert cut.n_layers == 4 and cut.segments[0].blocks == \
        PPG.config().segments[0].blocks
    assert "paligemma-3b" in pconfigs.ARCHS


@pytest.mark.parametrize("prefix", [False, True], ids=["text", "image"])
def test_forward_matches_reference(prefix):
    jc, pc, jparams, model, tokens, patches = _setup()
    jkw = {"prefix_embeds": jnp.asarray(patches)} if prefix else {}
    pkw = {"prefix_embeds": torch.from_numpy(patches)} if prefix else {}
    ref = np.asarray(JT.forward(jparams, jc, jnp.asarray(tokens), **jkw))
    got = PT.forward(model, pc, torch.from_numpy(tokens), **pkw).numpy()
    assert got.shape == ref.shape
    assert float(np.max(np.abs(got - ref))) < FWD_ATOL


@pytest.mark.parametrize("prefix", [False, True], ids=["text", "image"])
def test_prefill_then_decode(prefix):
    jc, pc, jparams, model, tokens, patches = _setup()
    b, s = 2, 8
    toks = tokens[:b, :s]
    n_pre = jc.frontend_len if prefix else 0
    jkw = {"prefix_embeds": jnp.asarray(patches[:b])} if prefix else {}
    pkw = {"prefix_embeds": torch.from_numpy(patches[:b])} if prefix else {}
    max_len = n_pre + s + 2
    ref_lg, _ = JD.prefill(jparams, jc, jnp.asarray(toks), max_len=max_len,
                           **jkw)
    lg, state = PD.prefill(model, pc, torch.from_numpy(toks),
                           max_len=max_len, **pkw)
    assert float(np.max(np.abs(lg.numpy() - np.asarray(ref_lg)))) < ATOL
    assert state["t"].tolist() == [n_pre + s] * b
    seq = torch.from_numpy(toks)
    for _ in range(2):
        full = PT.forward(model, pc, seq, **pkw)[:, -1].numpy()
        assert float(np.max(np.abs(lg.numpy() - full))) < DECODE_ATOL
        nxt = torch.argmax(lg, -1).to(torch.int32)
        lg, state = PD.decode_step(model, pc, state, nxt)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    full = PT.forward(model, pc, seq, **pkw)[:, -1].numpy()
    assert float(np.max(np.abs(lg.numpy() - full))) < DECODE_ATOL


def _greedy(eng, params, tokens, conv, n_steps=8):
    ds = eng.init_decode_state(params)
    active = []
    for slot, n in ((0, 11), (1, 6)):
        ds = eng.insert(eng.prefill(params, conv(tokens[slot, :n])), ds, slot)
        active.append(slot)
    out = []
    for k in range(n_steps):
        if k == 3:
            ds = eng.insert(eng.prefill(params, conv(tokens[2, :9])), ds, 2)
            active.append(2)
        ds, res = eng.generate(params, ds)
        data = np.asarray(res.convert_to_numpy().data)
        out.append((np.asarray(res.logits)[active],
                    [int(data[s, 0]) for s in active]))
    return out


KW = dict(max_concurrent_decodes=4, max_len=24)
PAGED = dict(paged=True, page_size=4)


@functools.lru_cache(maxsize=None)
def _runs(paged):
    jc, pc, jparams, model, tokens, _ = _setup()
    kw = dict(KW, **PAGED) if paged else KW
    ref = _greedy(JEngine(jc, **kw), jparams, tokens, jnp.asarray)
    got = _greedy(SOIEngine(pc, device="cpu", **kw), model, tokens,
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


@pytest.mark.parametrize("prefix", [False, True], ids=["text", "image"])
def test_soi_prefill_refused(prefix):
    jc, pc, jparams, model, tokens, patches = _setup("pp")
    pkw = {"prefix_embeds": torch.from_numpy(patches[:1])} if prefix else {}
    jkw = {"prefix_embeds": jnp.asarray(patches[:1])} if prefix else {}
    with pytest.raises(NotImplementedError, match="SOI prefill"):
        JD.prefill(jparams, jc, jnp.asarray(tokens[:1, :6]), **jkw)
    with pytest.raises(NotImplementedError, match="SOI prefill"):
        PD.prefill(model, pc, torch.from_numpy(tokens[:1, :6]), **pkw)
    eng = SOIEngine(pc, max_concurrent_decodes=2, max_len=16, device="cpu")
    with pytest.raises(NotImplementedError, match="SOI prefill"):
        eng.prefill(model, torch.from_numpy(tokens[0, :6]))


def test_serve_driver_runs_paligemma_on_cpu():
    argv = ["--arch", "paligemma-3b", "--smoke", "--device", "cpu",
            "--batch", "3", "--prompt-len", "14", "--stagger", "1",
            "--gen-len", "6"]
    dense = pserve.main(argv)
    paged = pserve.main(argv + ["--paged", "--page-size", "4"])
    assert dense.shape == (3, 6) and np.array_equal(dense, paged)


@pytest.mark.parametrize("arch,kind", [("rwkv6-1.6b", "RWKV"),
                                       ("whisper-tiny", "encoder-decoder"),
                                       ("paligemma-3b", "prefix-LM")])
def test_check_trainable_refuses_new_families(arch, kind):
    """They train on every device, and since their sharded steps are
    held (``tests/test_torch_sharded_families.py``) the layout check of a
    step on a 2 x 2 mesh passes them too: no ``kind`` stack is refused."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch import steps as PS
    cfg = pconfigs.get_smoke(arch)
    for device in ("cpu", "cuda"):
        PT.check_trainable(cfg, device)
    PS.make_train_step(cfg)
    for step in ("train", "serve"):
        PS._check_layout(cfg, ShardingRules(data_axes=("data",)), 2, step)
