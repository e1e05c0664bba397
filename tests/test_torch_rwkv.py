"""rwkv6-1.6b on repro_torch, on the CPU, against the JAX package on the same
weights (its ``smoke_config`` in float32, weights from the JAX ``init``
through ``from_jax_params``):

  * the time mix (chunked prefill form) against ``repro.models.rwkv``, at
    S of 5, 32 and 45 (not a multiple of the chunk of 32) within 1e-5, and
    against the port's own one-token recurrence; the channel mix and the
    prefill states likewise;
  * the configs equal the reference's, ``n_layers`` cuts the depth only;
  * the forward equals ``repro.models.transformer.forward`` within 1e-4,
    none / pp / fp;
  * the port's ``SOIEngine`` against the JAX ``SOIEngine`` (dense: the
    config has no attention cache to page, and both engines refuse
    ``paged=True``), none / pp / fp: prompts of 11 and 12 tokens, one of 9
    after 3 steps, 10 greedy steps — tokens identical, logits within 5e-4;
    bucketed and chunked prefill refused as in the reference;
  * the serving driver at ``--arch rwkv6-1.6b --smoke``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.rwkv6_1_6b as JRW
from repro.configs.base import RWKVCfg
from repro.distributed.sharding import split_axes
from repro.engine import SOIEngine as JEngine
from repro.models import rwkv as jrk
from repro.models import transformer as JT
from repro_torch import configs as pconfigs
from repro_torch.configs import rwkv6_1_6b as PRW
from repro_torch.convert import from_jax_params
from repro_torch.engine import SOIEngine
from repro_torch.launch import serve as pserve
from repro_torch.models import rwkv as prk
from repro_torch.models import transformer as PT

torch.set_num_threads(1)

MIX_ATOL = 1e-5         # time / channel mix against the reference
FWD_ATOL = 1e-4         # forward against the reference (test_torch_model)
ATOL = 5e-4             # engine logits against the reference engine
S = 32


def _mix_params(h, dh, seed=0):
    """A reference-shaped RWKV tree with every leaf drawn by numpy (the
    zero-initialised mixes, bonus and norm scale too), and the port's
    module holding the same numbers."""
    d = h * dh
    cfg = RWKVCfg(n_heads=h, head_dim=dh, decay_lora=8, mix_lora=4,
                  d_ff=3 * d)
    shapes, _ = split_axes(jax.eval_shape(
        lambda k: jrk.rwkv_init(k, cfg, d), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    tree = {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in shapes.items()}
    tree["w0"] = np.linspace(-6.0, -0.5, d).astype(np.float32)
    mod = prk.RWKV(cfg, d, generator=torch.Generator(), device="cpu")
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in tree.items()})
    mod.requires_grad_(False)
    return cfg, tree, mod


@pytest.mark.parametrize("s", [5, 32, 45])
def test_time_mix_matches_reference_and_recurrence(s):
    cfg, tree, mod = _mix_params(2, 8)
    x = (0.5 * np.random.default_rng(1).standard_normal((2, s, 16))
         ).astype(np.float32)
    prev = (0.5 * np.random.default_rng(2).standard_normal((2, 16))
            ).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    ry, (rx, rs) = jrk.rwkv_time_mix(jp, cfg, jnp.asarray(x),
                                     x_prev=jnp.asarray(prev))
    gy, (gx, gs) = prk.rwkv_time_mix(mod, torch.from_numpy(x),
                                     x_prev=torch.from_numpy(prev))
    assert float(np.max(np.abs(gy.detach().numpy() - np.asarray(ry)))) \
        < MIX_ATOL
    assert float(np.max(np.abs(gs.numpy() - np.asarray(rs)))) < MIX_ATOL
    assert np.array_equal(gx.detach().numpy(), np.asarray(rx))
    # the port's one-token recurrence from the same start
    st = {"x_prev": torch.from_numpy(prev).clone(),
          "S": torch.zeros((2, 2, 8, 8))}
    with torch.no_grad():
        ys = [prk.rwkv_time_mix_decode(mod, torch.from_numpy(x[:, t]), st)
              for t in range(s)]
    rec = torch.stack(ys, 1).numpy()
    assert float(np.max(np.abs(rec - gy.detach().numpy()))) < 1e-4
    assert float(np.max(np.abs(st["S"].numpy() - gs.numpy()))) < 1e-4


def test_channel_mix_matches_reference():
    cfg, tree, mod = _mix_params(2, 8, seed=3)
    x = np.random.default_rng(4).standard_normal((2, 9, 16)).astype(
        np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    ry, rl = jrk.rwkv_channel_mix(jp, jnp.asarray(x))
    gy, gl = prk.rwkv_channel_mix(mod, torch.from_numpy(x))
    assert float(np.max(np.abs(gy.detach().numpy() - np.asarray(ry)))) \
        < MIX_ATOL
    assert np.array_equal(gl.numpy(), np.asarray(rl))
    prev = torch.from_numpy(x[:, 3]).clone()
    with torch.no_grad():
        one = prk.rwkv_channel_mix_decode(mod, torch.from_numpy(x[:, 4]),
                                          prev)
    assert float(np.max(np.abs(one.numpy() - gy.detach().numpy()[:, 4]))) \
        < 1e-5
    assert np.array_equal(prev.numpy(), x[:, 4])


def test_configs_match_reference_and_cut_depth_only():
    for soi in (None, "pp", "fp"):
        assert (dataclasses.asdict(PRW.config(soi=soi))
                == dataclasses.asdict(JRW.config(soi=soi)))
        assert (dataclasses.asdict(PRW.smoke_config(soi=soi))
                == dataclasses.asdict(JRW.smoke_config(soi=soi)))
    cut = pconfigs.get("rwkv6-1.6b", soi="pp", n_layers=8)
    full = pconfigs.get("rwkv6-1.6b", soi="pp")
    assert (cut.n_layers, cut.soi.first_layer, cut.soi.last_layer) == (8, 2,
                                                                      6)
    assert cut.segments[0].blocks == full.segments[0].blocks
    assert "rwkv6-1.6b" in pconfigs.ARCHS


@functools.lru_cache(maxsize=None)
def _setup(mode):
    jc = dataclasses.replace(JRW.smoke_config(soi=mode), dtype="float32")
    pc = dataclasses.replace(PRW.smoke_config(soi=mode), dtype="float32")
    jparams, _ = split_axes(JT.init(jax.random.PRNGKey(0), jc))
    model = from_jax_params(jax.tree.map(np.asarray, jparams), pc,
                            device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab, (3, 16)).astype(np.int32)
    return jc, pc, jparams, model, tokens


MODES = [None, "pp", "fp"]


@pytest.mark.parametrize("mode", MODES, ids=str)
def test_forward_matches_reference(mode):
    jc, pc, jparams, model, tokens = _setup(mode)
    ref = np.asarray(jax.jit(lambda p, t: JT.forward(p, jc, t))(
        jparams, jnp.asarray(tokens)))
    got = PT.forward(model, pc, torch.from_numpy(tokens)).numpy()
    assert got.shape == ref.shape == (3, 16, jc.vocab)
    assert float(np.max(np.abs(got - ref))) < FWD_ATOL


def _greedy(eng, params, tokens, conv, n_steps=10):
    ds = eng.init_decode_state(params)
    active = []
    for slot, n in ((0, 11), (1, 12)):
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


KW = dict(max_concurrent_decodes=4, max_len=S)


@pytest.mark.parametrize("mode", MODES, ids=str)
def test_engine_matches_reference_engine(mode):
    jc, pc, jparams, model, tokens = _setup(mode)
    ref = _greedy(JEngine(jc, **KW), jparams, tokens, jnp.asarray)
    got = _greedy(SOIEngine(pc, device="cpu", **KW), model, tokens,
                  torch.from_numpy)
    for step, ((rl, rt), (gl, gt)) in enumerate(zip(ref, got)):
        assert gt == rt, (mode, step)
        assert float(np.max(np.abs(gl - rl))) < ATOL, (mode, step)


def test_engine_refusals_match_reference():
    """No attention cache to page, no pad a recurrence may absorb: both
    engines refuse ``paged=True`` and ``prefill_chunk``, and both prefill
    at the exact prompt length whatever the bucket policy."""
    jc, pc, jparams, model, tokens = _setup("pp")
    for make in (lambda **kw: JEngine(jc, **kw),
                 lambda **kw: SOIEngine(pc, device="cpu", **kw)):
        with pytest.raises(ValueError, match="attention caches"):
            make(paged=True, page_size=4, **KW)
        with pytest.raises(ValueError, match="chunked prefill"):
            make(prefill_chunk=4, **KW)
    eng = SOIEngine(pc, device="cpu", **KW)
    assert eng.prefill(model, torch.from_numpy(tokens[0, :7])).length == 7


def test_serve_driver_runs_rwkv_on_cpu():
    argv = ["--arch", "rwkv6-1.6b", "--smoke", "--soi", "pp", "--device",
            "cpu", "--batch", "3", "--prompt-len", "14", "--stagger", "1",
            "--gen-len", "6"]
    seqs = pserve.main(argv)
    assert seqs.shape == (3, 6)
    assert np.array_equal(seqs, pserve.main(argv))
    with pytest.raises(ValueError, match="attention caches"):
        pserve.main(argv + ["--paged", "--page-size", "2"])
