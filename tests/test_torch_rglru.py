"""The RG-LRU of repro_torch against the JAX reference on the CPU, float32:

  * the plain ``lru_scan`` against the Pallas kernel in interpret mode
    (the same sequential order: within 1e-6) and against the reference's
    associative scan (another summation order: within 1e-5), with and
    without h0, at S and D that are not block multiples;
  * the RG-LRU block's full-sequence forward (output and the recurrence
    state it hands to decode, S below the conv width included) and its
    decode step, with a per-row commit mask, within 1e-5;
  * prefill then decode equals decode from position 0 (the reference's
    ``test_rglru_prefill_matches_decode_from_zero``), within 3e-4 as there;
  * GeGLU with the tanh GeLU (within 1e-5 on outputs of order 10; the
    GeLU itself within 1e-6), ``embed_scale`` in bfloat16 (exactly) and the
    logits softcap (within 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.recurrentgemma_9b as JRG
from repro.configs.base import MLPCfg, RGLRUCfg
from repro.distributed.sharding import split_axes
from repro.kernels import lru_scan as jls
from repro.kernels import ref as jref
from repro.models import decode as JD
from repro.models import mlp as jmlp
from repro.models import rglru as jrg
from repro.models import transformer as JT
from repro_torch.configs import recurrentgemma_9b as PRG
from repro_torch.convert import from_jax_params
from repro_torch.kernels import ops
from repro_torch.models import decode as PD
from repro_torch.models import mlp as pmlp
from repro_torch.models import rglru as prg
from repro_torch.models import transformer as PT

torch.set_num_threads(1)


def _close(got, want, tol):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err < tol, err


def _lru_inputs(seed, b, s, d, h0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (b, s, d)).astype(np.float32)
    x = (rng.standard_normal((b, s, d)) * np.sqrt(1 - a * a)).astype(
        np.float32)
    return a, x, (rng.standard_normal((b, d)).astype(np.float32)
                  if h0 else None)


@pytest.mark.parametrize("h0", [False, True], ids=["zeros", "h0"])
def test_plain_lru_scan_matches_reference(h0):
    a, x, hi = _lru_inputs(0, 2, 37, 200, h0)
    ja, jx = jnp.asarray(a), jnp.asarray(x)
    jh0 = None if hi is None else jnp.asarray(hi)
    got, last = ops.lru_scan(torch.from_numpy(a), torch.from_numpy(x),
                             None if hi is None else torch.from_numpy(hi))
    assert got.dtype == torch.float32 and torch.equal(last, got[:, -1])
    # ragged blocks: S 37 over blocks of 16, D 200 over blocks of 128
    want, want_last = jls.lru_scan(ja, jx, jh0, block_s=16, block_d=128,
                                   interpret=True)
    _close(got, want, 1e-6)
    _close(last, want_last, 1e-6)
    assoc, _ = jref.lru_scan(ja, jx, jh0)
    _close(got, assoc, 1e-5)


def _rglru_pair(seed, d=64, nh=4):
    cfg = RGLRUCfg(width=d, n_heads=nh, conv_width=4)
    jp, _ = split_axes(jrg.rglru_init(jax.random.PRNGKey(seed), cfg, d))
    rng = np.random.default_rng(seed)
    # nonzero biases, so a swapped or dropped one shows
    jp = dict(jp, conv_b=0.1 * rng.standard_normal(d).astype(np.float32),
              br=0.1 * rng.standard_normal(d).astype(np.float32),
              bi=0.1 * rng.standard_normal(d).astype(np.float32))
    mod = prg.RGLRU(cfg, d, generator=torch.Generator(), device="meta")
    mod.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                         for k, v in jp.items()}, assign=True)
    return cfg, jp, mod


@pytest.mark.parametrize("s", [2, 13])
def test_rglru_forward_matches_reference(s):
    cfg, jp, mod = _rglru_pair(1)
    x = np.random.default_rng(2).standard_normal((2, s, 64)).astype(
        np.float32)
    want, wst = jrg.rglru_forward(jp, cfg, jnp.asarray(x))
    with torch.no_grad():
        got, st = prg.rglru_forward(mod, torch.from_numpy(x))
    _close(got, want, 1e-5)
    assert st["h"].dtype == torch.float32 and st["conv"].shape == (2, 3, 64)
    _close(st["h"], wst["h"], 1e-5)
    _close(st["conv"], wst["conv"], 1e-6)    # zero-padded below S = 3


def test_rglru_decode_matches_reference_and_commits_rows():
    cfg, jp, mod = _rglru_pair(3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    h = rng.standard_normal((3, 64)).astype(np.float32)
    conv = rng.standard_normal((3, 3, 64)).astype(np.float32)
    want, wst = jrg.rglru_decode(jp, cfg, jnp.asarray(x),
                                 {"h": jnp.asarray(h),
                                  "conv": jnp.asarray(conv)})
    state = {"h": torch.from_numpy(h.copy()),
             "conv": torch.from_numpy(conv.copy())}
    commit = torch.tensor([True, False, True])
    with torch.no_grad():
        got = prg.rglru_decode(mod, torch.from_numpy(x), state,
                               commit=commit)
    _close(got, want, 1e-5)
    for name, old in (("h", h), ("conv", conv)):
        new = np.asarray(wst[name])
        _close(state[name][[0, 2]], new[[0, 2]], 1e-5)
        assert np.array_equal(state[name][1].numpy(), old[1])


def test_rglru_prefill_matches_decode_from_zero():
    cfg = dataclasses.replace(PRG.smoke_config(), dtype="float32")
    jc = dataclasses.replace(JRG.smoke_config(), dtype="float32")
    jp, _ = split_axes(JT.init(jax.random.PRNGKey(0), jc))
    model = from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    b, s, p = 2, 12, 6
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (b, s)).astype(np.int32))
    full = PT.forward(model, cfg, tokens)
    s0 = PD.init_decode_state(model, cfg, b, max_len=s)
    for t in range(p):
        _, s0 = PD.decode_step(model, cfg, s0, tokens[:, t])
    lg, sp = PD.prefill(model, cfg, tokens[:, :p], max_len=s)
    _close(lg, full[:, p - 1], 3e-4)
    n_rec = 0
    for c0, cp in zip(s0["segments"], sp["segments"]):
        if "h" in c0:                       # recurrence states
            n_rec += 1
            _close(cp["h"], c0["h"], 2e-4)
            _close(cp["conv"], c0["conv"], 2e-4)
    assert n_rec == 4
    for t in range(p, s):
        l0, s0 = PD.decode_step(model, cfg, s0, tokens[:, t])
        lp, sp = PD.decode_step(model, cfg, sp, tokens[:, t])
        _close(lp, full[:, t], 3e-4)
        _close(lp, l0, 3e-4)
    # and the JAX model's own prefill logits
    jlg, _ = JD.prefill(jp, jc, jnp.asarray(tokens[:, :p].numpy()),
                        max_len=s)
    _close(lg, jlg, 1e-4)


def test_geglu_uses_the_tanh_gelu():
    rng = np.random.default_rng(5)
    mcfg = MLPCfg(kind="geglu", d_ff=48)
    jp = {k: rng.standard_normal(shape).astype(np.float32) * 0.3
          for k, shape in (("up", (32, 48)), ("gate", (32, 48)),
                           ("down", (48, 32)))}
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    want = jmlp.mlp_apply(jp, mcfg, jnp.asarray(x))
    mod = pmlp.MLP(mcfg, 32, generator=torch.Generator(), device="meta")
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in jp.items()},
                        assign=True)
    _close(pmlp.mlp_apply(mod, torch.from_numpy(x)), want, 1e-5)
    # PyTorch's default (erf) GeLU is another function: 1e-4 apart here
    z = torch.linspace(-4, 4, 101)
    _close(pmlp.gelu(z), jax.nn.gelu(jnp.asarray(z.numpy())), 1e-6)
    assert float((torch.nn.functional.gelu(z) - pmlp.gelu(z)).abs().max()
                 ) > 1e-4


def test_embed_scale_and_logits_softcap():
    jc = JRG.smoke_config()                       # bfloat16
    pc = PRG.smoke_config()
    jp, _ = split_axes(JT.init(jax.random.PRNGKey(6), jc))
    model = from_jax_params(jax.tree.map(np.asarray, jp), pc, device="cpu")
    model = PT.cast_params(model, pc)
    tokens = np.random.default_rng(7).integers(0, pc.vocab, (2, 5)).astype(
        np.int32)
    with torch.no_grad():
        got = PT._embed_tokens(model, pc, torch.from_numpy(tokens))
    want = JT._embed_tokens(JT.cast_params(jp, jc), jc, jnp.asarray(tokens))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want, np.float32))
    x = np.random.default_rng(8).standard_normal((3, 64)).astype(np.float32)
    fc = dataclasses.replace(pc, dtype="float32")
    fj = dataclasses.replace(jc, dtype="float32")
    model32 = from_jax_params(jax.tree.map(np.asarray, jp), fc, device="cpu")
    with torch.no_grad():
        lg = PD._logits_one(model32, fc, torch.from_numpy(20 * x))
    _close(lg, JD._logits_one(jp, fj, jnp.asarray(20 * x)), 1e-5)
    assert float(lg.abs().max()) < 30.0          # capped at 30
