"""The port's per-step programs write their state in place — what lets the
card capture each as a CUDA graph (``engine.contracts.CheckedGraph``) —
and still give the JAX package's results, on the CPU:

  * ``SOIEngine.generate`` (qwen3 smoke, float32, SOI pp and fp; dense
    rings, and paged pools with chunked prefill and the prefix cache, the
    rings wrapping onto shared pages so steps copy on write) keeps every
    leaf of the decode state — caches, pools, page maps, clocks, queue,
    conv window, tokens — as the same tensor at the same ``data_ptr`` over
    2 × stride + 3 steps, a late insert included, with greedy tokens equal
    to ``repro.engine.SOIEngine``'s on the same numpy-drawn weights and
    logits within 5e-4;
  * the same over rwkv6-1.6b (SOI pp, dense: its RWKV states) and
    whisper-tiny (dense and paged: its per-slot cross K/V and the cross
    read's position buffers), a freed and re-inserted slot included;
  * the U-Net's phase steppers (tests/test_soi_unet.py's width; none, pp
    (2,), pp (1,3), fp (1,), fp (1,) with the shift at 3, tconv pp (2,))
    keep every leaf of the stream state over two periods plus two frames,
    and the session's frames equal ``repro.engine.session.
    unet_stream_session``'s within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.qwen3_1_7b as Q
import repro.configs.rwkv6_1_6b as JRW
import repro.configs.whisper_tiny as JW
from repro.core.soi import SOIConvCfg as JSOI
from repro.distributed.sharding import split_axes
from repro.engine import SOIEngine as JEngine
from repro.engine.session import unet_stream_session as jsession
from repro.models import transformer as JT
from repro.models import unet as junet
from repro_torch.configs import qwen3_1_7b as PQ
from repro_torch.configs import rwkv6_1_6b as PRW
from repro_torch.configs import whisper_tiny as PW
from repro_torch.convert import from_jax_params, from_jax_unet
from repro_torch.core.soi import SOIConvCfg as PSOI
from repro_torch.engine import SOIEngine
from repro_torch.engine.contracts import state_leaves
from repro_torch.engine.session import unet_stream_session
from repro_torch.models import unet as punet

torch.set_num_threads(1)

S = 16
LOGIT_ATOL = 5e-4       # the reference engine test's own bound
STREAM_ATOL = 1e-4
LAYOUTS = {"dense": dict(max_concurrent_decodes=3, max_len=S),
           "paged-prefix": dict(max_concurrent_decodes=3, max_len=S,
                                paged=True, page_size=4, prefill_chunk=4,
                                prefix_cache=True)}


def _random_params(cfg, seed=0):
    """Reference-shaped parameter tree, every leaf drawn by numpy."""
    shapes, _ = split_axes(jax.eval_shape(
        lambda k: JT.init(k, cfg), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def draw(x):
        if len(x.shape) == 1:
            s = 0.3
        elif x.shape[0] == cfg.vocab:
            s = 1.0
        elif len(x.shape) == 3 and x.shape[-1] == cfg.d_model:
            s = float(np.prod(x.shape[:-1])) ** -0.5
        else:
            s = x.shape[0] ** -0.5
        return (rng.standard_normal(x.shape) * s).astype(np.float32)

    return jax.tree.map(draw, shapes)


def _storage(tree):
    """(path, tensor, data_ptr) of every leaf of a state tree."""
    return [(p, t, t.data_ptr()) for p, t in state_leaves(tree)]


def _same_storage(before, tree, where):
    now = _storage(tree)
    assert [p for p, _, _ in now] == [p for p, _, _ in before], where
    for (path, t0, p0), (_, t1, p1) in zip(before, now):
        assert t1 is t0 and p1 == p0, (where, path)


def _run(eng, params, prompts, conv, n_steps, late_at, ds_check=None):
    """Slots 0 and 1 from the start, slot 2 inserted after ``late_at``
    steps; returns (per-step logits, per-slot tokens)."""
    ds = eng.init_decode_state(params)
    toks = {}

    def insert(ds, slot):
        prefix = eng.prefill(params, conv(prompts[slot]))
        toks[slot] = [int(np.asarray(prefix.first_token)[0])]
        return eng.insert(prefix, ds, slot)

    ds = insert(insert(ds, 0), 1)
    logits = []
    for k in range(n_steps):
        if k == late_at:
            ds = insert(ds, 2)
        ds, res = eng.generate(params, ds)
        if ds_check is not None:
            ds_check(ds, k)
        data = np.asarray(res.convert_to_numpy().data)
        logits.append(np.asarray(res.logits))
        for slot in toks:
            toks[slot].append(int(data[slot, 0]))
    return logits, toks


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mode", ["pp", "fp"])
def test_generate_keeps_every_state_leaf_and_the_reference_tokens(mode,
                                                                  layout):
    jc = dataclasses.replace(Q.smoke_config(soi=mode), dtype="float32")
    pc = dataclasses.replace(PQ.smoke_config(soi=mode), dtype="float32")
    np_params = _random_params(jc)
    model = from_jax_params(np_params, pc, device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab, (3, 12)).astype(np.int32)
    # a shared 8-token prefix: slot 1 hits; 12-token prompts wrap the
    # 16-position rings onto the shared pages within the run
    tokens[1, :8] = tokens[0, :8]
    prompts = [tokens[0, :12], tokens[1, :12], tokens[2, :8]]
    n_steps = 2 * pc.soi.stride + 3
    eng = SOIEngine(pc, device="cpu", **LAYOUTS[layout])
    seen = {}

    def ds_check(ds, k):
        if "storage" not in seen:
            seen["storage"] = _storage(ds)
        _same_storage(seen["storage"], ds, (mode, layout, k))

    got = _run(eng, model, prompts, torch.from_numpy, n_steps, 2, ds_check)
    ref = _run(JEngine(jc, **LAYOUTS[layout]),
               jax.tree.map(jnp.asarray, np_params), prompts, jnp.asarray,
               n_steps, 2)
    assert got[1] == ref[1]
    for k, (a, b) in enumerate(zip(got[0], ref[0])):
        live = [0, 1] + ([2] if k >= 2 else [])
        err = float(np.max(np.abs(a[live] - np.asarray(b)[live])))
        assert err < LOGIT_ATOL, (mode, layout, k, err)
    if layout == "paged-prefix":
        assert eng.prefix_cache_stats["hits"] >= 1
        assert eng.prefix_cache_stats["cow_copies"] > 0


ZOO = {"rwkv6-1.6b-pp": (JRW, PRW, "pp", {}),
       "whisper-tiny": (JW, PW, None, {}),
       "whisper-tiny-paged": (JW, PW, None, dict(paged=True, page_size=4))}


@pytest.mark.parametrize("case", list(ZOO))
def test_new_family_steps_keep_every_state_leaf(case):
    """rwkv6's time- and channel-mix states (pre, middle and post layers)
    and whisper's per-slot cross K/V, frame positions and query clocks:
    every leaf keeps its storage over 7 steps, a late insert and a freed
    and re-inserted slot included, with greedy tokens equal to the JAX
    engine's and logits within 5e-4."""
    jm, pm, mode, kw = ZOO[case]
    jc = dataclasses.replace(jm.smoke_config(soi=mode), dtype="float32")
    pc = dataclasses.replace(pm.smoke_config(soi=mode), dtype="float32")
    np_params = _random_params(jc)
    model = from_jax_params(np_params, pc, device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jc.vocab, (3, 9)).astype(np.int32)
    frames = None
    if jc.encoder is not None:
        frames = (0.1 * rng.standard_normal(
            (3, jc.encoder.n_frames, jc.encoder.d_model))).astype(np.float32)

    def run(eng, params, conv, check):
        ds = eng.init_decode_state(params)

        def prefix(i, n):
            fkw = ({} if frames is None
                   else {"encoder_frames": conv(frames[i:i + 1])})
            return eng.prefill(params, conv(tokens[i, :n]), **fkw)

        ds = eng.insert(prefix(0, 9), ds, 0)
        ds = eng.insert(prefix(1, 6), ds, 1)
        out = []
        for k in range(7):
            if k == 2:
                ds = eng.insert(prefix(2, 7), ds, 2)
            if k == 4:
                ds = eng.free_slot(ds, 1)
                ds = eng.insert(prefix(2, 5), ds, 1)
            ds, res = eng.generate(params, ds)
            if check is not None:
                check(ds, k)
            data = np.asarray(res.convert_to_numpy().data)
            live = [0, 1] + ([2] if k >= 2 else [])
            out.append((np.asarray(res.logits)[live],
                        [int(data[s_, 0]) for s_ in live]))
        return out

    seen = {}

    def check(ds, k):
        if "storage" not in seen:
            seen["storage"] = _storage(ds)
            names = [p for p, _, _ in seen["storage"]]
            want = ("['rwkv_tm']['S']" if jc.encoder is None
                    else "['cross_kv'][1]['v']")
            assert any(want in n for n in names), names
        _same_storage(seen["storage"], ds, (case, k))

    kw = dict(max_concurrent_decodes=3, max_len=16, **kw)
    got = run(SOIEngine(pc, device="cpu", **kw), model, torch.from_numpy,
              check)
    ref = run(JEngine(jc, **kw), jax.tree.map(jnp.asarray, np_params),
              jnp.asarray, None)
    for k, ((gl, gt), (rl, rt)) in enumerate(zip(got, ref)):
        assert gt == rt, (case, k)
        assert float(np.max(np.abs(gl - rl))) < LOGIT_ATOL, (case, k)


UNET_KW = dict(in_channels=8, out_channels=8, enc_channels=(6, 8, 10, 12))
UNET_SOIS = {"none": None, "pp2": dict(pairs=(2,)),
             "pp13": dict(pairs=(1, 3)), "fp1": dict(pairs=(1,), mode="fp"),
             "fp1-shift3": dict(pairs=(1,), mode="fp", shift_pos=3),
             "tconv-pp2": dict(pairs=(2,), extrapolation="tconv")}


def _unet_tree(jcfg, seed):
    """(params, norm_state) in the reference's layout, numpy leaves."""
    rng = np.random.default_rng(seed)

    def conv(k, ci, co):
        bound = (6.0 / (k * ci)) ** 0.5
        return {"w": rng.uniform(-bound, bound, (k, ci, co)).astype(
            np.float32),
            "b": (0.1 * rng.standard_normal(co)).astype(np.float32)}

    enc_io, dec_io = junet._layer_io(jcfg)
    params = {"enc": [], "dec": [], "up": {}}
    nstate = {"enc": [], "dec": []}
    for side, io in (("enc", enc_io), ("dec", dec_io)):
        for ci, co in io:
            params[side].append({"conv": conv(jcfg.kernel, ci, co), "norm": {
                "scale": (1 + 0.1 * rng.standard_normal(co)).astype(
                    np.float32),
                "bias": (0.1 * rng.standard_normal(co)).astype(np.float32)}})
            nstate[side].append({
                "mean": (0.1 * rng.standard_normal(co)).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, co).astype(np.float32)})
    params["proj"] = conv(1, 2 * jcfg.in_channels, jcfg.out_channels)
    if jcfg.soi is not None and jcfg.soi.extrapolation == "tconv":
        ch = [jcfg.in_channels] + list(jcfg.enc_channels)
        for p in jcfg.pairs:
            params["up"][p] = conv(jcfg.soi.stride, ch[p - 1], ch[p - 1])
    return params, nstate


@pytest.mark.parametrize("name", list(UNET_SOIS))
def test_unet_steppers_keep_every_state_leaf(name):
    kw = UNET_SOIS[name]
    jcfg = junet.UNetConfig(soi=None if kw is None else JSOI(**kw),
                            **UNET_KW)
    pcfg = punet.UNetConfig(soi=None if kw is None else PSOI(**kw),
                            **UNET_KW)
    params, nstate = _unet_tree(jcfg, seed=0)
    model = from_jax_unet(params, nstate, pcfg, device="cpu")
    n = 2 * pcfg.period + 2
    x = np.random.default_rng(1).standard_normal((2, n, 8)).astype(
        np.float32)

    # the steppers alone, on their own state
    steppers = punet.make_phase_steppers(pcfg)
    state = punet.init_stream_state(2, pcfg, device="cpu")
    before = _storage(state)
    for t in range(n):
        out, _ = steppers[t % pcfg.period](model, state,
                                           torch.from_numpy(x[:, t]))
        assert out is state
        _same_storage(before, state, (name, t))

    # the session over them, against the reference's session
    sess = unet_stream_session(model, pcfg, batch=2, device="cpu")
    inner = _storage(sess.state["inner"])
    ys = []
    for t in range(n):
        ys.append(sess.push(torch.from_numpy(x[:, t])).numpy())
        _same_storage(inner, sess.state["inner"], (name, "session", t))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jn = jax.tree_util.tree_map(jnp.asarray, nstate)
    js = jsession(jp, jn, jcfg, batch=2)
    want = [np.asarray(js.push(jnp.asarray(x[:, t]))) for t in range(n)]
    err = max(float(np.max(np.abs(a - b))) for a, b in zip(ys, want))
    assert err < STREAM_ATOL, (name, err)
