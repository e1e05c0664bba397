"""Training the paper's U-Net in the port against the reference on the
CPU, with ``examples/speech_separation.py``'s loss (the mean squared error
of ``apply_offline``'s masked output, eval-mode norms) and optimizer
(global-norm clip 1.0, ``adamw_update(..., lr=2e-3, weight_decay=0.0)``):

  * the loss and the gradient of every parameter against ``jax.value_and
    _grad`` for the STMC baseline, PP S-CC (3,) and FP SS-CC (3,) at a
    narrow width (8 channels in and out, encoder 6/8/10/12), within 1e-5
    of each leaf's largest |value|;
  * three training steps against the jitted reference step (same
    ``speech_mixture`` batches, drawn with numpy): params and losses;
  * ``apply_offline`` under ``torch.no_grad()`` gives the same bits as with
    grad mode on, and no graph.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.soi import SOIConvCfg as JSOI
from repro.data.synthetic import speech_mixture
from repro.models import unet as junet
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import clip_by_global_norm as jclip
from repro_torch.convert import from_jax_unet
from repro_torch.core.soi import SOIConvCfg as PSOI
from repro_torch.models import unet as punet
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm

torch.set_num_threads(1)

TOL = 1e-5
CFG_KW = dict(in_channels=8, out_channels=8, enc_channels=(6, 8, 10, 12))
SOIS = {"baseline": None, "pp3": dict(pairs=(3,)),
        "fp3": dict(pairs=(3,), mode="fp")}


def _cfgs(name):
    kw = SOIS[name]
    return (junet.UNetConfig(soi=None if kw is None else JSOI(**kw),
                             **CFG_KW),
            punet.UNetConfig(soi=None if kw is None else PSOI(**kw),
                             **CFG_KW))


def _np_tree(jcfg, seed=0):
    """(params, norm state) in the reference's layout, numpy leaves, with
    non-trivial norm scales, biases and statistics."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)

    def conv(k, ci, co):
        bound = (6.0 / (k * ci)) ** 0.5
        return {"w": f32(rng.uniform(-bound, bound, (k, ci, co))),
                "b": f32(0.1 * rng.standard_normal(co))}

    enc_io, dec_io = junet._layer_io(jcfg)
    params, nstate = {"enc": [], "dec": [], "up": {}}, {"enc": [], "dec": []}
    for side, io in (("enc", enc_io), ("dec", dec_io)):
        for ci, co in io:
            params[side].append({"conv": conv(jcfg.kernel, ci, co), "norm": {
                "scale": f32(1.0 + 0.1 * rng.standard_normal(co)),
                "bias": f32(0.1 * rng.standard_normal(co))}})
            nstate[side].append({
                "mean": f32(0.1 * rng.standard_normal(co)),
                "var": f32(rng.uniform(0.5, 1.5, co))})
    params["proj"] = conv(1, 2 * jcfg.in_channels, jcfg.out_channels)
    return params, nstate


def _batch(seed, b=4, t=32):
    return speech_mixture(np.random.default_rng(seed), b, t,
                          CFG_KW["in_channels"])


def _jax_loss(jcfg, ns):
    def loss(p, noisy, clean):
        y, _ = junet.apply_offline(p, ns, noisy, jcfg)
        return jnp.mean(jnp.square(y - clean))
    return loss


def _port_loss(model, pcfg, noisy, clean):
    y, _ = punet.apply_offline(model, torch.from_numpy(noisy), pcfg)
    return torch.mean(torch.square(y - torch.from_numpy(clean)))


def _by_name(tree, nstate, pcfg):
    model = from_jax_unet(jax.tree.map(np.asarray, tree), nstate, pcfg,
                          device="cpu")
    return {k: p.detach().numpy() for k, p in model.named_parameters()}


def _rel(got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", list(SOIS))
def test_example_loss_and_grads_match_jax(name):
    jcfg, pcfg = _cfgs(name)
    params, nstate = _np_tree(jcfg)
    noisy, clean = _batch(1)
    jl, jg = jax.value_and_grad(_jax_loss(jcfg, jax.tree.map(jnp.asarray,
                                                             nstate)))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(noisy),
        jnp.asarray(clean))
    model = from_jax_unet(params, nstate, pcfg, device="cpu")
    loss = _port_loss(model, pcfg, noisy, clean)
    loss.backward()
    assert _rel(loss, jl) < TOL
    want = _by_name(jg, nstate, pcfg)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) < TOL, k


@pytest.mark.parametrize("name", ["baseline", "pp3"])
def test_three_training_steps_match_jax(name):
    jcfg, pcfg = _cfgs(name)
    params, nstate = _np_tree(jcfg, seed=2)
    jloss = _jax_loss(jcfg, jax.tree.map(jnp.asarray, nstate))

    @jax.jit
    def jstep(p, o, noisy, clean):
        l, g = jax.value_and_grad(jloss)(p, noisy, clean)
        g, _ = jclip(g, 1.0)
        p, o = jadamw_update(g, o, p, lr=2e-3, weight_decay=0.0)
        return p, o, l

    jp = jax.tree.map(jnp.asarray, params)
    jo = jadamw_init(jp)
    model = from_jax_unet(params, nstate, pcfg, device="cpu")
    named = dict(model.named_parameters())
    opt = adamw_init(named)
    for step in range(3):
        noisy, clean = _batch(10 + step)
        jp, jo, jl = jstep(jp, jo, jnp.asarray(noisy), jnp.asarray(clean))
        loss = _port_loss(model, pcfg, noisy, clean)
        grads = dict(zip(named, torch.autograd.grad(loss,
                                                    list(named.values()))))
        grads, _ = clip_by_global_norm(grads, 1.0)
        adamw_update(grads, opt, named, lr=2e-3, weight_decay=0.0)
        assert _rel(loss, jl) < TOL, step
    # AdamW's first steps move each element by ~lr whatever its gradient's
    # size, so an element whose gradient is ~1e-6 of its leaf's largest
    # may land up to lr apart (float32 sums in another order): held to
    # 1e-5 of each leaf's largest |value| but for 1e-3 of the elements,
    # and everywhere to the 3 x 2e-3 the steps can move an element
    want = _by_name(jp, nstate, pcfg)
    off = total = 0
    for k, w in want.items():
        d = np.abs(named[k].detach().numpy() - w)
        assert float(d.max()) <= 3 * 2e-3, k
        off += int((d > TOL * np.abs(w).max()).sum())
        total += w.size
    assert off <= 1e-3 * total


@pytest.mark.parametrize("train", [False, True])
def test_apply_offline_unchanged_under_no_grad(train):
    _, pcfg = _cfgs("fp3")
    params, nstate = _np_tree(_cfgs("fp3")[0], seed=3)
    model = from_jax_unet(params, nstate, pcfg, device="cpu")
    x = torch.from_numpy(_batch(4)[0])
    y, ns = punet.apply_offline(model, x, pcfg, train=train)
    assert y.requires_grad
    with torch.no_grad():
        y0, ns0 = punet.apply_offline(model, x, pcfg, train=train)
    assert not y0.requires_grad and y0.grad_fn is None
    assert torch.equal(y.detach(), y0)
    for side in ("enc", "dec"):
        for a, b in zip(ns[side], ns0[side]):
            assert torch.equal(a["mean"].detach(), b["mean"])
            assert torch.equal(a["var"].detach(), b["var"])
