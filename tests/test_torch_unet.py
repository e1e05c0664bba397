"""The streaming U-Net of repro_torch against ``repro.models.unet`` on the
CPU, at tests/test_soi_unet.py's width (8 in/out channels, encoder 6/8/10/
12), B 2, T 16, float32, for the 11 SOI configurations of that file (none;
pp at 1, 2, 4, (1,3), (2,4); fp at 2, 1, 1 with the shift at 3; tconv pp
and fp at 2):

  * ``from_jax_unet`` carries every leaf over exactly (dup: no ``up``;
    tconv: ``up[p]``), and the reference's tree has the shape assumed;
  * ``apply_offline`` within 2e-5 of the reference's, in eval mode for all
    11 and in train mode (the output and the new norm state) for three;
  * the port's ``stream_infer`` within 2e-5 of the reference's (its
    ``lax.switch`` session), and within 3e-5 — tests/test_soi_unet.py's
    bound — of the port's own offline graph;
  * a session pushed frame by frame across two periods equals ``run``;
  * the phase plans' conv counts at full width (7168 / 4608 / 2304 / 4608
    computed convs for 512 frames of the STMC baseline, PP S-CC 3, PP 2x
    S-CC (1,3), FP SS-CC 3), and the entry points' device rule.

Every weight, norm statistic and input is drawn with numpy from a seed and
handed to both sides (the norms get non-trivial scale, bias, mean and var,
so the eval-mode affine is exercised). The reference's results are computed
once per module: each of its stream configs compiles its own program.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.soi import SOIConvCfg as JSOI
from repro.models import unet as junet
from repro_torch import configs as pconfigs
from repro_torch.configs import soi_unet_dns as PCFG
from repro_torch.convert import from_jax_unet
from repro_torch.core.soi import SOIConvCfg as PSOI
from repro_torch.engine.session import unet_stream_session
from repro_torch.models import unet as punet
from repro_torch.obs import MetricsRegistry

torch.set_num_threads(1)

CFG_KW = dict(in_channels=8, out_channels=8, enc_channels=(6, 8, 10, 12))
B, T = 2, 16

SOIS = {
    "none": None,
    "pp1": dict(pairs=(1,)),
    "pp2": dict(pairs=(2,)),
    "pp4": dict(pairs=(4,)),
    "pp13": dict(pairs=(1, 3)),
    "pp24": dict(pairs=(2, 4)),
    "fp2": dict(pairs=(2,), mode="fp"),
    "fp1": dict(pairs=(1,), mode="fp"),
    "fp1-shift3": dict(pairs=(1,), mode="fp", shift_pos=3),
    "tconv-pp2": dict(pairs=(2,), extrapolation="tconv"),
    "tconv-fp2": dict(pairs=(2,), mode="fp", extrapolation="tconv"),
}


def _cfgs(name):
    kw = SOIS[name]
    return (junet.UNetConfig(soi=None if kw is None else JSOI(**kw),
                             **CFG_KW),
            punet.UNetConfig(soi=None if kw is None else PSOI(**kw),
                             **CFG_KW))


def _np_tree(jcfg, seed):
    """(params, norm_state) in the reference's layout, numpy leaves."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def conv(k, ci, co):
        bound = (6.0 / (k * ci)) ** 0.5
        return {"w": rng.uniform(-bound, bound, (k, ci, co)).astype(
            np.float32), "b": normal((co,), 0.1)}

    def layer(ci, co):
        return ({"conv": conv(jcfg.kernel, ci, co),
                 "norm": {"scale": 1.0 + normal((co,), 0.1),
                          "bias": normal((co,), 0.1)}},
                {"mean": normal((co,), 0.1),
                 "var": rng.uniform(0.5, 1.5, (co,)).astype(np.float32)})

    enc_io, dec_io = junet._layer_io(jcfg)
    params = {"enc": [], "dec": [], "up": {}}
    nstate = {"enc": [], "dec": []}
    for side, io in (("enc", enc_io), ("dec", dec_io)):
        for ci, co in io:
            lp, ns = layer(ci, co)
            params[side].append(lp)
            nstate[side].append(ns)
    params["proj"] = conv(1, 2 * jcfg.in_channels, jcfg.out_channels)
    if jcfg.soi is not None and jcfg.soi.extrapolation == "tconv":
        ch = [jcfg.in_channels] + list(jcfg.enc_channels)
        for p in jcfg.pairs:
            params["up"][p] = conv(jcfg.soi.stride, ch[p - 1], ch[p - 1])
    return params, nstate


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def refs():
    """name -> the reference's results on that config's numpy inputs,
    computed on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg, _ = _cfgs(name)
            params, nstate = _np_tree(jcfg, seed=0)
            x = np.random.default_rng(1).standard_normal(
                (B, T, 8)).astype(np.float32)
            jp, jn = _jnp(params), _jnp(nstate)
            y_off, _ = junet.apply_offline(jp, jn, jnp.asarray(x), jcfg)
            y_on = junet.stream_infer(jp, jn, jnp.asarray(x), jcfg)
            cache[name] = dict(params=params, nstate=nstate, x=x,
                               y_off=np.asarray(y_off),
                               y_on=np.asarray(y_on))
        return cache[name]

    return get


def _port(ref, pcfg):
    return from_jax_unet(ref["params"], ref["nstate"], pcfg, device="cpu")


def _err(got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)))


@pytest.mark.parametrize("name", ["pp2", "tconv-pp2"])
def test_from_jax_unet_round_trip(refs, name):
    jcfg, pcfg = _cfgs(name)
    ref = refs(name)
    jparams, jns = junet.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_structure
    assert tree(_jnp(ref["params"])) == tree(jparams)
    assert tree(_jnp(ref["nstate"])) == tree(jns)
    model = _port(ref, pcfg)
    sd = model.state_dict()
    assert sum(1 for k in sd if k.startswith("up.")) == (
        2 if name.startswith("tconv") else 0)
    for side in ("enc", "dec"):
        for i, (lp, ns) in enumerate(zip(ref["params"][side],
                                         ref["nstate"][side])):
            for key, leaf in (("w", lp["conv"]["w"]), ("b", lp["conv"]["b"]),
                              ("scale", lp["norm"]["scale"]),
                              ("bias", lp["norm"]["bias"]),
                              ("mean", ns["mean"]), ("var", ns["var"])):
                np.testing.assert_array_equal(sd[f"{side}.{i}.{key}"].numpy(),
                                              leaf)
    np.testing.assert_array_equal(sd["proj.w"].numpy(),
                                  ref["params"]["proj"]["w"])
    for p, up in ref["params"]["up"].items():
        np.testing.assert_array_equal(sd[f"up.{p}.w"].numpy(), up["w"])
        np.testing.assert_array_equal(sd[f"up.{p}.b"].numpy(), up["b"])


@pytest.mark.parametrize("name", list(SOIS))
def test_apply_offline_matches_jax(refs, name):
    _, pcfg = _cfgs(name)
    ref = refs(name)
    y, ns = punet.apply_offline(_port(ref, pcfg), torch.from_numpy(ref["x"]),
                                pcfg)
    assert _err(y, ref["y_off"]) < 2e-5
    np.testing.assert_array_equal(ns["dec"][0]["var"].numpy(),
                                  ref["nstate"]["dec"][0]["var"])


@pytest.mark.parametrize("name", ["none", "pp13", "tconv-fp2"])
def test_apply_offline_train_matches_jax(refs, name):
    jcfg, pcfg = _cfgs(name)
    ref = refs(name)
    want_y, want_ns = junet.apply_offline(
        _jnp(ref["params"]), _jnp(ref["nstate"]), jnp.asarray(ref["x"]), jcfg,
        train=True)
    model = _port(ref, pcfg)
    y, ns = punet.apply_offline(model, torch.from_numpy(ref["x"]), pcfg,
                                train=True)
    assert _err(y, want_y) < 2e-5
    for side in ("enc", "dec"):
        for got, want in zip(ns[side], want_ns[side]):
            assert _err(got["mean"], want["mean"]) < 2e-5
            assert _err(got["var"], want["var"]) < 2e-5
    # the module's running stats are left as they were
    np.testing.assert_array_equal(model.enc[0].mean.numpy(),
                                  ref["nstate"]["enc"][0]["mean"])


@pytest.mark.parametrize("name", list(SOIS))
def test_stream_infer_matches_jax_and_own_offline(refs, name):
    _, pcfg = _cfgs(name)
    ref = refs(name)
    model = _port(ref, pcfg)
    x = torch.from_numpy(ref["x"])
    y_on = punet.stream_infer(model, x, pcfg)
    assert _err(y_on, ref["y_on"]) < 2e-5
    with torch.no_grad():
        y_off, _ = punet.apply_offline(model, x, pcfg)
    assert _err(y_on, y_off) < 3e-5


@pytest.mark.parametrize("name", ["pp13", "fp1-shift3"])
def test_session_push_equals_run(refs, name):
    _, pcfg = _cfgs(name)
    ref = refs(name)
    model = _port(ref, pcfg)
    x = torch.from_numpy(ref["x"])
    n = 2 * pcfg.period + 1                 # across two periods
    sess = unet_stream_session(model, pcfg, batch=B, device="cpu")
    pushed = torch.stack([sess.push(x[:, t]) for t in range(n)], dim=1)
    assert sess.state["t"] == n
    whole = unet_stream_session(model, pcfg, batch=B, device="cpu").run(
        x[:, :n])
    assert torch.equal(pushed, whole)


@pytest.mark.parametrize("soi,per_phase,total", [
    (None, [14], 7168),
    (dict(pairs=(3,)), [14, 4], 4608),
    (dict(pairs=(1, 3)), [14, 0, 4, 0], 2304),
    (dict(pairs=(3,), mode="fp"), [14, 4], 4608),
])
def test_phase_plans_count_the_full_width_convs(soi, per_phase, total):
    # computed convs a frame: 14 (7 + 7), fewer on the phases SOI skips
    cfg = PCFG.config(None if soi is None else PSOI(**soi))
    got = punet.convs_per_phase(cfg)
    assert got == per_phase
    assert sum(got[t % cfg.period] for t in range(512)) == total


def test_entry_points_default_to_the_card_and_refuse_a_registry():
    _, pcfg = _cfgs("pp2")
    g = torch.Generator().manual_seed(0)
    model = punet.init(pcfg, generator=g, device="cpu")
    assert model.proj.w.device.type == "cpu"
    # a registry counts the pushes; one that already holds
    # ``session.pushes`` as another kind of metric is refused at the first
    # push (the registry's kind check)
    reg = MetricsRegistry()
    frame = torch.zeros((1, pcfg.in_channels))
    unet_stream_session(model, pcfg, device="cpu", registry=reg).push(frame)
    assert reg.as_dict()["session.pushes"] == 1
    clash = MetricsRegistry()
    clash.gauge("session.pushes")
    with pytest.raises(TypeError):
        unet_stream_session(model, pcfg, device="cpu",
                            registry=clash).push(frame)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            punet.init(pcfg, generator=g)
        with pytest.raises(RuntimeError):
            unet_stream_session(model, pcfg)


def test_config_registry_serves_the_unet_and_the_lms():
    soi = PSOI(pairs=(3,))
    cfg = pconfigs.get("soi-unet-dns", soi=soi)
    assert cfg == PCFG.config(soi) and cfg.enc_channels[-1] == 1296
    assert pconfigs.get_smoke("soi-unet-dns").n_enc == 4
    with pytest.raises(ValueError):
        pconfigs.get("soi-unet-dns", n_layers=3)
    assert "soi-unet-dns" not in pconfigs.ARCHS
    assert pconfigs.get("qwen3-1.7b", soi="pp").name
