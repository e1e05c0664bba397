"""SOI's conv primitives and MAC accounting of repro_torch against
``repro.core.soi`` / ``repro.core.complexity`` / ``repro.models.unet`` on
the CPU:

  * ``scc_compress``, ``scc_extrapolate`` (dup and tconv, with and without
    ``out_len``), ``sc_shift`` and ``ss_cc_extrapolate`` within 2e-5 in
    float32 (duplication and the shift move values: exactly);
  * ``region_rates`` and ``phase_schedule`` equal;
  * ``complexity_report`` of the full-width soi-unet-dns config equal to the
    reference's for the paper's Table 1/2 rows of tests/test_soi_unet.py
    (and a few FP rows), its baseline 1807.7 MMAC/s, and the closed form.

Every tensor input is drawn with numpy from a seed and handed to both sides.
"""

import jax  # noqa: F401  (JAX on the CPU, as conftest.py sets)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import soi_unet_dns as JCFG
from repro.core import complexity as jcx
from repro.core import soi as jsoi
from repro.models import unet as junet
from repro_torch.configs import soi_unet_dns as PCFG
from repro_torch.core import complexity as pcx
from repro_torch.core import soi as psoi
from repro_torch.models import unet as punet

torch.set_num_threads(1)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, tol=2e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= tol if tol == 0 else err < tol, err


@pytest.mark.parametrize("t,stride", [(8, 2), (9, 2), (10, 3)])
def test_scc_compress_matches_reference(t, stride):
    rng = np.random.default_rng(1)
    x = _normal(rng, (2, t, 6))
    w = _normal(rng, (stride, 6, 5)) * (stride * 6) ** -0.5
    b = _normal(rng, (5,))
    want = jsoi.scc_compress(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             stride=stride)
    got = psoi.scc_compress(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), stride=stride)
    _close(got, want)


@pytest.mark.parametrize("kind", ["dup", "tconv"])
@pytest.mark.parametrize("out_len", [None, 7, 8])
def test_scc_extrapolate_and_ss_cc_match_reference(kind, out_len):
    rng = np.random.default_rng(2)
    y = _normal(rng, (2, 4, 6))
    kw_j, kw_p = {}, {}
    if kind == "tconv":
        w, b = _normal(rng, (2, 6, 6)), _normal(rng, (6,))
        kw_j = dict(w=jnp.asarray(w), b=jnp.asarray(b))
        kw_p = dict(w=torch.from_numpy(w), b=torch.from_numpy(b))
    want = jsoi.scc_extrapolate(jnp.asarray(y), stride=2, out_len=out_len,
                                **kw_j)
    got = psoi.scc_extrapolate(torch.from_numpy(y), stride=2,
                               out_len=out_len, **kw_p)
    _close(got, want, 0.0 if kind == "dup" else 2e-5)
    want = jsoi.ss_cc_extrapolate(jnp.asarray(y), stride=2, shift=1,
                                  out_len=out_len, **kw_j)
    got = psoi.ss_cc_extrapolate(torch.from_numpy(y), stride=2, shift=1,
                                 out_len=out_len, **kw_p)
    _close(got, want, 0.0 if kind == "dup" else 2e-5)


@pytest.mark.parametrize("shift", [0, 1, 3])
def test_sc_shift_matches_reference(shift):
    x = _normal(np.random.default_rng(3), (2, 6, 4))
    want = jsoi.sc_shift(jnp.asarray(x), shift=shift)
    got = psoi.sc_shift(torch.from_numpy(x), shift=shift)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


SOI_SPACE = [((), "pp", 2), ((1,), "pp", 2), ((3,), "pp", 2),
             ((1, 3), "pp", 2), ((2, 4, 6), "pp", 2), ((2,), "fp", 3),
             ((2, 5), "fp", 2)]


@pytest.mark.parametrize("pairs,mode,stride", SOI_SPACE)
def test_rates_and_phase_schedule_match_reference(pairs, mode, stride):
    jc = jsoi.SOIConvCfg(pairs=pairs, mode=mode, stride=stride)
    pc = psoi.SOIConvCfg(pairs=pairs, mode=mode, stride=stride)
    assert psoi.region_rates(7, 7, pc) == jsoi.region_rates(7, 7, jc)
    assert psoi.phase_schedule(pc, 7) == jsoi.phase_schedule(jc, 7)


def test_soi_conv_cfg_refuses_bad_fields():
    for kw in (dict(mode="xx"), dict(extrapolation="lin"),
               dict(pairs=(3, 1))):
        with pytest.raises(ValueError):
            psoi.SOIConvCfg(**kw)


PAPER_SINGLE = {(1,): 50.1, (2,): 51.4, (3,): 58.1, (4,): 61.5, (5,): 64.8,
                (6,): 71.3, (7,): 83.8}
PAPER_DOUBLE = {(1, 3): 29.1, (1, 6): 35.6, (2, 5): 33.8, (3, 6): 43.8,
                (4, 6): 47.1, (5, 7): 56.7, (6, 7): 63.2}
FP_ROWS = [dict(pairs=(1,), mode="fp"), dict(pairs=(2,), mode="fp"),
           dict(pairs=(2,), mode="fp", shift_pos=5),
           dict(pairs=(2,), mode="fp", shift_pos=7)]


def _report_fields(rep):
    return (rep.macs_per_frame, rep.baseline_macs_per_frame, rep.retain,
            rep.peak_macs_per_frame, rep.on_arrival_macs_per_frame,
            rep.precomputed_fraction, rep.mmacs_per_s,
            rep.baseline_mmacs_per_s, rep.per_layer, rep.as_row())


@pytest.mark.parametrize(
    "kw", [dict(pairs=p) for p in list(PAPER_SINGLE) + list(PAPER_DOUBLE)]
    + FP_ROWS, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_complexity_report_matches_reference(kw):
    want = junet.complexity_report(JCFG.config(jsoi.SOIConvCfg(**kw)))
    got = punet.complexity_report(PCFG.config(psoi.SOIConvCfg(**kw)))
    assert _report_fields(got) == _report_fields(want)
    paper = {**PAPER_SINGLE, **PAPER_DOUBLE}.get(kw["pairs"])
    if "mode" not in kw:
        assert abs(100 * got.retain - paper) < 0.45


def _cost_tuple(lc):
    return (lc.name, lc.macs, lc.enc_pos, lc.dec_pos)


def test_full_config_baseline_and_closed_form():
    cfg = PCFG.config()
    assert cfg.enc_channels == JCFG.FITTED_CHANNELS == PCFG.FITTED_CHANNELS
    assert PCFG.PAPER_BASELINE_MMACS == JCFG.PAPER_BASELINE_MMACS
    rep = punet.complexity_report(cfg)
    assert rep.baseline_macs_per_frame == 28_923_200
    assert round(rep.baseline_mmacs_per_s, 1) == 1807.7
    assert rep.retain == 1.0
    plan = punet.layer_plan(PCFG.config(psoi.SOIConvCfg(pairs=(2, 5))))
    jplan = junet.layer_plan(JCFG.config(jsoi.SOIConvCfg(pairs=(2, 5))))
    assert [_cost_tuple(lc) for lc in plan] == [
        _cost_tuple(lc) for lc in jplan]
    shares = [pcx.region_share(plan, 7, 7, p) for p in range(1, 8)]
    assert shares == [jcx.region_share(jplan, 7, 7, p) for p in range(1, 8)]
    rep = punet.complexity_report(PCFG.config(psoi.SOIConvCfg(pairs=(2, 5))))
    assert abs(rep.retain - pcx.closed_form_retain(shares, (2, 5))) < 1e-9
    assert pcx.closed_form_retain(shares, (2, 5)) == jcx.closed_form_retain(
        shares, (2, 5))
