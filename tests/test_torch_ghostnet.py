"""GhostNet (the paper's acoustic-scene classifier, soi-ghostnet-asc) on
repro_torch, on the CPU, against ``repro.models.ghostnet`` on the same
weights (the JAX ``init`` through ``from_jax_ghostnet``), in float32:

  * the configs (all seven sizes and the smoke config) equal the
    reference's, and the registry serves the architecture;
  * ``apply_offline`` of the smoke config and of sizes I and VII, with SOI
    (the config's pair at block 4; the smoke config's at 2) and without,
    within 1e-5 of the reference's class logits, B 2 x 37 frames (an odd
    length, so the strided block's last window is partial);
  * ``n_params`` and ``complexity_report`` equal the reference's for all
    seven sizes, with and without SOI, computed here (not read from a
    benchmark file).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.soi_ghostnet_asc as JG
from repro.core.soi import SOIConvCfg as JSOI
from repro.models import ghostnet as jgh
from repro_torch import configs as pconfigs
from repro_torch.configs import soi_ghostnet_asc as PG
from repro_torch.convert import from_jax_ghostnet
from repro_torch.core.soi import SOIConvCfg as PSOI
from repro_torch.models import ghostnet as pgh

torch.set_num_threads(1)

ATOL = 1e-5


def _cfgs(size, soi):
    """(reference config, port config) of a size ("smoke" for the smoke
    config); ``soi`` False drops the pairs."""
    if size == "smoke":
        jc, pc = JG.smoke_config(), PG.smoke_config()
    else:
        jc, pc = JG.config(size), PG.config(size)
    if not soi:
        jc, pc = (dataclasses.replace(jc, soi=None),
                  dataclasses.replace(pc, soi=None))
    return jc, pc


def _as_dict(cfg):
    d = dataclasses.asdict(cfg)
    d["soi"] = None if cfg.soi is None else dataclasses.asdict(cfg.soi)
    return d


def test_configs_match_reference():
    assert PG.SIZES == JG.SIZES and PG.SOI_PLACEMENT == JG.SOI_PLACEMENT
    for size in list(JG.SIZES) + ["smoke"]:
        for soi in (True, False):
            jc, pc = _cfgs(size, soi)
            assert _as_dict(pc) == _as_dict(jc)
    assert "soi-ghostnet-asc" in pconfigs.CONV_ARCHS
    assert pconfigs.get("soi-ghostnet-asc") == PG.config()


@pytest.mark.parametrize("soi", [True, False], ids=["soi", "stmc"])
@pytest.mark.parametrize("size", ["smoke", "I", "VII"])
def test_apply_offline_matches_reference(size, soi):
    jc, pc = _cfgs(size, soi)
    jparams = jgh.init(jax.random.PRNGKey(0), jc)
    model = from_jax_ghostnet(jax.tree.map(np.asarray, jparams), pc,
                              device="cpu")
    x = np.random.default_rng(1).standard_normal(
        (2, 37, jc.in_channels)).astype(np.float32)
    ref = np.asarray(jgh.apply_offline(jparams, jnp.asarray(x), jc))
    got = pgh.apply_offline(model, torch.from_numpy(x), pc).numpy()
    assert got.shape == ref.shape == (2, jc.n_classes)
    assert float(np.max(np.abs(got - ref))) < ATOL
    assert sum(p.numel() for p in model.parameters()) == pgh.n_params(pc)


@pytest.mark.parametrize("size", list(JG.SIZES))
def test_accounting_matches_reference(size):
    for soi in (True, False):
        jc, pc = _cfgs(size, soi)
        assert pgh.n_params(pc) == jgh.n_params(jc)
        ref, got = jgh.complexity_report(jc), pgh.complexity_report(pc)
        assert got.as_row() == ref.as_row()
        for field in ("macs_per_frame", "baseline_macs_per_frame", "retain",
                      "peak_macs_per_frame", "on_arrival_macs_per_frame",
                      "precomputed_fraction", "mmacs_per_s",
                      "baseline_mmacs_per_s"):
            assert getattr(got, field) == pytest.approx(getattr(ref, field),
                                                        rel=1e-12), field


def test_soi_pair_config_type():
    """The port's config takes the port's SOIConvCfg."""
    cfg = PG.config("II", soi=PSOI(pairs=(3,)))
    assert cfg.soi.pairs == (3,)
    assert pgh.n_params(cfg) == jgh.n_params(JG.config("II",
                                                       soi=JSOI(pairs=(3,))))
