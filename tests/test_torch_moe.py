"""The MoE layer of repro_torch against ``repro.models.moe.moe_apply`` on
the CPU, at the deepseek-v2 smoke width (d_model 64, 8 routed experts
top-2, d_expert 32, 1 shared expert), float32, within 1e-5 of the output's
scale (``max|Δ| < 1e-5 * max(1, max|y|)``: the reference's init gives the
expert weights a 1/sqrt(n_experts) scale, so outputs reach ~30, where one
float32 ulp is 2e-6 and the two libraries' sums differ by a few):

  * a prefill-sized batch with shared experts (several dispatch groups);
  * a case where the capacity drops tokens (one group of 195 tokens against
    a capacity of 60, on a router that sends most tokens to two experts):
    the dropped set is the reference's;
  * a decode-sized batch (T = B: one token per group);
  * the aux loss.

Weights come from the JAX ``moe_init``; inputs are drawn with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoECfg as JMoECfg
from repro.distributed.sharding import split_axes
from repro.models import moe as jmoe
from repro_torch.configs.base import MoECfg
from repro_torch.models import moe as pmoe

torch.set_num_threads(1)

TOL = 1e-5
D = 64
SMOKE = dict(n_experts=8, top_k=2, d_expert=32, n_shared=1, d_shared=32,
             capacity_factor=1.25, mlp_kind="swiglu")


def _layer(skew=0.0, **over):
    """(JAX cfg, JAX params, port cfg, port MoE); ``skew`` adds a column
    bias to the router so most tokens pick experts 0 and 1."""
    kw = dict(SMOKE, **over)
    jc, pc = JMoECfg(**kw), MoECfg(**kw)
    jp, _ = split_axes(jmoe.moe_init(jax.random.PRNGKey(5), jc, D))
    jp = jax.tree.map(np.asarray, jp)
    jp["router"] = jp["router"].copy()
    jp["router"][:, :2] += skew
    model = pmoe.MoE(pc, D, generator=torch.Generator(), device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in jp.items()})
    return jc, jax.tree.map(jnp.asarray, jp), pc, model


def _run(jc, jp, model, x):
    jy, jaux = jmoe.moe_apply(jp, jc, jnp.asarray(x))
    with torch.no_grad():
        py, paux = pmoe.moe_apply(model, torch.from_numpy(x))
    return np.asarray(jy), float(jaux), py.numpy(), float(paux)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    scale = max(1.0, float(np.max(np.abs(want))))
    assert np.isfinite(got).all() and err < tol * scale, (err, scale)


@pytest.mark.parametrize("shape", [(2, 48, D), (4, D)],
                         ids=["prefill", "decode"])
def test_moe_apply_matches_reference(shape):
    jc, jp, _, model = _layer()
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jy, jaux, py, paux = _run(jc, jp, model, x)
    _close(py, jy)
    assert abs(paux - jaux) < TOL


def test_moe_capacity_drops_tokens_as_the_reference_does():
    """T = 3 * 65 = 195 tokens, coprime to the 32 dispatch groups, so one
    group with cap = int(195 * 2 / 8 * 1.25) = 60, on a router skewed to
    experts 0 and 1: far more than 60 tokens pick them, and the overflow
    drops."""
    jc, jp, _, model = _layer(skew=4.0)
    x = np.random.default_rng(2).standard_normal((3, 65, D)).astype(
        np.float32)
    jy, _, py, _ = _run(jc, jp, model, x)
    _close(py, jy)
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, D)
                          @ model.router.detach(), dim=-1)
    picks = torch.bincount(torch.topk(probs, 2, dim=-1).indices.reshape(-1),
                           minlength=8)
    assert int(picks.max()) > 60


def test_moe_without_shared_experts():
    jc, jp, _, model = _layer(n_shared=0, d_shared=0)
    x = np.random.default_rng(3).standard_normal((2, 16, D)).astype(
        np.float32)
    jy, _, py, _ = _run(jc, jp, model, x)
    _close(py, jy)
