"""``lm_stream_session`` on repro_torch, on the CPU, against
``repro.engine.lm_stream_session`` on the same weights (qwen3's and
rwkv6's ``smoke_config`` in float32, weights from the JAX ``init``):

  * pp, fp and no SOI, with a prompt of 12 tokens (prefilled through the
    compressed trunk) and without one: 12 pushes of forced tokens, logits
    within 5e-4 at every push;
  * the session's state keeps every leaf's storage across pushes (the step
    is a ``CheckedGraph`` over state written in place), its clock decides
    the SOI branch, and a registry counts the pushes;
  * the example ``examples/scattered_decode_torch.py --device cpu``.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.qwen3_1_7b as JQ
import repro.configs.rwkv6_1_6b as JRW
from repro.distributed.sharding import split_axes
from repro.engine import lm_stream_session as jsession
from repro.models import transformer as JT
from repro_torch.configs import qwen3_1_7b as PQ
from repro_torch.configs import rwkv6_1_6b as PRW
from repro_torch.convert import from_jax_params
from repro_torch.engine import lm_stream_session
from repro_torch.engine.contracts import state_leaves
from repro_torch.obs import MetricsRegistry

torch.set_num_threads(1)

ATOL = 5e-4
B, P, N = 2, 12, 12
ROOT = Path(__file__).resolve().parents[1]
FAMILIES = {"qwen3": (JQ, PQ), "rwkv6": (JRW, PRW)}


@functools.lru_cache(maxsize=None)
def _setup(arch, mode):
    jm, pm = FAMILIES[arch]
    jc = dataclasses.replace(jm.smoke_config(soi=mode), dtype="float32")
    pc = dataclasses.replace(pm.smoke_config(soi=mode), dtype="float32")
    jparams, _ = split_axes(JT.init(jax.random.PRNGKey(0), jc))
    model = from_jax_params(jax.tree.map(np.asarray, jparams), pc,
                            device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab, (B, P + N)).astype(np.int32)
    return jc, pc, jparams, model, tokens


CASES = [("qwen3", m, p) for m in ("pp", "fp", None) for p in (True, False)]
CASES += [("rwkv6", "pp", True)]


@pytest.mark.parametrize("arch,mode,prompt", CASES,
                         ids=lambda v: str(v))
def test_session_matches_reference_session(arch, mode, prompt):
    jc, pc, jparams, model, tokens = _setup(arch, mode)
    kw = dict(batch=B, max_len=P + N)
    first = P if prompt else 0
    jkw = dict(kw, prompt=jnp.asarray(tokens[:, :P])) if prompt else kw
    pkw = dict(kw, prompt=torch.from_numpy(tokens[:, :P])) if prompt else kw
    ref = jsession(jparams, jc, **jkw)
    reg = MetricsRegistry()
    got = lm_stream_session(model, pc, device="cpu", registry=reg, **pkw)
    leaves = [(p, t.data_ptr()) for p, t in state_leaves(got.state)]
    for i in range(first, first + N):
        rl = np.asarray(ref.push(jnp.asarray(tokens[:, i])))
        gl = got.push(torch.from_numpy(tokens[:, i])).numpy()
        assert gl.shape == (B, jc.vocab)
        err = float(np.max(np.abs(gl - rl)))
        assert err < ATOL, (arch, mode, prompt, i, err)
    assert [(p, t.data_ptr()) for p, t in state_leaves(got.state)] == leaves
    assert got.state["t"].tolist() == [first + N] * B
    assert reg.counter("session.pushes").value == N


def test_example_runs_on_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "scattered_decode_torch", ROOT / "examples" /
        "scattered_decode_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    errs = mod.main(["--device", "cpu", "--mode", "fp"])
    assert max(errs) < 5e-4, errs
    out = capsys.readouterr().out
    assert "StreamSession" in out and "mixed-phase" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(["--mode", "pp"])       # the card is the default
