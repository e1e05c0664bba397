"""repro_torch.optim against repro.optim on the CPU, on the same numpy
inputs: the cosine and WSD schedules (Python steps and 0-d int32 counters),
the global norm and clipping, AdamW over three steps (moments, count,
params; the port updates in place), and int8 compression with error
feedback. Float32 throughout; the bound is a few float32 ULPs of each
value (``np.testing.assert_allclose`` with rtol 4e-7 and an atol at the
scale of the smallest values), since XLA and PyTorch may fuse a multiply
and an add where the other rounds twice."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as J
from repro_torch import optim as P

torch.set_num_threads(1)

RTOL = 4e-7


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 7), "b": (300,), "c": (3, 4, 6), "d": ()}
    return {k: np.asarray(scale * rng.standard_normal(s), np.float32)
            for k, s in shapes.items()}


def _close(got, want, atol=1e-9):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=atol)


@pytest.mark.parametrize("sched", ["cosine", "wsd"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_schedules_match(sched, as_tensor):
    kw = dict(peak_lr=3e-4, warmup=10, total=100)
    jf = getattr(J, f"{sched}_schedule")
    pf = getattr(P, f"{sched}_schedule")
    for step in (0, 1, 5, 9, 10, 11, 50, 89, 90, 99, 100, 150):
        js = jnp.asarray(step, jnp.int32) if as_tensor else step
        ps = torch.tensor(step, dtype=torch.int32) if as_tensor else step
        _close(pf(ps, **kw), jf(js, **kw))


def test_global_norm_and_clip_match():
    g = _tree(0, scale=3.0)
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    pg = {k: torch.from_numpy(v) for k, v in g.items()}
    _close(P.global_norm(pg), J.global_norm(jg))
    for max_norm in (1.0, 1e3):
        jc, jn = J.clip_by_global_norm(jg, max_norm)
        pc, pn = P.clip_by_global_norm(pg, max_norm)
        _close(pn, jn)
        for k in g:
            _close(pc[k], jc[k])


@pytest.mark.parametrize("wd", [0.1, 0.0])
def test_adamw_three_steps_match(wd):
    p0 = _tree(1)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jo, po = J.adamw_init(jp), P.adamw_init(pp)
    assert po["count"].dtype == torch.int32 and po["count"].dim() == 0
    for step in range(3):
        g = _tree(10 + step, scale=0.5)
        lr_j = J.cosine_schedule(jo["count"], peak_lr=1e-2, warmup=2,
                                 total=10)
        lr_p = P.cosine_schedule(po["count"], peak_lr=1e-2, warmup=2,
                                 total=10)
        jp, jo = J.adamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                jo, jp, lr=lr_j, weight_decay=wd)
        ids = {k: id(v) for k, v in pp.items()}
        pp, po = P.adamw_update({k: torch.from_numpy(v) for k, v in
                                 g.items()}, po, pp, lr=lr_p,
                                weight_decay=wd)
        assert {k: id(v) for k, v in pp.items()} == ids   # in place
        assert int(po["count"]) == int(jo["count"]) == step + 1
        for k in p0:
            _close(pp[k], jp[k])
            _close(po["mu"][k], jo["mu"][k])
            _close(po["nu"][k], jo["nu"][k], atol=1e-12)


def test_int8_compression_and_error_feedback_match():
    x = _tree(2, scale=2.0)["b"]
    jq, js = J.compress_int8(jnp.asarray(x))
    pq, ps = P.compress_int8(torch.from_numpy(x))
    assert pq.dtype == torch.int8
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    _close(ps, js)
    _close(P.decompress_int8(pq, ps, x.shape),
           J.decompress_int8(jq, js, x.shape))
    jerr = perr = None
    for step in range(3):
        g = _tree(20 + step)
        jg, jerr = J.compressed_grads({k: jnp.asarray(v) for k, v in
                                       g.items()}, jerr)
        pg, perr = P.compressed_grads({k: torch.from_numpy(v) for k, v in
                                       g.items()}, perr)
        for k in g:
            _close(pg[k], jg[k], atol=1e-7)
            _close(perr[k], jerr[k], atol=1e-7)
