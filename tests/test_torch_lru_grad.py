"""The gradient of ``lru_scan`` on the CPU against the JAX reference:
``LruScanFn`` (the scan's ``torch.autograd.Function``, whose backward is
``lru_scan_bwd``; on the CPU its plain version ``ref.lru_scan_bwd``)
against ``jax.vjp`` of ``repro.kernels.ref.lru_scan`` — the reference's
associative scan differentiated by XLA — for the gradients of a, x and h0
under cotangents of both outputs (h_all and h_last), within 1e-5 of each
one's largest |value|. Shapes: S 1, odd S, D not a multiple of 32, with
and without h0. Also: what the wrapper refuses, and that the CPU launches
no kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import lru_scan as PL
from repro_torch.kernels import ops
from repro_torch.kernels import ref as pref

torch.set_num_threads(1)

TOL = 1e-5

# (B, S, D, with h0)
CASES = {"s1": (2, 1, 64, True), "odd": (3, 37, 64, True),
         "d100": (2, 19, 100, True), "no-h0": (1, 33, 96, False),
         "train": (2, 128, 32, False)}


def _inputs(case, seed=0):
    b, s, d, with_h0 = CASES[case]
    rng = np.random.default_rng(seed)
    # decays in (0, 1) as the RG-LRU makes them
    a = rng.uniform(0.2, 0.999, (b, s, d)).astype(np.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32) if with_h0 else None
    g_all = rng.standard_normal((b, s, d)).astype(np.float32)
    g_last = rng.standard_normal((b, d)).astype(np.float32)
    return a, x, h0, g_all, g_last


def _rel(got, want):
    got = got.detach().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", list(CASES))
def test_lru_scan_fn_matches_jax_vjp(case):
    a, x, h0, g_all, g_last = _inputs(case)
    ins = tuple(jnp.asarray(t) for t in (a, x, h0) if t is not None)

    @jax.jit
    def fwd_vjp(ins, cot):
        out, vjp = jax.vjp(jref.lru_scan, *ins)
        return out, vjp(cot)
    (jh, jlast), want = fwd_vjp(ins, (jnp.asarray(g_all),
                                      jnp.asarray(g_last)))
    leaves = [torch.from_numpy(t).requires_grad_()
              for t in (a, x, h0) if t is not None]
    ops.reset_launch_counts()
    h, last = ops.lru_scan(*leaves)
    assert h.grad_fn is not None and "LruScanFn" in type(h.grad_fn).__name__
    assert _rel(h, jh) < TOL and _rel(last, jlast) < TOL
    got = torch.autograd.grad((h, last), leaves, (torch.from_numpy(g_all),
                                                  torch.from_numpy(g_last)))
    for name, g, w in zip(("a", "x", "h0"), got, want):
        assert _rel(g, w) < TOL, name
    assert ops.launch_counts()["lru_scan"] == 0
    assert ops.launch_counts()["lru_scan_bwd"] == 0


def test_backward_formula_is_the_plain_recurrence():
    """ref.lru_scan_bwd step by step: c_t = g_t + a_{t+1} c_{t+1}, dx = c,
    da_t = c_t h_{t-1}, dh0 = a_0 c_0 — and the wrapper's CPU route is
    that function, bit for bit."""
    a, x, h0, g, _ = _inputs("odd", seed=3)
    ta, tx, th0, tg = map(torch.from_numpy, (a, x, h0, g))
    h, _ = pref.lru_scan(ta, tx, th0)
    da, dx, dh0 = pref.lru_scan_bwd(ta, tg, h, th0)
    c = np.zeros_like(h0)
    an = np.zeros_like(h0)
    hn = h.numpy()
    for t in range(a.shape[1] - 1, -1, -1):
        c = an * c + g[:, t]
        assert np.array_equal(dx[:, t].numpy(), c)
        prev = hn[:, t - 1] if t else h0
        assert np.array_equal(da[:, t].numpy(), c * prev)
        an = a[:, t]
    assert np.array_equal(dh0.numpy(), an * c)
    for got, want in zip(ops.lru_scan_bwd(ta, tg, h, th0), (da, dx, dh0)):
        assert torch.equal(got, want)
    assert pref.lru_scan_bwd(ta, tg, h)[2] is None


def test_grad_takes_float32_only():
    a = torch.rand(1, 4, 32, dtype=torch.bfloat16, requires_grad=True)
    x = torch.rand(1, 4, 32, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="float32 only"):
        ops.lru_scan(a, x)
    with torch.no_grad():               # serving: any dtype, no Function
        h, _ = ops.lru_scan(a, x)
    assert h.grad_fn is None
    with pytest.raises(NotImplementedError, match="float32 only"):
        ops.lru_scan_bwd(a.detach(), x, x)
    assert PL.lru_plan(8, 128, 4096, torch.float32, streams=3) == \
        PL.LruPlan(1024, 8, 128, 16, 3, 8 * 3 * 16 * 384, False)
    assert PL.lru_plan(1, 2040, 4096, torch.float32, streams=3).steps == 80
    assert PL.lru_plan(3, 37, 100, torch.float32, streams=3).edge
