"""The STMC streaming conv of repro_torch against the JAX reference on the
CPU:

  * the plain ``stmc_conv`` (what the wrapper runs for a CPU tensor)
    against the Pallas kernel in interpret mode, at tests/test_kernels.py's
    four shapes (ragged 130 x 129 against the 128 blocks, and bfloat16):
    float32 within 2e-5; bfloat16 within one bfloat16 ulp of the kernel's
    output, compared in float32 (both accumulate in float32 and round once,
    in another summation order);
  * ``stmc_step``, ``stmc_push`` (K 1 included: an empty state) and
    ``stream_scan`` against ``repro.core.stmc``, dilation 1 and 2, within
    2e-5; ``stream_scan`` against the port's own ``causal_conv1d`` within
    2e-5;
  * ``conv_init``'s He-uniform bound and zero bias.

Every input is drawn with numpy from a seed and handed to both sides.
"""

import jax  # noqa: F401  (JAX on the CPU, as conftest.py sets)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stmc as jstmc
from repro.kernels import stmc_conv as JSC
from repro_torch.core import stmc as pstmc
from repro_torch.kernels import ops
from repro_torch.kernels import stmc_conv as PSC

torch.set_num_threads(1)

F32_TOL = 2e-5


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(t):
    return np.asarray(t.detach().float() if torch.is_tensor(t) else t,
                      np.float32)


def _close(got, want, tol=F32_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err < tol, err


@pytest.mark.parametrize("b,k,ci,co,dt", [
    (4, 3, 8, 16, "float32"),
    (130, 3, 64, 129, "float32"),       # ragged against 128 blocks
    (1, 5, 16, 8, "float32"),
    (8, 3, 16, 32, "bfloat16"),
])
def test_plain_stmc_conv_matches_pallas_interpret(b, k, ci, co, dt):
    rng = np.random.default_rng(7)
    win, ker, bias = (_normal(rng, (b, k, ci)), _normal(rng, (k, ci, co)),
                      _normal(rng, (co,)))
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    want = JSC.stmc_conv(jnp.asarray(win, jdt), jnp.asarray(ker, jdt),
                         jnp.asarray(bias, jdt), interpret=True)
    args = [torch.from_numpy(a).to(tdt) for a in (win, ker, bias)]
    n0 = PSC.stmc_conv.launches
    got = ops.stmc_conv(*args)
    assert PSC.stmc_conv.launches == n0      # the CPU takes the plain version
    assert got.dtype == tdt and tuple(got.shape) == (b, co)
    torch.testing.assert_close(got, PSC.plain(*args), rtol=0, atol=0)
    if dt == "float32":
        _close(got, want)
    else:
        g, w = _np(got), _np(want)
        # one bf16 ulp of the reference value: 2^(floor(log2|w|) - 7)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert np.all(np.abs(g - w) <= ulp), float(np.max(np.abs(g - w) / ulp))


def test_plain_stmc_conv_without_bias_is_the_einsum():
    # weights at a conv's scale (fan-in 192): outputs of order 1, where
    # 2e-5 is the float32 summation-order class
    rng = np.random.default_rng(3)
    win = _normal(rng, (3, 3, 64))
    ker = _normal(rng, (3, 64, 129)) * 192 ** -0.5
    want = jnp.einsum("bkc,kcd->bd", win, ker)
    got = PSC.plain(torch.from_numpy(win), torch.from_numpy(ker))
    _close(got, want)


def _conv(rng, k, cin, cout):
    return {"w": _normal(rng, (k, cin, cout)) * (k * cin) ** -0.5,
            "b": _normal(rng, (cout,))}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("k,dilation", [(3, 1), (3, 2), (2, 2), (1, 1)])
def test_stmc_step_and_push_match_reference(k, dilation):
    rng = np.random.default_rng(11)
    b, cin, cout = 2, 5, 7
    p = _conv(rng, k, cin, cout)
    state = _normal(rng, (b, (k - 1) * dilation, cin))
    frame = _normal(rng, (b, cin))
    js, jy = jstmc.stmc_step(jnp.asarray(state), jnp.asarray(frame),
                             jnp.asarray(p["w"]), jnp.asarray(p["b"]),
                             dilation=dilation)
    tp = _t(p)
    ps, py = pstmc.stmc_step(torch.from_numpy(state), torch.from_numpy(frame),
                             tp["w"], tp["b"], dilation=dilation)
    _close(py, jy)
    np.testing.assert_array_equal(_np(ps), np.asarray(js))
    pushed = pstmc.stmc_push(torch.from_numpy(state), torch.from_numpy(frame))
    np.testing.assert_array_equal(
        _np(pushed), np.asarray(jstmc.stmc_push(jnp.asarray(state),
                                                jnp.asarray(frame))))
    if k == 1:                               # an empty ring stays empty
        assert tuple(pushed.shape) == (b, 0, cin)
    window = pstmc.stmc_window(torch.from_numpy(state),
                               torch.from_numpy(frame), dilation=dilation)
    assert window.is_contiguous() and window.shape[1] == k


@pytest.mark.parametrize("k,dilation", [(3, 1), (3, 2), (1, 1)])
def test_stream_scan_matches_reference_and_offline(k, dilation):
    rng = np.random.default_rng(5)
    p = _conv(rng, k, 6, 9)
    x = _normal(rng, (2, 11, 6))
    want = jstmc.stream_scan({n: jnp.asarray(v) for n, v in p.items()},
                             jnp.asarray(x), dilation=dilation)
    tp = _t(p)
    got = pstmc.stream_scan(tp, torch.from_numpy(x), dilation=dilation)
    _close(got, want)
    off = pstmc.causal_conv1d(torch.from_numpy(x), tp["w"], tp["b"],
                              dilation=dilation)
    _close(got, off)


def test_conv_init_he_uniform():
    g = torch.Generator().manual_seed(0)
    p = pstmc.conv_init(g, 3, 40, 50)
    bound = (6.0 / 120) ** 0.5
    assert tuple(p["w"].shape) == (3, 40, 50)
    assert float(p["w"].abs().max()) <= bound
    assert float(p["w"].abs().max()) > 0.9 * bound
    assert not p["b"].any()
    assert "b" not in pstmc.conv_init(g, 3, 4, 5, bias=False)
