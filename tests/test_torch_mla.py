"""Absorbed-MLA attention of repro_torch against the JAX reference, on the
CPU, at the deepseek-v2 smoke width (4 heads, d_model 64, kv_lora 24,
qk_nope 16, qk_rope 8, v_head 16; with q_lora 32 and without).

  * ``_mla_forward`` (prefill with the latent/rope cache fill),
    ``_mla_chunk`` (a chunk appended to a ring holding an earlier prefill)
    and ``_mla_decode`` on dense rings and on paged pools: outputs and
    caches within 2e-5 of ``repro.models.attention``;
  * the plain ``mla_chunk_attention`` and ``paged_mla_decode_attention``
    against the Pallas kernels in interpret mode, called as
    tests/test_kernels.py calls them, within 2e-5;
  * the plain flash attention with d_v != d_qk against the reference's
    naive attention.

Inputs are drawn with numpy from a seed; weights come from the JAX
``attn_init`` and are copied into the port's ``Attention``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttnCfg as JAttnCfg
from repro.distributed.sharding import split_axes
from repro.kernels import chunk_attention as JCA
from repro.kernels import decode_attention as JDA
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.configs.base import AttnCfg
from repro_torch.kernels import ops
from repro_torch.kernels import ref as pref
from repro_torch.models import attention as pattn

torch.set_num_threads(1)

TOL = 2e-5
D = 64
MLA = dict(kind="mla", n_heads=4, n_kv=4, head_dim=24, kv_lora=24,
           qk_nope=16, qk_rope=8, v_head=16)
Q_LORA = {"q_lora": 32, "no_q_lora": 0}


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert np.isfinite(got).all() and err < tol, err


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _attn(q_lora):
    """(JAX cfg, JAX params, port cfg, port Attention) of one MLA layer."""
    jc = JAttnCfg(**MLA, q_lora=q_lora)
    pc = AttnCfg(**MLA, q_lora=q_lora)
    jp, _ = split_axes(jattn.attn_init(jax.random.PRNGKey(3), jc, D))
    model = pattn.Attention(pc, D, generator=torch.Generator(),
                            device="cpu")
    state = {k: torch.from_numpy(np.array(v["scale"] if isinstance(v, dict)
                                          else v, np.float32))
             for k, v in jp.items()}
    model.load_state_dict(state)
    return jc, jp, pc, model


def _caches(jc, pc, b, s):
    return (jattn.init_cache(jc, b, s, dtype=jnp.float32),
            pattn.init_cache(pc, b, s, torch.float32, "cpu"))


def _close_cache(got: dict, want: dict):
    assert sorted(got) == sorted(want) == ["latent", "pos", "rope"]
    for name in want:
        if name == "pos":
            assert np.array_equal(np.asarray(got[name]),
                                  np.asarray(want[name])), name
        else:
            _close(got[name], want[name])


@pytest.mark.parametrize("q_lora", sorted(Q_LORA))
def test_mla_forward_matches_reference(q_lora):
    jc, jp, pc, model = _attn(Q_LORA[q_lora])
    x = _normal(np.random.default_rng(1), (2, 10, D))
    jfill, pfill = _caches(jc, pc, 2, 16)
    jy, jcache = jattn.attn_forward(jp, jc, jnp.asarray(x),
                                    positions=jnp.arange(10)[None],
                                    fill_cache=jfill, fill_true_length=8)
    py, pcache = pattn.attn_forward(model, torch.from_numpy(x),
                                    positions=torch.arange(10)[None],
                                    fill_cache=pfill, fill_true_length=8)
    _close(py, jy)
    _close_cache(pcache, jcache)


@pytest.mark.parametrize("q_lora", sorted(Q_LORA))
def test_mla_chunk_matches_reference(q_lora):
    """A 4-token chunk at offset 8 (true length 11: one pad row) over an
    8-token prefill, the ring 10 rows long so the chunk wraps it."""
    jc, jp, pc, model = _attn(Q_LORA[q_lora])
    rng = np.random.default_rng(2)
    x0, x1 = _normal(rng, (1, 8, D)), _normal(rng, (1, 4, D))
    jfill, pfill = _caches(jc, pc, 1, 10)
    _, jcache = jattn.attn_forward(jp, jc, jnp.asarray(x0),
                                   positions=jnp.arange(8)[None],
                                   fill_cache=jfill)
    _, pcache = pattn.attn_forward(model, torch.from_numpy(x0),
                                   positions=torch.arange(8)[None],
                                   fill_cache=pfill)
    jy, jcache = jattn.attn_chunk(jp, jc, jnp.asarray(x1), jcache,
                                  jnp.arange(8, 12, dtype=jnp.int32), 11)
    py, pcache = pattn.attn_chunk(model, torch.from_numpy(x1), pcache, 8, 11)
    _close(py, jy)
    _close_cache(pcache, jcache)


@pytest.mark.parametrize("q_lora", sorted(Q_LORA))
def test_mla_decode_dense_matches_reference(q_lora):
    """Per-slot clocks 10 and 7 after prefills of 10 and 7 tokens."""
    jc, jp, pc, model = _attn(Q_LORA[q_lora])
    rng = np.random.default_rng(3)
    x0, x1 = _normal(rng, (2, 10, D)), _normal(rng, (2, D))
    jcache, pcache = _caches(jc, pc, 2, 16)
    for slot, n in ((0, 10), (1, 7)):
        _, jc1 = jattn.attn_forward(
            jp, jc, jnp.asarray(x0[slot:slot + 1, :n]),
            positions=jnp.arange(n)[None],
            fill_cache=jattn.init_cache(jc, 1, 16, dtype=jnp.float32))
        jcache = {k: jcache[k].at[slot].set(jc1[k][0]) for k in jcache}
        _, pc1 = pattn.attn_forward(
            model, torch.from_numpy(x0[slot:slot + 1, :n]),
            positions=torch.arange(n)[None],
            fill_cache=pattn.init_cache(pc, 1, 16, torch.float32, "cpu"))
        for k in pcache:
            pcache[k][slot] = pc1[k][0]
    t = np.array([10, 7], np.int32)
    jy, jcache = jattn.attn_decode(jp, jc, jnp.asarray(x1), jcache,
                                   jnp.asarray(t))
    py, pcache = pattn.attn_decode(model, torch.from_numpy(x1), pcache,
                                   torch.from_numpy(t))
    _close(py, jy)
    _close_cache(pcache, jcache)


def _pools(rng, n_pages, p_sz, lat_d, r, page_map, ts):
    """Random latent/rope pools; slot i's mapped pages hold positions
    0..ts[i]-1 in order, every other row -1 (the null page included)."""
    lat = _normal(rng, (n_pages, p_sz, lat_d))
    rope = _normal(rng, (n_pages, p_sz, r))
    pos = np.full((n_pages, p_sz), -1, np.int32)
    for i, t in enumerate(ts):
        for j, page in enumerate(page_map[i]):
            if page > 0:
                p = j * p_sz + np.arange(p_sz)
                pos[page] = np.where(p < t, p, -1)
    return lat, rope, pos


@pytest.mark.parametrize("q_lora", sorted(Q_LORA))
def test_mla_decode_paged_matches_reference(q_lora):
    """One decode token per slot written and read through shuffled page
    maps (an unbacked entry in slot 1's)."""
    jc, jp, pc, model = _attn(Q_LORA[q_lora])
    rng = np.random.default_rng(4)
    page_map = np.array([[3, 1, 6], [5, 2, 0]], np.int32)
    ts = np.array([17, 9], np.int32)
    lat, rope, pos = _pools(rng, 7, 8, MLA["kv_lora"], MLA["qk_rope"],
                            page_map, ts)
    x = _normal(rng, (2, D))
    jcache = {"latent": jnp.asarray(lat), "rope": jnp.asarray(rope),
              "pos": jnp.asarray(pos)}
    pcache = {"latent": torch.from_numpy(lat.copy()),
              "rope": torch.from_numpy(rope.copy()),
              "pos": torch.from_numpy(pos.copy())}
    jy, jcache = jattn.attn_decode(jp, jc, jnp.asarray(x), jcache,
                                   jnp.asarray(ts),
                                   pages=jnp.asarray(page_map))
    py, pcache = pattn.attn_decode(model, torch.from_numpy(x), pcache,
                                   torch.from_numpy(ts),
                                   pages=torch.from_numpy(page_map))
    _close(py, jy)
    _close_cache(pcache, jcache)


def _ring_positions(b, sk, filled):
    pos = np.broadcast_to(np.arange(sk, dtype=np.int32)[None], (b, sk))
    return np.where(pos < filled, pos, -1).astype(np.int32)


@pytest.mark.parametrize("c,lat_d,r", [(16, 32, 8), (13, 16, 4)])
def test_plain_mla_chunk_attention_matches_kernel(c, lat_d, r):
    rng = np.random.default_rng(5)
    b, h, sk = 2, 4, 48
    ql, qr = _normal(rng, (b, c, h, lat_d)), _normal(rng, (b, c, h, r))
    lat, rp = _normal(rng, (b, sk, lat_d)), _normal(rng, (b, sk, r))
    kp = _ring_positions(b, sk, 40)
    qp = np.broadcast_to(24 + np.arange(c, dtype=np.int32)[None],
                         (b, c)).copy()
    qp[1, -2:] = -1                                   # pad query rows
    args = (ql, qr, lat, rp, qp, kp)
    want = JCA.mla_chunk_attention(*map(jnp.asarray, args), scale=0.125,
                                   block_q=8, block_k=16, interpret=True)
    got = ops.mla_chunk_attention(*map(torch.from_numpy, args), scale=0.125)
    _close(got, want)
    _close(got, jref.mla_chunk_attention(*map(jnp.asarray, args),
                                         scale=0.125))


def test_plain_paged_mla_decode_attention_matches_kernel():
    rng = np.random.default_rng(6)
    b, h, lat_d, r = 2, 4, 32, 8
    page_map = np.array([[1, 2, 0], [3, 4, 5]], np.int32)
    ts = np.array([12, 14], np.int32)
    lat, rope, pos = _pools(rng, 9, 8, lat_d, r, page_map, ts)
    pos[0] = np.arange(8)                      # null-page garbage, masked
    ql, qr = _normal(rng, (b, h, lat_d)), _normal(rng, (b, h, r))
    t = ts - 1
    args = (ql, qr, lat, rope, pos, page_map, t)
    want = JDA.paged_mla_decode_attention(*map(jnp.asarray, args),
                                          scale=0.125, interpret=True)
    got = ops.paged_mla_decode_attention(*map(torch.from_numpy, args),
                                         scale=0.125)
    _close(got, want)
    # bit for bit with the plain dense read of the gathered rows
    view = pattn.paged_view({"latent": torch.from_numpy(lat),
                             "rope": torch.from_numpy(rope),
                             "pos": torch.from_numpy(pos)},
                            torch.from_numpy(page_map))
    dense = ops.mla_decode_attention(
        torch.from_numpy(ql), torch.from_numpy(qr), view["latent"],
        view["rope"], view["pos"], torch.from_numpy(t), scale=0.125)
    assert torch.equal(got, dense)


def test_plain_flash_attention_dv_neq_dqk():
    rng = np.random.default_rng(7)
    b, s, h = 2, 32, 4
    q, k = _normal(rng, (b, s, h, 24)), _normal(rng, (b, s, h, 24))
    v = _normal(rng, (b, s, h, 16))
    want = jref.naive_attention(*map(jnp.asarray, (q, k, v)), causal=True)
    got = pref.flash_attention(*map(torch.from_numpy, (q, k, v)), block_q=8,
                               block_k=8)
    assert got.shape == (b, s, h, 16)
    _close(got, want)
