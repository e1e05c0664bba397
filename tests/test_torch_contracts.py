"""``repro_torch.engine.contracts`` against ``repro.engine.contracts`` on
the CPU:

  * ``sanctioned_drain`` nests and restores (an exception inside too), and
    ``drain_count`` / ``in_sanctioned_drain`` follow the reference's along
    the same call sequence;
  * ``host_get`` drains a tuple in one sanctioned call, to the values the
    reference's gives for the same numpy inputs; ``convert_to_numpy`` of
    an engine step counts one drain;
  * ``CheckedGraph`` on the CPU runs its step eagerly under the donation
    contract: a step that rebinds a state leaf of at least 16 KiB raises
    ``DroppedDonationError`` naming it, one that writes in place passes, a
    rebound small leaf is copied back into its own tensor, and a state
    that comes back with other leaves raises;
  * ``ops.add_launch_counts`` adds a recorded delta once per call (what a
    replay adds on the card) and takes a capture's count back.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.engine.contracts as JC
from repro_torch.configs import qwen3_1_7b as PQ
from repro_torch.engine import SOIEngine
from repro_torch.engine import contracts as PC
from repro_torch.kernels import ops
from repro_torch.models import transformer as T

torch.set_num_threads(1)


def _drain_trace(mod):
    """(in a drain?, drains since the start) along nested and raising
    sanctioned drains."""
    d0 = mod.drain_count()
    out = [(mod.in_sanctioned_drain(), 0)]

    def mark():
        out.append((mod.in_sanctioned_drain(), mod.drain_count() - d0))

    with mod.sanctioned_drain():
        mark()
        with mod.sanctioned_drain():
            mark()
        mark()
    mark()
    with pytest.raises(KeyError):
        with mod.sanctioned_drain():
            mark()
            raise KeyError("inside")
    mark()
    return out


def test_sanctioned_drain_nests_like_the_reference():
    got = _drain_trace(PC)
    assert got == _drain_trace(JC)
    assert got == [(False, 0), (True, 1), (True, 2), (True, 2), (False, 2),
                   (True, 3), (False, 3)]


def test_host_get_drains_a_tuple_in_one_call():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.integers(0, 9, (5,)).astype(np.int32)
    d0 = PC.drain_count()
    got = PC.host_get((torch.from_numpy(a), torch.from_numpy(b), None))
    assert PC.drain_count() - d0 == 1
    assert not PC.in_sanctioned_drain()
    want = JC.host_get((jnp.asarray(a), jnp.asarray(b), None))
    assert len(got) == 3 and got[2] is None and want[2] is None
    for g, w in zip(got[:2], want[:2]):
        assert isinstance(g, np.ndarray)
        np.testing.assert_array_equal(g, np.asarray(w))
    one = PC.host_get(torch.from_numpy(b))
    np.testing.assert_array_equal(one, b)
    assert PC.drain_count() - d0 == 2


def test_convert_to_numpy_counts_one_drain():
    cfg = dataclasses.replace(PQ.smoke_config(soi="pp"), dtype="float32")
    model = T.init(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    eng = SOIEngine(cfg, max_concurrent_decodes=2, max_len=16, device="cpu")
    ds = eng.init_decode_state(model)
    ds = eng.insert(eng.prefill(model, torch.arange(5, dtype=torch.int32)),
                    ds, 0)
    d0 = PC.drain_count()
    for step in range(3):
        ds, res = eng.generate(model, ds)
        out = res.convert_to_numpy()
        assert PC.drain_count() - d0 == step + 1
        assert isinstance(out.data, np.ndarray) and out.data.shape == (2, 3)
        np.testing.assert_array_equal(out.data, res.data.numpy())


def _state():
    """A state tree with one big (64 KiB) and two small leaves."""
    return {"big": torch.zeros(128, 128), "small": {"t": torch.zeros(
        4, dtype=torch.int32)}, "ring": [torch.ones(2, 3)]}


def test_checked_graph_refuses_a_rebound_big_leaf():
    assert _state()["big"].nbytes >= PC.BIG_BYTES

    def rebinds(state, x):
        state["big"] = state["big"] + x
        return state, x

    g = PC.checked_graph(rebinds, state_argnums=(0,))
    with pytest.raises(PC.DroppedDonationError, match=r"\['big'\]"):
        g(_state(), torch.ones(()))


def test_checked_graph_passes_a_step_that_writes_in_place():
    def in_place(state, x):
        state["big"].add_(x)
        state["small"]["t"].add_(1)
        state["ring"][0].mul_(2)
        return state, state["big"].sum()

    g = PC.CheckedGraph(in_place, state_argnums=(0,))
    st = _state()
    ptrs = [t.data_ptr() for t in PC._tensors(st, [])]
    for k in range(3):
        out, total = g(st, torch.full((), 0.5))
        assert out is st
        assert float(total) == pytest.approx(128 * 128 * 0.5 * (k + 1))
    assert [t.data_ptr() for t in PC._tensors(st, [])] == ptrs
    assert st["small"]["t"].tolist() == [3] * 4
    assert g.captures == 0 and g.replays == 0      # the CPU runs eagerly


def test_checked_graph_copies_back_a_rebound_small_leaf():
    def rebinds_clock(state):
        state["small"]["t"] = state["small"]["t"] + 1
        state["ring"] = [state["ring"][0] * 3]
        return (state,)

    g = PC.CheckedGraph(rebinds_clock, state_argnums=0)
    st = _state()
    t0, r0 = st["small"]["t"], st["ring"][0]
    for _ in range(2):
        (out,) = g(st)
    assert out["small"]["t"] is t0 and out["ring"][0] is r0
    assert t0.tolist() == [2] * 4
    assert torch.equal(r0, torch.full((2, 3), 9.0))


def test_checked_graph_refuses_a_state_of_other_leaves():
    def drops_a_leaf(state):
        del state["ring"]
        return (state,)

    g = PC.CheckedGraph(drops_a_leaf, state_argnums=(0,))
    with pytest.raises(PC.DroppedDonationError, match="other leaves"):
        g(_state())
    with pytest.raises(TypeError, match="new state"):
        PC.CheckedGraph(lambda s: s, state_argnums=(0,))(_state())


def test_add_launch_counts_adds_a_recorded_delta_per_replay():
    ops.reset_launch_counts()
    base = ops.launch_counts()
    assert set(base) == {k.__name__ for k in ops.KERNELS}
    delta = {"decode_attention": 3, "stmc_conv": 14}
    for n in range(1, 4):                  # three replays
        ops.add_launch_counts(delta)
        got = ops.launch_counts()
        assert got["decode_attention"] == 3 * n
        assert got["stmc_conv"] == 14 * n
        assert all(v == 0 for k, v in got.items() if k not in delta)
    # a capture's launches taken back
    ops.add_launch_counts({k: -v for k, v in delta.items()})
    assert ops.launch_counts()["stmc_conv"] == 28
    ops.reset_launch_counts()
    assert ops.launch_counts() == base
