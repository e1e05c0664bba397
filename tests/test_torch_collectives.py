"""The port's collectives (``repro_torch.distributed.collectives``) on 4
gloo ranks, spawned once for the file (``_torch_ranks``):

  * ``compressed_psum`` bit for bit its numpy replay on every rank, and
    within 0.05 of the exact sum relative to its largest |value| (the
    reference's bound, ``tests/test_collectives.py``) — (4, 512) x 0.01 as
    the reference draws it, an odd size whose last 256-block pads, and
    bfloat16;
  * ``moe_all_to_all`` equal to the numpy reshuffle of
    ``jax.lax.all_to_all(split_axis=0, concat_axis=1, tiled=True)``;
  * the two autograd Functions of tensor parallelism: ``copy_to_model``
    sums the gradient once, ``reduce_from_model`` the value once (not the
    gradient again);
  * the serving collectives: ``all_gather_dim`` the ranks' shards in rank
    order, ``heads_to_sequence`` a (B, S, Hloc, dh) shard split on heads
    to the rank's S/4 rows of every head, ``exchange_partials`` every
    rank's partials of this rank's heads, in rank order;
  * expert parallelism's Functions: ``gather_from_model``'s forward is
    ``all_gather_dim``, its backward the gradients' sum over the ranks
    and the rank's slice (a reduce-scatter of all-reduce and slice);
    ``reduce_from_data`` over two groups spanning the world sums every
    rank's value, and its backward is the identity.
"""

import numpy as np
import pytest
import torch

import _torch_ranks as R

torch.set_num_threads(1)

WORLD = 4


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "psum": {
            "f32": (rng.standard_normal((WORLD, 512)).astype(np.float32)
                    * np.float32(0.01), "float32"),
            "odd": (rng.standard_normal((WORLD, 3, 101)).astype(np.float32),
                    "float32"),
            "bf16": (rng.standard_normal((WORLD, 4, 96)).astype(np.float32),
                     "bfloat16"),
        },
        # each rank's tokens (E 8, C 3, d 5)
        "a2a": rng.standard_normal((WORLD, 8, 3, 5)).astype(np.float32),
        # each rank's q heads (B 2, Hloc 3, dh 5); prompt K/V (B 2, S 8,
        # Hloc 2, dh 3); partials of all heads (B 2, H 8, dh + 1 = 6)
        "serving": {
            "gather": rng.standard_normal((WORLD, 2, 3, 5)).astype(
                np.float32),
            "h2s": rng.standard_normal((WORLD, 2, 8, 2, 3)).astype(
                np.float32),
            "partials": rng.standard_normal((WORLD, 2, 8, 6)).astype(
                np.float32),
        },
        # router logits of each rank's 2 experts (r 3, tg 2, E/4 2) and
        # the gathered logits' upstream gradient (E 8); the router's
        # statistics (E 8) and theirs
        "ep": {
            "x": rng.standard_normal((WORLD, 3, 2, 2)).astype(np.float32),
            "g": rng.standard_normal((WORLD, 3, 2, 8)).astype(np.float32),
            "s": rng.standard_normal((WORLD, 8)).astype(np.float32),
            "gs": rng.standard_normal((WORLD, 8)).astype(np.float32),
        },
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    inp = _inputs()
    R._save(tmp, "collectives_in.pkl", inp)
    R.spawn(WORLD, "collectives", tmp)
    return inp, [R.load(tmp, f"collectives_out_{r}.pkl")
                 for r in range(WORLD)]


@pytest.mark.parametrize("name", ["f32", "odd", "bf16"])
def test_compressed_psum_is_its_replay_and_close_to_exact(run, name):
    inp, outs = run
    x, dtype = inp["psum"][name]
    if dtype == "bfloat16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    want = R.replay_psum(x)
    if dtype == "bfloat16":
        want = torch.from_numpy(want).to(torch.bfloat16).float().numpy()
    exact = x.astype(np.float64).sum(axis=0)
    for r in range(WORLD):
        got = outs[r][name]
        assert got.shape == x.shape[1:]
        np.testing.assert_array_equal(got, want)
        rel = np.abs(got - exact).max() / (np.abs(exact).max() + 1e-9)
        assert rel < 0.05, (name, rel)


def test_moe_all_to_all_is_the_tiled_reshuffle(run):
    inp, outs = run
    t = inp["a2a"]
    per = t.shape[1] // WORLD
    for r in range(WORLD):
        want = np.concatenate([t[j, r * per:(r + 1) * per]
                               for j in range(WORLD)], axis=1)
        assert outs[r]["a2a"].shape == (per, WORLD * 3, 5)
        np.testing.assert_array_equal(outs[r]["a2a"], want)


def test_model_axis_functions_on_one_rank(tmp_path):
    """Over one rank both Functions are the identity, forward and back; the
    gradient of ``reduce_from_model`` passes unchanged (the all-reduce is
    not repeated in the backward)."""
    import torch.distributed as dist
    from repro_torch.distributed.collectives import (copy_to_model,
                                                     reduce_from_model)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (3, 4)).astype(np.float32)).requires_grad_()
        g = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (3, 4)).astype(np.float32))
        for fn in (copy_to_model, reduce_from_model):
            y = fn(x, dist.group.WORLD)
            assert torch.equal(y, x)
            (gx,) = torch.autograd.grad(y, x, g)
            assert torch.equal(gx, g)
    finally:
        dist.destroy_process_group()


def test_serving_collectives_lay_shards_out_in_rank_order(run):
    inp, outs = run
    x = inp["serving"]
    gather = np.concatenate(list(x["gather"]), axis=1)
    s_loc = x["h2s"].shape[2] // WORLD
    h_loc = x["partials"].shape[2] // WORLD
    for r in range(WORLD):
        np.testing.assert_array_equal(outs[r]["gather"], gather)
        want = np.concatenate([x["h2s"][j, :, r * s_loc:(r + 1) * s_loc]
                               for j in range(WORLD)], axis=2)
        assert outs[r]["h2s"].shape == (2, s_loc, 2 * WORLD, 3)
        np.testing.assert_array_equal(outs[r]["h2s"], want)
        want = np.stack([x["partials"][j, :, r * h_loc:(r + 1) * h_loc]
                         for j in range(WORLD)])
        np.testing.assert_array_equal(outs[r]["partials"], want)


def test_gather_from_model_backward_is_a_reduce_scatter(run):
    inp, outs = run
    x, g = inp["ep"]["x"], inp["ep"]["g"]
    n = x.shape[-1]
    gathered = np.concatenate(list(x), axis=-1)
    summed = g.sum(axis=0)
    for r in range(WORLD):
        np.testing.assert_array_equal(outs[r]["ep_gather"],
                                      outs[r]["ep_all_gather_dim"])
        np.testing.assert_array_equal(outs[r]["ep_gather"], gathered)
        np.testing.assert_allclose(outs[r]["ep_gather_grad"],
                                   summed[..., r * n:(r + 1) * n],
                                   rtol=1e-6, atol=1e-6)
        assert outs[r]["ep_gather_grad"].shape == x.shape[1:]


def test_reduce_from_data_sums_forward_and_passes_the_gradient(run):
    inp, outs = run
    s, gs = inp["ep"]["s"], inp["ep"]["gs"]
    for r in range(WORLD):
        np.testing.assert_allclose(outs[r]["ep_data_sum"], s.sum(axis=0),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(outs[r]["ep_data_sum"],
                                      outs[0]["ep_data_sum"])
        np.testing.assert_array_equal(outs[r]["ep_data_grad"], gs[r])


def test_expert_parallel_functions_on_one_rank(tmp_path):
    """Over one rank both Functions are the identity, forward and back."""
    import torch.distributed as dist
    from repro_torch.distributed.collectives import (gather_from_model,
                                                     reduce_from_data)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (3, 2, 4)).astype(np.float32)).requires_grad_()
        g = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (3, 2, 4)).astype(np.float32))
        for fn in (lambda t: gather_from_model(t, -1, dist.group.WORLD),
                   lambda t: gather_from_model(t, 1, dist.group.WORLD),
                   lambda t: reduce_from_data(t, [dist.group.WORLD]),
                   lambda t: reduce_from_data(t, [])):
            y = fn(x)
            assert torch.equal(y, x)
            (gx,) = torch.autograd.grad(y, x, g)
            assert torch.equal(gx, g)
    finally:
        dist.destroy_process_group()
