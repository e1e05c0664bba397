"""The distributed layer on the card (marker ``gpu``), a world of one rank
over NCCL — one card cannot hold two ranks of a communicator, so the
multi-rank semantics are held on gloo ranks on the CPU
(``test_torch_{collectives,pipeline,sharded_train}.py``):

  * ``compressed_psum`` on CUDA tensors bit for bit its numpy replay
    (float32, an odd size that pads, bfloat16);
  * ``moe_all_to_all`` and a one-stage ``pipeline_apply`` bit for bit
    their input and the sequential stack;
  * qwen3 smoke, SOI pp, bf16 compute over float32 masters: the sharded
    ``make_train_step`` on a (1, 1) mesh bit for bit the plain step over 3
    steps (loss, grad norm, every param and moment), through the
    ``flash_attention`` forward and backward kernels;
  * expert parallelism's ``gather_from_model`` and ``reduce_from_data`` on
    CUDA tensors: forward and backward the identity at world size 1, as
    on the CPU (``tests/test_torch_collectives.py``);
  * olmoe smoke, SOI pp: the sharded train step (bf16 over float32
    masters, its aux loss) and the sharded prefill + serve steps on the
    (1, 1) mesh bit for bit the plain steps, through the flash and decode
    kernels;
  * the MLA and RG-LRU stacks (``chip_smoke.py`` phase 26 (a) and (c) at
    2 and 3 layers, float32, full width: the smoke configs' MLA head dims
    are no kernel instantiation): deepseek-v2 (its dense layer and one MoE
    layer, SOI pp) through the sharded prefill + serve steps, and
    deepseek-v2's MLA stack (2 layers) and recurrentgemma-9b (one
    RG-LRU, RG-LRU, local attention pattern) through the sharded train
    step, on the (1, 1) mesh bit for bit the plain steps, through
    ``flash_attention`` at (192, 128) and its backward, and ``lru_scan``
    and its backward. One full model is on the card at a time;
  * RWKV, the encoder-decoder and the prefix-LM (``chip_smoke.py`` phase
    28 (a), float32, full width): whisper-tiny whole (51865-row vocab,
    1500 encoder frames), paligemma-3b at 1 layer behind 256 patch
    embeddings and rwkv6-1.6b at 2, through the sharded prefill + serve
    steps and the sharded train step on the (1, 1) mesh, bit for bit the
    plain steps, whisper's through ``flash_attention`` (encoder, self and
    cross layers) and its backward and ``decode_attention`` (self and
    cross reads), paligemma's reads through ``decode_attention``.

Without a CUDA device every test here skips (inside the ``world``
fixture). On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_distributed_gpu.py
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import dataclasses
import gc

from repro_torch import configs as pconfigs
from repro_torch.configs import deepseek_v2_236b as PDS
from repro_torch.configs import olmoe_1b_7b as PO
from repro_torch.configs import qwen3_1_7b as PQ
from repro_torch.data.pipeline import ShardedLMPipeline
from repro_torch.distributed.collectives import (compressed_psum,
                                                 gather_from_model,
                                                 moe_all_to_all,
                                                 reduce_from_data)
from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.distributed.sharding import (ShardingRules, gather_params,
                                              gather_tree, shard_params)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch import specs as S
from repro_torch.launch.steps import (local_batch, make_prefill,
                                      make_serve_step, make_train_step)
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with `python -m "
                    "pytest --noconftest -m gpu "
                    "tests/test_torch_distributed_gpu.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    yield dev, make_mesh((1, 1), ("data", "model"))
    dist.destroy_process_group()


def _replay(x: np.ndarray) -> np.ndarray:
    """``compressed_psum`` over one rank in numpy float32."""
    flat = x.reshape(-1).astype(np.float32)
    pad = (-flat.size) % 256
    fp = np.pad(flat, (0, pad)).reshape(-1, 256)
    scale = np.maximum(np.max(np.abs(fp), axis=1, keepdims=True),
                       np.float32(1e-12)) / np.float32(127.0)
    q = np.round(fp / scale).astype(np.int8).astype(np.int32)
    return (q.astype(np.float32) * scale).reshape(-1)[:flat.size].reshape(
        x.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [((512,), torch.float32),
                                         ((3, 101), torch.float32),
                                         ((4, 96), torch.bfloat16)])
def test_compressed_psum_on_nccl_is_its_replay(world, shape, dtype):
    dev, _ = world
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        shape).astype(np.float32)).to(dtype)
    want = torch.from_numpy(_replay(x.float().numpy())).to(dtype)
    got = compressed_psum(x.to(dev), dist.group.WORLD)
    assert got.dtype == dtype and got.is_cuda
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_all_to_all_and_one_stage_pipeline(world):
    dev, _ = world
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.standard_normal((8, 3, 5)).astype(
        np.float32)).to(dev)
    assert torch.equal(moe_all_to_all(tok, dist.group.WORLD), tok)
    w = torch.from_numpy((0.3 * rng.standard_normal((8, 16, 16))).astype(
        np.float32)).to(dev)
    b = torch.from_numpy((0.01 * rng.standard_normal((8, 16))).astype(
        np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((12, 16)).astype(
        np.float32)).to(dev)
    layers = [{"w": w[i], "b": b[i]} for i in range(8)]

    def layer_fn(lp, h):
        return torch.tanh(h @ lp["w"] + lp["b"])

    y = pipeline_apply(dist.group.WORLD, layer_fn, layers, x,
                       microbatches=3)
    # the sequential stack, microbatch by microbatch (the same GEMM shapes)
    want = []
    for h in x.chunk(3):
        for lp in layers:
            h = layer_fn(lp, h)
        want.append(h)
    assert torch.equal(y, torch.cat(want))


@pytest.mark.gpu
def test_sharded_step_is_the_plain_step_bit_for_bit(world):
    dev, mesh = world
    cfg = PQ.smoke_config(soi="pp")
    assert cfg.dtype == "bfloat16"
    pipe = ShardedLMPipeline(global_batch=8, seq_len=32, vocab=cfg.vocab,
                             seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in pipe.batch(i).items()} for i in range(3)]
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=10)

    def init():
        return T.init(cfg, generator=torch.Generator(device=dev)
                      .manual_seed(0), device=dev)

    plain = init()
    popt = adamw_init(dict(plain.named_parameters()))
    pstep = make_train_step(cfg, **kw)
    rules = ShardingRules(data_axes=("data",))
    sharded = shard_params(init(), rules, mesh)
    sopt = adamw_init(dict(sharded.named_parameters()))
    sstep = make_train_step(cfg, rules, mesh, **kw)
    for bt in batches:
        _, _, pm = pstep(plain, popt, bt)
        ops.reset_launch_counts()
        _, _, sm = sstep(sharded, sopt, local_batch(bt, mesh))
        counts = ops.launch_counts()
        for k in pm:
            assert torch.equal(pm[k], sm[k]), k
        # remat recomputes each layer's forward in the backward
        assert counts["flash_attention"] == cfg.n_layers * (
            2 if cfg.remat else 1)
        assert counts["flash_attention_bwd"] == cfg.n_layers
    want = dict(plain.named_parameters())
    for k, v in gather_params(sharded).items():
        assert torch.equal(v, want[k].detach()), k
    for t in ("mu", "nu"):
        for k, v in gather_tree(sopt[t]).items():
            assert torch.equal(v, popt[t][k]), (t, k)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_parallel_functions_on_nccl(world, dtype):
    dev, _ = world
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 2, 8)).astype(
        np.float32)).to(dev, dtype).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((3, 2, 8)).astype(
        np.float32)).to(dev, dtype)
    for fn in (lambda t: gather_from_model(t, -1, dist.group.WORLD),
               lambda t: reduce_from_data(t, [dist.group.WORLD])):
        y = fn(x)
        assert y.is_cuda and torch.equal(y, x)
        (gx,) = torch.autograd.grad(y, x, g)
        assert torch.equal(gx, g)


@pytest.mark.gpu
def test_sharded_moe_steps_are_the_plain_steps_bit_for_bit(world):
    dev, mesh = world
    cfg = PO.smoke_config(soi="pp")
    assert cfg.dtype == "bfloat16"
    pipe = ShardedLMPipeline(global_batch=8, seq_len=32, vocab=cfg.vocab,
                             seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in pipe.batch(i).items()} for i in range(3)]
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=10)
    rules = ShardingRules(data_axes=("data",))

    def init():
        return T.init(cfg, generator=torch.Generator(device=dev)
                      .manual_seed(0), device=dev)

    plain = init()
    popt = adamw_init(dict(plain.named_parameters()))
    pstep = make_train_step(cfg, **kw)
    sharded = shard_params(init(), rules, mesh)
    sopt = adamw_init(dict(sharded.named_parameters()))
    sstep = make_train_step(cfg, rules, mesh, **kw)
    for bt in batches:
        _, _, pm = pstep(plain, popt, bt)
        ops.reset_launch_counts()
        _, _, sm = sstep(sharded, sopt, local_batch(bt, mesh))
        counts = ops.launch_counts()
        for k in pm:
            assert torch.equal(pm[k], sm[k]), k
        assert float(sm["aux"]) > 0
        # remat recomputes each layer's forward in the backward
        assert counts["flash_attention"] == cfg.n_layers * (
            2 if cfg.remat else 1)
        assert counts["flash_attention_bwd"] == cfg.n_layers
    want = dict(plain.named_parameters())
    for k, v in gather_params(sharded).items():
        assert torch.equal(v, want[k].detach()), k
    for t in ("mu", "nu"):
        for k, v in gather_tree(sopt[t]).items():
            assert torch.equal(v, popt[t][k]), (t, k)

    # serving: the models cast to bf16 before the sharded one is sharded
    prompt = batches[0]["tokens"][:4, :12].to(torch.int32)
    runs = []
    for kw in ({}, dict(rules=rules, mesh=mesh)):
        model = T.cast_params(init(), cfg)
        if kw:
            model = shard_params(model, rules, mesh)
        ops.reset_launch_counts()
        logits, state = make_prefill(cfg, max_len=32, **kw)(
            model, {"tokens": prompt})
        step = make_serve_step(cfg, max_len=32, **kw)
        out = [logits]
        for _ in range(8):
            logits, state = step(model, state,
                                 out[-1].argmax(-1).to(torch.int32))
            out.append(logits)
        runs.append((out, S.flatten(state), ops.launch_counts()))
    (pl, ps, pc), (sl, ss, sc) = runs
    assert all(torch.equal(a, b) for a, b in zip(pl, sl))
    assert set(ps) == set(ss) and all(torch.equal(ps[k], ss[k]) for k in ps)
    assert sc == pc and sc["decode_attention"] > 0 and \
        sc["flash_attention"] == cfg.n_layers


def _free():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_sharded_mla_serve_steps_are_the_plain_steps_bit_for_bit(world):
    """deepseek-v2 at full width, 2 layers (dense + one MoE), f32, SOI pp:
    the sharded prefill + 8 serve steps on the (1, 1) mesh give the plain
    steps' logits and state bit for bit, flash_attention at (192, 128) one
    launch a layer."""
    dev, mesh = world
    cfg = dataclasses.replace(PDS.config(soi="pp", n_layers=2),
                              dtype="float32")
    rules = ShardingRules(data_axes=("data",))
    prompt = torch.randint(0, cfg.vocab, (2, 64), generator=torch.Generator()
                           .manual_seed(1), dtype=torch.int32).to(dev)
    runs = []
    for kw in ({}, dict(rules=rules, mesh=mesh)):
        model = T.init(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(0), device=dev)
        if kw:
            model = shard_params(model, rules, mesh)
        ops.reset_launch_counts()
        logits, state = make_prefill(cfg, max_len=96, **kw)(
            model, {"tokens": prompt})
        step = make_serve_step(cfg, max_len=96, **kw)
        out = [logits]
        for _ in range(8):
            logits, state = step(model, state,
                                 out[-1].argmax(-1).to(torch.int32))
            out.append(logits)
        runs.append((out, S.flatten(state), ops.launch_counts()))
        del model, state
        _free()
    (pl, ps, pc), (sl, ss, sc) = runs
    assert all(torch.equal(a, b) for a, b in zip(pl, sl))
    assert set(ps) == set(ss) and all(torch.equal(ps[k], ss[k]) for k in ps)
    assert sc == pc and sc["flash_attention"] == cfg.n_layers
    assert any(k.endswith(".latent") for k in ss)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-v2 MLA stack",
                                  "recurrentgemma-9b"])
def test_sharded_mla_rglru_train_steps_are_the_plain_bit_for_bit(world,
                                                                  arch):
    """Full width, f32, B 2 S 64, 2 steps: the sharded train step on the
    (1, 1) mesh gives the plain step's metrics, params and moments bit
    for bit, through the flash (192, 128) or lru_scan kernels and their
    backwards."""
    dev, mesh = world
    if arch == "recurrentgemma-9b":     # two RG-LRU layers
        cfg = pconfigs.get("recurrentgemma-9b", n_layers=3)
        kernels = ("lru_scan", "lru_scan_bwd")
    else:                               # two MLA layers
        cfg = PDS.mla_dense_config(n_layers=2)
        kernels = ("flash_attention", "flash_attention_bwd")
    cfg = dataclasses.replace(cfg, dtype="float32")
    pipe = ShardedLMPipeline(global_batch=2, seq_len=64, vocab=cfg.vocab,
                             seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in pipe.batch(i).items()} for i in range(2)]
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=10)
    rules = ShardingRules(data_axes=("data",))
    runs = []
    for sharded in (False, True):
        model = T.init(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(0), device=dev)
        if sharded:
            model = shard_params(model, rules, mesh)
            step = make_train_step(cfg, rules, mesh, **kw)
        else:
            step = make_train_step(cfg, **kw)
        opt = adamw_init(dict(model.named_parameters()))
        metrics = []
        for bt in batches:
            ops.reset_launch_counts()
            _, _, m = step(model, opt, local_batch(bt, mesh) if sharded
                           else bt)
            counts = ops.launch_counts()
            # the forward twice a layer: remat recomputes it
            assert counts[kernels[0]] == 2 * (2 if cfg.remat else 1), counts
            assert counts[kernels[1]] == 2, counts
            metrics.append(m)
        # digests: one model's state on the card at a time
        trees = {"params": gather_params(model) if sharded else dict(
            model.named_parameters())}
        trees.update({t: gather_tree(opt[t]) if sharded else opt[t]
                      for t in ("mu", "nu")})
        runs.append(([{k: float(v) for k, v in m.items()} for m in metrics],
                     {t: _digests(tree) for t, tree in trees.items()}))
        del model, opt, step, trees, metrics
        _free()
    (pm, pd), (sm, sd) = runs
    assert pm == sm
    assert pd == sd


# chip_smoke.py phase 28 (a) at full width, float32, depth cut: (config
# kwargs, flash launches a prefill or a forward, decode reads a step)
FAMILIES = {"whisper-tiny": (dict(), 12, 8),
            "paligemma-3b": (dict(n_layers=1), 0, 1),
            "rwkv6-1.6b": (dict(n_layers=2), 0, 0)}


def _family(arch, b, dev):
    """(f32 config of ``FAMILIES``, its stub frontends at batch ``b``:
    whisper's 1500 encoder frames, paligemma's 256 patch embeddings)."""
    cfg = dataclasses.replace(pconfigs.get(arch, **FAMILIES[arch][0]),
                              dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(2)
    stubs = {}
    if cfg.encoder is not None:
        stubs["encoder_frames"] = torch.randn(
            (b, cfg.encoder.n_frames, cfg.encoder.d_model), generator=gen,
            device=dev)
    if cfg.frontend == "patch_stub":
        stubs["patch_embeds"] = torch.randn(
            (b, cfg.frontend_len, cfg.d_model), generator=gen, device=dev)
    return cfg, stubs


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_sharded_family_serve_steps_are_the_plain_steps_bit_for_bit(world,
                                                                     arch):
    """whisper-tiny (4 + 4 layers, 51865-row vocab, 1500 frames),
    paligemma-3b (1 layer) and rwkv6-1.6b (2) at full width, f32: the
    sharded prefill + 4 serve steps on the (1, 1) mesh give the plain
    steps' logits and state bit for bit, through flash_attention (the
    encoder, self and cross layers; paligemma's prefix-LM prefill takes
    the plain route) and decode_attention (self and cross reads)."""
    dev, mesh = world
    cfg, stubs = _family(arch, 2, dev)
    _, n_flash, n_reads = FAMILIES[arch]
    rules = ShardingRules(data_axes=("data",))
    prompt = torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator()
                           .manual_seed(1), dtype=torch.int32).to(dev)
    max_len = 320 if cfg.prefix_lm else 64
    runs = []
    for kw in ({}, dict(rules=rules, mesh=mesh)):
        model = T.init(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(0), device=dev)
        if kw:
            model = shard_params(model, rules, mesh)
        ops.reset_launch_counts()
        logits, state = make_prefill(cfg, max_len=max_len, **kw)(
            model, {"tokens": prompt, **stubs})
        step = make_serve_step(cfg, max_len=max_len, **kw)
        out = [logits]
        for _ in range(4):
            logits, state = step(model, state,
                                 out[-1].argmax(-1).to(torch.int32))
            out.append(logits)
        runs.append((out, S.flatten(state), ops.launch_counts()))
        del model, state
        _free()
    (pl, ps, pc), (sl, ss, sc) = runs
    assert all(torch.equal(a, b) for a, b in zip(pl, sl))
    assert set(ps) == set(ss) and all(torch.equal(ps[k], ss[k]) for k in ps)
    assert sc == pc
    assert sc["flash_attention"] == n_flash
    assert sc["decode_attention"] == 4 * n_reads


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_sharded_family_train_steps_are_the_plain_bit_for_bit(world, arch):
    """The same configs, f32, B 2 S 64 behind their stub frontends, 2
    steps: the sharded train step on the (1, 1) mesh gives the plain
    step's metrics, params and moments bit for bit (whisper through
    flash_attention and its backward on every encoder, self and cross
    layer)."""
    dev, mesh = world
    cfg, stubs = _family(arch, 2, dev)
    n_flash = FAMILIES[arch][1]
    pipe = ShardedLMPipeline(global_batch=2, seq_len=64, vocab=cfg.vocab,
                             seed=0)
    batches = [dict({k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.batch(i).items()}, **stubs)
               for i in range(2)]
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=10)
    rules = ShardingRules(data_axes=("data",))
    runs = []
    for sharded in (False, True):
        model = T.init(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(0), device=dev)
        if sharded:
            model = shard_params(model, rules, mesh)
            step = make_train_step(cfg, rules, mesh, **kw)
        else:
            step = make_train_step(cfg, **kw)
        opt = adamw_init(dict(model.named_parameters()))
        metrics = []
        for bt in batches:
            ops.reset_launch_counts()
            _, _, m = step(model, opt, local_batch(bt, mesh) if sharded
                           else bt)
            counts = ops.launch_counts()
            # the forward twice a layer: remat recomputes it
            assert counts["flash_attention"] == n_flash * (
                2 if cfg.remat else 1), counts
            assert counts["flash_attention_bwd"] == n_flash, counts
            metrics.append(m)
        trees = {"params": gather_params(model) if sharded else dict(
            model.named_parameters())}
        trees.update({t: gather_tree(opt[t]) if sharded else opt[t]
                      for t in ("mu", "nu")})
        runs.append(([{k: float(v) for k, v in m.items()} for m in metrics],
                     {t: _digests(tree) for t, tree in trees.items()}))
        del model, opt, step, trees, metrics
        _free()
    (pm, pd), (sm, sd) = runs
    assert pm == sm
    assert pd == sd


def _digests(tree: dict) -> dict:
    """Per-leaf digest of float32 leaves, exact: the int64 sums of the
    leaf's bits and of its bits times a position pattern (wrapping), as
    ``chip_smoke.py`` takes them."""
    out = {}
    for k, t in tree.items():
        x = t.detach().reshape(-1).view(torch.int32).long()
        w = torch.arange(x.numel(), device=x.device) % 65521 + 1
        out[k] = (int(x.sum()), int((x * w).sum()))
        del x, w
    return out
