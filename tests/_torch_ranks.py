"""Spawned gloo worlds for the port's distributed tests (imported by
``tests/test_torch_{collectives,pipeline,sharded_train,sharded_serve,
sharded_moe,sharded_mla_rglru,sharded_fsdp_sp,sharded_families,
train_families}.py``; not a test module itself, and it imports
no JAX, so a spawned rank starts quickly).

``spawn(world, job, tmp_path, **kw)`` starts ``world`` CPU processes with
``torch.multiprocessing`` (one thread each); every rank joins a gloo
process group through a ``FileStore`` in ``tmp_path`` — no fixed port, so
concurrent test workers cannot collide — and runs ``JOBS[job](rank, world,
tmp_path, **kw)``. A job reads its inputs from, and writes its results to,
files in ``tmp_path``; the test compares them with numpy or with the JAX
reference in its own process.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")


def spawn(world: int, job: str, tmp_path, join: bool = True, **kw):
    """Run the job on ``world`` ranks; with ``join=False`` return at once
    with the processes' context for ``wait`` (the caller works meanwhile)."""
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    return mp.spawn(_entry, args=(world, str(tmp_path), job, kw),
                    nprocs=world, join=join)


def wait(ctx) -> None:
    """Join the processes of ``spawn(..., join=False)`` (raising a rank's
    failure, as ``spawn`` does)."""
    while not ctx.join():
        pass


def _entry(rank, world, tmp, job, kw):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, f"store_{job}"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        JOBS[job](rank, world, tmp, **kw)
    finally:
        dist.destroy_process_group()


def _save(tmp, name, obj):
    with open(os.path.join(tmp, name), "wb") as f:
        pickle.dump(obj, f)


def load(tmp, name):
    with open(os.path.join(tmp, name), "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

def _collectives(rank, world, tmp):
    from repro_torch.distributed.collectives import (compressed_psum,
                                                     moe_all_to_all)
    inp = load(tmp, "collectives_in.pkl")
    out = {}
    for name, (x, dtype) in inp["psum"].items():
        t = torch.from_numpy(x[rank]).to(getattr(torch, dtype))
        y = compressed_psum(t, dist.group.WORLD)
        assert y.dtype == t.dtype and y.shape == t.shape
        out[name] = y.float().numpy()
    out["a2a"] = moe_all_to_all(torch.from_numpy(inp["a2a"][rank]),
                                dist.group.WORLD).numpy()
    if "serving" in inp:
        from repro_torch.distributed.collectives import (all_gather_dim,
                                                         exchange_partials,
                                                         heads_to_sequence)
        x = {k: torch.from_numpy(v[rank]) for k, v in inp["serving"].items()}
        out["gather"] = all_gather_dim(x["gather"], 1,
                                       dist.group.WORLD).numpy()
        out["h2s"] = heads_to_sequence(x["h2s"], dist.group.WORLD).numpy()
        out["partials"] = exchange_partials(x["partials"],
                                            dist.group.WORLD).numpy()
    if "ep" in inp:
        out.update(_ep_collectives(rank, world, inp["ep"]))
    _save(tmp, f"collectives_out_{rank}.pkl", out)


def _ep_collectives(rank, world, inp) -> dict:
    """Expert parallelism's Functions, forward and backward on the rank's
    ``x`` and upstream gradient ``g``: ``gather_from_model`` over the
    world along the last dimension (beside ``all_gather_dim`` of the same
    ``x``), ``reduce_from_data`` over two groups that together span the
    world (ranks {0, 1} / {2, 3}, then {0, 2} / {1, 3}: a 2 x 2 mesh's
    data and model axes)."""
    from repro_torch.distributed.collectives import (all_gather_dim,
                                                     gather_from_model,
                                                     reduce_from_data)
    out = {}
    x = torch.from_numpy(inp["x"][rank]).requires_grad_()
    y = gather_from_model(x, -1, dist.group.WORLD)
    (gx,) = torch.autograd.grad(y, x, torch.from_numpy(inp["g"][rank]))
    out["ep_gather"] = y.detach().numpy()
    out["ep_all_gather_dim"] = all_gather_dim(x.detach(), -1,
                                              dist.group.WORLD).numpy()
    out["ep_gather_grad"] = gx.numpy()
    groups = []
    for split in ([[0, 1], [2, 3]], [[0, 2], [1, 3]]):
        for ranks in split:
            g = dist.new_group(ranks)
            if rank in ranks:
                groups.append(g)
    x = torch.from_numpy(inp["s"][rank]).requires_grad_()
    y = reduce_from_data(x, groups)
    (gx,) = torch.autograd.grad(y, x, torch.from_numpy(inp["gs"][rank]))
    out["ep_data_sum"] = y.detach().numpy()
    out["ep_data_grad"] = gx.numpy()
    return out


def _pipeline(rank, world, tmp):
    from repro_torch.distributed.pipeline import pipeline_apply
    inp = load(tmp, "pipeline_in.pkl")
    w, b = torch.from_numpy(inp["w"]), torch.from_numpy(inp["b"])
    per = w.shape[0] // world
    stage = [{"w": w[i], "b": b[i]}
             for i in range(rank * per, (rank + 1) * per)]

    def layer_fn(lp, h):
        return torch.tanh(h @ lp["w"] + lp["b"])

    y = pipeline_apply(None, layer_fn, stage, torch.from_numpy(inp["x"]),
                       microbatches=inp["microbatches"])
    _save(tmp, f"pipeline_out_{rank}.pkl", y.numpy())


def _mesh(meshes: dict, shape, names=("data", "model")):
    """The gloo mesh of ``shape`` over the axes ``names`` (data, model by
    default), one a shape a job."""
    from repro_torch.launch.mesh import make_mesh
    key = (tuple(shape), tuple(names))
    if key not in meshes:
        meshes[key] = make_mesh(shape, names, device_type="cpu")
    return meshes[key]


def _case_layout(meshes: dict, case: dict):
    """(mesh, rules) of a case: its ``names`` (default data, model), the
    data axes all but the model axis, and its ``rules`` flags (fsdp,
    seq_shard)."""
    from repro_torch.distributed.sharding import ShardingRules
    names = tuple(case.get("names", ("data", "model")))
    mesh = _mesh(meshes, case["mesh"], names)
    return mesh, ShardingRules(data_axes=names[:-1],
                               **case.get("rules", {}))


def _train(rank, world, tmp):
    """Every case of ``train_in.pkl`` (``_train_cases``); rank 0 saves
    them with the refusals and the MLA and RG-LRU steps' runs."""
    inp = load(tmp, "train_in.pkl")
    out = {"refused": _refusals(inp["refuse_cfg"], inp["kv3_cfg"],
                                inp["family_cfgs"]),
           "runs": _stack_train_runs(inp["run_cfgs"], inp["run_batch"])}
    out.update(_train_cases(inp["cases"], {}))
    if rank == 0:
        _save(tmp, "train_out.pkl", out)


@contextlib.contextmanager
def _counting(counts: dict, names=("split_seq", "reduce_scatter_dim")):
    """Count the calls of the ``collectives`` functions ``names`` (default
    ``split_seq`` and ``reduce_scatter_dim``) into ``counts`` while
    inside."""
    from repro_torch.distributed import collectives as C
    orig = {k: getattr(C, k) for k in names}

    def counted(k):
        def fn(*args, **kw):
            counts[k] = counts.get(k, 0) + 1
            return orig[k](*args, **kw)
        return fn
    for k in orig:
        setattr(C, k, counted(k))
    try:
        yield counts
    finally:
        for k, fn in orig.items():
            setattr(C, k, fn)


def _train_cases(cases: dict, meshes: dict) -> dict:
    """Each case: the sharded step on its mesh (``_case_layout``) for its
    steps, from the reference-layout numpy weights; the gathered params
    and moments and the metrics of every step, and with ``bytes`` every
    rank's ``_state_bytes`` after the steps; with ``gathers`` the first
    step's ``all_gather_dim`` calls are counted beside the sequence
    collectives."""
    from repro_torch.convert import from_jax_params
    from repro_torch.distributed.sharding import (gather_params, gather_tree,
                                                  shard_params)
    from repro_torch.launch.steps import local_batch, make_train_step
    from repro_torch.optim import adamw_init
    out = {}
    for name, case in cases.items():
        cfg = case["cfg"]
        mesh, rules = _case_layout(meshes, case)
        model = shard_params(from_jax_params(case["params"], cfg,
                                             device="cpu"), rules, mesh)
        opt = adamw_init(dict(model.named_parameters()))
        step = make_train_step(cfg, rules, mesh, **case["step_kw"])
        batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
        mine = local_batch(batch, mesh, case["step_kw"]["microbatches"])
        metrics, counts = [], {}
        names = ("split_seq", "reduce_scatter_dim") + (
            ("all_gather_dim",) if case.get("gathers") else ())
        for i in range(case["steps"]):
            with _counting(counts if i == 0 else {}, names):
                model, opt, m = step(model, opt, mine)
            metrics.append({k: float(v) for k, v in m.items()})
        got = {"metrics": metrics, "count": int(opt["count"]),
               "seq_calls": counts,
               "params": {k: v.numpy()
                          for k, v in gather_params(model).items()}}
        for t in ("mu", "nu"):
            got[t] = {k: v.numpy() for k, v in gather_tree(opt[t]).items()}
        if "err" in opt:
            got["err"] = {k: v.numpy() for k, v in opt["err"].items()}
        if case.get("bytes"):
            got["bytes"] = [None] * dist.get_world_size()
            dist.all_gather_object(got["bytes"],
                                   _state_bytes(model, opt, mesh))
        out[name] = got
    return out


def _state_bytes(model, opt, mesh) -> dict:
    """This rank's bytes of the parameter shards and of the moments'
    (``count`` included), and the leaves whose shard is not
    1/``shard_factor`` of the whole, by their placements."""
    from torch.distributed.tensor import Shard

    def nbytes(t):
        return t.numel() * t.element_size()
    bad, moments = [], nbytes(opt["count"])
    params = 0
    for k, p in model.named_parameters():
        split = math.prod(mesh.size(i) for i, pl in enumerate(p.placements)
                          if isinstance(pl, Shard))
        params += nbytes(p.to_local())
        for t in (p, opt["mu"][k], opt["nu"][k]):
            if t.to_local().numel() * split != t.numel():
                bad.append(k)
        moments += nbytes(opt["mu"][k].to_local()) + \
            nbytes(opt["nu"][k].to_local())
    return {"params": params, "moments": moments, "bad": sorted(set(bad))}


def _gather_leaf(x, spec, mesh, shape):
    """The global tensor of a rank's shard ``x`` laid out by ``spec``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import placements
    return DTensor.from_local(x.contiguous(), mesh, placements(spec, mesh),
                              shape=shape,
                              stride=torch.empty(shape).stride()
                              ).full_tensor()


def _serve(rank, world, tmp):
    """Every case of ``serve_in.pkl`` (``_serve_cases``); rank 0 saves
    them with the refusals and the MLA and RG-LRU steps' runs."""
    inp = load(tmp, "serve_in.pkl")
    out = {}
    if "refuse_cfgs" in inp:
        out["refused"] = _serve_refusals(inp["refuse_cfgs"],
                                         inp["max_len_cfg"])
        out["runs"] = _stack_serve_runs(inp["run_cfgs"], inp["run_tokens"])
    out.update(_serve_cases(inp["cases"], {}, rank, world))
    if rank == 0:
        _save(tmp, "serve_out.pkl", out)


def _serve_cases(cases: dict, meshes: dict, rank, world) -> dict:
    """Each case on its mesh: ``make_prefill`` on the batch (its tokens and
    the case's ``stubs``, patch embeddings or encoder frames), the clocks
    staggered, then ``make_serve_step`` greedy for its steps, from the
    reference-layout numpy weights. Each step's logits and the final state
    are gathered (the shards' specs from ``decode_state_specs`` of the
    global state, an encoder-decoder's cross K/V included), with every
    rank's leaf shapes and bytes against the specs' local shapes and
    ``per_device_bytes``."""
    from repro_torch.convert import from_jax_params
    from repro_torch.distributed.sharding import (axes_size,
                                                  per_device_bytes,
                                                  shard_params)
    from repro_torch.launch import specs as S
    from repro_torch.launch.steps import make_prefill, make_serve_step
    from repro_torch.models import decode as D
    out = {}
    for name, case in cases.items():
        cfg, ml = case["cfg"], case["max_len"]
        mesh, rules = _case_layout(meshes, case)
        full = from_jax_params(case["params"], cfg, device="cpu")
        tokens = torch.from_numpy(case["tokens"])
        b = tokens.shape[0]
        batch = {"tokens": tokens, **{k: torch.from_numpy(v) for k, v in
                                      case.get("stubs", {}).items()}}
        enc = (None if cfg.encoder is None else
               torch.zeros((b, cfg.encoder.n_frames, cfg.d_model)))
        want = S.flatten(D.init_decode_state(full, cfg, b, ml, enc_out=enc))
        specs = S.decode_state_specs(want, rules, mesh)
        model = shard_params(full, rules, mesh)
        prefill = make_prefill(cfg, rules, mesh, max_len=ml)
        step = make_serve_step(cfg, rules, mesh, max_len=ml)
        data = tuple(rules.data_axes)
        rows_split = b % axes_size(mesh, data) == 0
        row_spec = ((data if len(data) > 1 else data[0])
                    if rows_split else None, None)

        def gathered(logits):
            return _gather_leaf(logits, row_spec, mesh,
                                (b, logits.shape[1]))

        with _counting({}) as counts:
            logits, state = prefill(model, batch)
        state["t"].sub_(torch.from_numpy(case["stagger"]))
        steps = [gathered(logits).numpy()]
        toks = []
        for _ in range(case["steps"]):
            tok = torch.from_numpy(steps[-1]).argmax(-1).to(torch.int32)
            toks.append(tok.numpy())
            logits, state = step(model, state, tok)
            steps.append(gathered(logits).numpy())
        mine = S.flatten(state)
        assert set(mine) == set(want), sorted(set(mine) ^ set(want))
        local_shapes = {}
        for k, w in want.items():
            local_shapes[k] = tuple(
                d if e is None else d // axes_size(mesh, e)
                for d, e in zip(w.shape, specs[k]))
        got = {"logits": steps, "tokens": toks, "seq_calls": counts,
               "shapes_ok": {k: tuple(v.shape) == local_shapes[k]
                             for k, v in mine.items()},
               "dtypes_ok": all(mine[k].dtype == want[k].dtype
                                for k in want),
               "bytes": sum(v.numel() * v.element_size()
                            for v in mine.values()),
               "per_device_bytes": per_device_bytes(want, specs, mesh),
               "split": sorted(k for k, e in specs.items()
                               if "model" in e),
               "state": {k: _gather_leaf(v, specs[k], mesh,
                                         tuple(want[k].shape)).numpy()
                         for k, v in mine.items()}}
        out[name] = {"rank": rank, **got} if rank else got
        ranks = [None] * world
        dist.all_gather_object(ranks, {k: got[k] for k in (
            "shapes_ok", "dtypes_ok", "bytes", "per_device_bytes")})
        out[name]["ranks"] = ranks
    return out


def _serve_refusals(cfgs, max_len_cfg) -> dict:
    """What the serving steps raise for each of ``cfgs`` on a mesh of the
    world's ranks over the model axis (None where they build), and a
    serve step of ``max_len_cfg`` there without ``max_len``."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_prefill, make_serve_step
    world = dist.get_world_size()
    mesh = make_mesh((1, world), ("data", "model"), device_type="cpu")
    rules = ShardingRules(data_axes=("data",))
    out = {}
    for name, cfg in cfgs.items():
        for what, fn in (("serve", make_serve_step), ("prefill",
                                                      make_prefill)):
            try:
                fn(cfg, rules, mesh, max_len=32)
                out[f"{name} {what}"] = None
            except NotImplementedError as e:
                out[f"{name} {what}"] = str(e)
    try:
        make_serve_step(max_len_cfg, rules, mesh)
        out["qwen3 no max_len"] = None
    except ValueError as e:
        out["qwen3 no max_len"] = str(e)
    return out


def _stack_serve_runs(cfgs: dict, tokens) -> dict:
    """Each config (an MLA and an RG-LRU stack) from seed-0 weights on a
    (1, world) mesh: ``make_prefill`` + two greedy ``make_serve_step``
    steps, sharded and plain in this rank; (tokens equal, max |logit
    difference|)."""
    from repro_torch.distributed.sharding import ShardingRules, shard_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_prefill, make_serve_step
    from repro_torch.models import transformer as T
    mesh = make_mesh((1, dist.get_world_size()), ("data", "model"),
                     device_type="cpu")
    rules = ShardingRules(data_axes=("data",))
    batch = {"tokens": torch.from_numpy(tokens)}
    out = {}
    for name, cfg in cfgs.items():
        runs = []
        for kw in ({}, dict(rules=rules, mesh=mesh)):
            model = T.init(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
            if kw:
                model = shard_params(model, rules, mesh)
            logits, state = make_prefill(cfg, max_len=32, **kw)(model, batch)
            step = make_serve_step(cfg, max_len=32, **kw)
            seen, toks = [logits], []
            for _ in range(2):
                toks.append(seen[-1].argmax(-1).to(torch.int32))
                logits, state = step(model, state, toks[-1])
                seen.append(logits)
            runs.append((seen, toks))
        (pl, pt), (sl, st) = runs
        out[name] = (all(torch.equal(a, b) for a, b in zip(pt, st)),
                     max(float((a - b).abs().max()) for a, b in zip(pl, sl)))
    return out


def _stack_train_runs(cfgs: dict, batch) -> dict:
    """Each config (an MLA and an RG-LRU stack) from seed-0 weights on a
    2 x 2 mesh: one sharded train step against the plain step in this
    rank; {metric: (sharded, plain)}."""
    from repro_torch.distributed.sharding import ShardingRules, shard_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import local_batch, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    rules = ShardingRules(data_axes=("data",))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for name, cfg in cfgs.items():
        got = []
        for kw in ({}, dict(rules=rules, mesh=mesh)):
            model = T.init(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
            if kw:
                model = shard_params(model, rules, mesh)
            opt = adamw_init(dict(model.named_parameters()))
            _, _, m = make_train_step(cfg, **kw)(
                model, opt, local_batch(batch, mesh) if kw else batch)
            got.append({k: float(v) for k, v in m.items()})
        out[name] = {k: (got[1][k], got[0][k]) for k in got[0]}
    return out


def _refusals(cfg, kv3, families) -> dict:
    """What the sharded steps raise, on a 2 x 2 mesh and a 1 x 4 one, for
    what they do not run: compression on a split model axis and with fsdp
    over 2 data ranks, and — training and serving — ``kv3``'s 3 kv heads
    on 1 x 4 (a model axis that neither divides them nor is divided by
    them) and ``families["whisper-tiny"]``'s 6 heads there; None where a
    step builds: fsdp and seq_shard, and every step of each config of
    ``families`` on 2 x 2."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (make_prefill, make_serve_step,
                                          make_train_step)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    wide = make_mesh((1, 4), ("data", "model"), device_type="cpu")
    rules = ShardingRules(data_axes=("data",))
    fsdp = ShardingRules(data_axes=("data",), fsdp=True)
    seq = ShardingRules(data_axes=("data",), seq_shard=True)
    tries = {
        "fsdp": lambda: make_train_step(cfg, fsdp, mesh),
        "seq_shard": lambda: make_train_step(cfg, seq, mesh),
        "serve fsdp seq_shard": lambda: make_serve_step(
            cfg, ShardingRules(data_axes=("data",), fsdp=True,
                               seq_shard=True), mesh, max_len=32),
        "prefill seq_shard": lambda: make_prefill(cfg, seq, mesh),
        "compress": lambda: make_train_step(cfg, rules, mesh, compress=True),
        "compress fsdp": lambda: make_train_step(cfg, fsdp, mesh,
                                                 compress=True),
        "kv_heads": lambda: make_train_step(kv3, rules, wide),
        "serve kv_heads": lambda: make_serve_step(kv3, rules, wide,
                                                  max_len=32),
        "prefill kv_heads": lambda: make_prefill(kv3, rules, wide),
        "heads": lambda: make_train_step(families["whisper-tiny"], rules,
                                         wide),
    }
    for name, fam in families.items():
        tries.update({
            f"{name} train": functools.partial(make_train_step, fam, rules,
                                               mesh),
            f"{name} prefill": functools.partial(make_prefill, fam, rules,
                                                 mesh),
            f"{name} serve": functools.partial(make_serve_step, fam, rules,
                                               mesh, max_len=32)})
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def _mesh_cases(inp: dict, rank, world) -> dict:
    """The serving and training cases of ``inp`` (``_serve_cases``,
    ``_train_cases``) and every rank's parameter-shard bytes of each
    (config, mesh) of ``inp["bytes"]`` against ``per_device_bytes`` of
    the specs (the dry run's ``params`` count)."""
    meshes = {}
    return {"serve": _serve_cases(inp["serve"], meshes, rank, world),
            "train": _train_cases(inp["train"], meshes),
            "bytes": {name: _param_bytes(cfg, _mesh(meshes, shape))
                      for name, (cfg, shape) in inp["bytes"].items()}}


def _moe(rank, world, tmp):
    """The world of ``tests/test_torch_sharded_moe.py``: ``_mesh_cases``
    of ``moe_in.pkl``, and with ``refuse`` the steps on a 3 x 1 mesh of
    ranks 0-2 over a batch whose dispatch groups do not split over 3 data
    ranks; rank 0 saves them."""
    inp = load(tmp, "moe_in.pkl")
    out = _mesh_cases(inp, rank, world)
    if "refuse" in inp:
        out["refused"] = _dispatch_refusal(rank, *inp["refuse"])
    if rank == 0:
        _save(tmp, "moe_out.pkl", out)


def _mla_rglru(rank, world, tmp):
    """The world of ``tests/test_torch_sharded_mla_rglru.py``:
    ``_mesh_cases`` of ``mla_rglru_in.pkl``, and with ``refuse`` what the
    three steps raise for each of its configs on a (1, world) mesh; rank 0
    saves them."""
    inp = load(tmp, "mla_rglru_in.pkl")
    out = _mesh_cases(inp, rank, world)
    if "refuse" in inp:
        out["refused"] = _stack_refusals(inp["refuse"])
    if rank == 0:
        _save(tmp, "mla_rglru_out.pkl", out)


def _serve_train(rank, world, tmp, name):
    """The world of ``tests/test_torch_sharded_fsdp_sp.py`` (``name``
    "fsdp_sp") or ``tests/test_torch_sharded_families.py`` ("families"):
    the serving and training cases of ``<name>_in.pkl`` (``_serve_cases``,
    ``_train_cases``), each on its own mesh names and rules; rank 0 saves
    them."""
    inp = load(tmp, f"{name}_in.pkl")
    meshes = {}
    out = {"serve": _serve_cases(inp["serve"], meshes, rank, world),
           "train": _train_cases(inp["train"], meshes)}
    if rank == 0:
        _save(tmp, f"{name}_out.pkl", out)


def _stack_refusals(cfgs: dict) -> dict:
    """{(config, step): what make_train_step, make_prefill and
    make_serve_step raise on a (1, world) mesh, or None}: the layouts
    still refused (``tests/test_torch_sharded_mla_rglru.py`` passes 3 KV
    heads beside 6 query heads)."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (make_prefill, make_serve_step,
                                          make_train_step)
    mesh = make_mesh((1, dist.get_world_size()), ("data", "model"),
                     device_type="cpu")
    rules = ShardingRules(data_axes=("data",))
    out = {}
    for name, cfg in cfgs.items():
        for what, fn in (("train", lambda: make_train_step(cfg, rules, mesh)),
                         ("prefill", lambda: make_prefill(cfg, rules, mesh)),
                         ("serve", lambda: make_serve_step(cfg, rules, mesh,
                                                           max_len=32))):
            try:
                fn()
                out[(name, what)] = None
            except NotImplementedError as e:
                out[(name, what)] = str(e)
    return out


def _param_bytes(cfg, mesh) -> list:
    """[(this rank's bytes of ``shard_params``' local shards, the specs'
    ``per_device_bytes``) of every rank]."""
    from repro_torch.distributed.sharding import (ShardingRules,
                                                  per_device_bytes,
                                                  shard_params)
    from repro_torch.launch import specs as S
    from repro_torch.models import transformer as T
    rules = ShardingRules(data_axes=("data",))
    model = shard_params(T.init(cfg, generator=torch.Generator()
                                .manual_seed(0), device="cpu"), rules, mesh)
    got = sum(p.to_local().numel() * p.to_local().element_size()
              for p in model.parameters())
    shapes, specs = S.param_specs(cfg, rules, mesh)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, (got, per_device_bytes(shapes, specs,
                                                         mesh)))
    return ranks


def _dispatch_refusal(rank, cfg, tokens) -> dict:
    """The train step and the prefill of ``cfg`` on a 3 x 1 mesh of ranks
    0-2 (rank 3 outside it) over ``tokens`` (B, S): what each raises."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.distributed.sharding import ShardingRules, shard_params
    from repro_torch.launch.steps import (local_batch, make_prefill,
                                          make_train_step)
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    mesh = DeviceMesh("cpu", torch.arange(3).reshape(3, 1),
                      mesh_dim_names=("data", "model"))
    out = {}
    if rank < 3:
        rules = ShardingRules(data_axes=("data",))
        model = shard_params(T.init(cfg, generator=torch.Generator()
                                    .manual_seed(0), device="cpu"), rules,
                             mesh)
        opt = adamw_init(dict(model.named_parameters()))
        tok = torch.from_numpy(tokens)
        batch = {"tokens": tok, "targets": tok}
        for what, run in (
                ("train", lambda: make_train_step(cfg, rules, mesh)(
                    model, opt, local_batch(batch, mesh))),
                ("prefill", lambda: make_prefill(cfg, rules, mesh)(
                    model, {"tokens": tok}))):
            try:
                run()
                out[what] = None
            except NotImplementedError as e:
                out[what] = str(e)
    dist.barrier()
    return out


JOBS = {"collectives": _collectives, "pipeline": _pipeline, "train": _train,
        "serve": _serve, "moe": _moe, "mla_rglru": _mla_rglru,
        "fsdp_sp": functools.partial(_serve_train, name="fsdp_sp"),
        "families": functools.partial(_serve_train, name="families")}


def replay_psum(xs: np.ndarray) -> np.ndarray:
    """``compressed_psum``'s arithmetic in numpy float32 over the ranks'
    inputs ``xs`` (ranks, ...): per 256-block the ranks' shared scale
    max(|x|) / 127, half-to-even int8 levels, their int32 sum, dequantized.
    Every rank's result."""
    n = xs.shape[0]
    flat = xs.reshape(n, -1).astype(np.float32)
    size = flat.shape[1]
    pad = (-size) % 256
    fp = np.pad(flat, ((0, 0), (0, pad))).reshape(n, -1, 256)
    local = np.max(np.abs(fp), axis=2, keepdims=True)
    scale = np.maximum(np.max(local, axis=0), np.float32(1e-12)) / \
        np.float32(127.0)
    q = np.round(fp / scale).astype(np.int8).astype(np.int32)
    deq = q.sum(axis=0).astype(np.float32) * scale
    return deq.reshape(-1)[:size].reshape(xs.shape[1:])
