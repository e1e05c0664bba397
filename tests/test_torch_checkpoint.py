"""The port's checkpointer and supervisor (``repro_torch.checkpoint``,
``repro_torch.distributed.fault_tolerance``), the counterparts of
tests/test_fault_tolerance.py's: round trip, atomic commit, checksum,
async save with garbage collection, restart after a simulated failure,
straggler detection and restore onto a named device. Plus what the port
adds: a state mutated in place right after ``save_async`` restores what
was saved, modules are walked by their ``state_dict`` names (0-d int32
leaves included), and the on-disk layout is the reference's (a
reference-written checkpoint restores into the port)."""

import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.checkpoint import save as jsave
from repro_torch.checkpoint import checkpointer as CK
from repro_torch.checkpoint import Checkpointer, latest_step, restore, save
from repro_torch.distributed.fault_tolerance import (SupervisorConfig,
                                                     TrainSupervisor,
                                                     elastic_restore)

torch.set_num_threads(1)


def _state(v=0.0):
    return {"params": {"w": torch.full((4, 3), v)},
            "opt": {"mu": torch.zeros((4, 3)),
                    "count": torch.tensor(int(v), dtype=torch.int32)}}


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    save(d, 7, _state(3.0))
    assert latest_step(d) == 7
    out = restore(d, 7, _state(0.0))
    assert torch.equal(out["params"]["w"], torch.full((4, 3), 3.0))
    assert out["opt"]["count"].dtype == torch.int32
    assert int(out["opt"]["count"]) == 3


def test_atomic_commit_no_partial(tmp_path):
    d = str(tmp_path / "ck")
    save(d, 1, _state(1.0))
    os.makedirs(os.path.join(d, "tmp.2"))   # a crashed save's leftovers
    assert latest_step(d) == 1


def test_checksum_detects_corruption(tmp_path):
    d = str(tmp_path / "ck")
    save(d, 1, _state(1.0))
    target = os.path.join(d, "step_00000001", "arr_00000.npy")
    np.save(target, np.load(target) + 1)
    with pytest.raises(IOError):
        restore(d, 1, _state(0.0))


def test_async_checkpointer_and_gc(tmp_path):
    d = str(tmp_path / "ck")
    ck = Checkpointer(d, keep=2)
    for step in (1, 2, 3, 4):
        ck.save_async(step, _state(float(step)))
    ck.wait()
    steps = sorted(int(x.split("_")[1]) for x in os.listdir(d)
                   if x.startswith("step_"))
    assert steps == [3, 4]
    _, st = ck.restore_latest(_state(0.0))
    assert torch.equal(st["params"]["w"], torch.full((4, 3), 4.0))


def test_save_async_snapshots_before_returning(tmp_path, monkeypatch):
    """The state is updated in place the moment save_async returns (as the
    port's AdamW does), while the writer thread may still be running: the
    checkpoint holds the values at the call."""
    d = str(tmp_path / "ck")
    gate = threading.Event()
    real_write = CK._write

    def slow_write(*args):
        assert gate.wait(timeout=10)   # the mutation below happens first
        return real_write(*args)

    monkeypatch.setattr(CK, "_write", slow_write)
    ck = Checkpointer(d)
    state = _state(5.0)
    ck.save_async(0, state)
    state["params"]["w"].add_(100.0)
    state["opt"]["count"].add_(1)
    gate.set()
    ck.wait()
    out = restore(d, 0, _state(0.0))
    assert torch.equal(out["params"]["w"], torch.full((4, 3), 5.0))
    assert int(out["opt"]["count"]) == 5


def test_modules_by_state_dict_names(tmp_path):
    d = str(tmp_path / "ck")
    torch.manual_seed(0)
    net = nn.Sequential(nn.Linear(3, 4), nn.BatchNorm1d(4))
    save(d, 2, {"model": net, "count": torch.tensor(9, dtype=torch.int32)})
    with open(os.path.join(d, "step_00000002", "manifest.json")) as f:
        text = f.read()
    assert "['model']['0.weight']" in text
    assert "['model']['1.num_batches_tracked']" in text
    fresh = nn.Sequential(nn.Linear(3, 4), nn.BatchNorm1d(4))
    out = restore(d, 2, {"model": fresh,
                         "count": torch.tensor(0, dtype=torch.int32)})
    assert out["model"] is fresh
    for (k, a), b in zip(net.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    assert int(out["count"]) == 9


def test_reference_written_checkpoint_restores(tmp_path):
    """Same layout: a checkpoint the reference wrote restores into the
    port's tree of the same paths."""
    d = str(tmp_path / "ck")
    jsave(d, 4, {"params": {"w": jnp.full((4, 3), 2.5)},
                 "opt": {"mu": jnp.ones((4, 3)),
                         "count": jnp.asarray(4, jnp.int32)}})
    out = restore(d, 4, _state(0.0))
    assert torch.equal(out["params"]["w"], torch.full((4, 3), 2.5))
    assert torch.equal(out["opt"]["mu"], torch.ones(4, 3))
    assert int(out["opt"]["count"]) == 4


def test_supervisor_restart_resumes(tmp_path):
    d = str(tmp_path / "ck")
    crashed = {"done": False}

    def step_fn(state, step):
        if step == 7 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("node failure (simulated)")
        state["x"].add_(1.0)                 # in place, as training does
        return state

    sup = TrainSupervisor(SupervisorConfig(ckpt_dir=d, ckpt_every=3),
                          lambda: {"x": torch.zeros(())}, step_fn)
    out = sup.run(10)
    assert float(out["x"]) == 10.0
    assert sup.restarts == 1
    assert ("restored", 5) in sup.events


def test_supervisor_straggler_detection(tmp_path):
    import time
    slow_once = {"done": False}

    def slow_step(state, step):
        if step == 2 and not slow_once["done"]:
            slow_once["done"] = True
            time.sleep(0.05)
        return state

    sup = TrainSupervisor(
        SupervisorConfig(ckpt_dir=str(tmp_path / "ck"), ckpt_every=100,
                         step_deadline_s=0.02, max_restarts=2),
        lambda: {"x": torch.zeros(())}, slow_step)
    sup.run(5)
    assert any(e[0] == "straggler" for e in sup.events)
    assert sup.restarts == 1


def test_elastic_restore_onto_a_named_device(tmp_path):
    d = str(tmp_path / "ck")
    save(d, 1, _state(2.0))
    template = {k: {n: t.to("meta") for n, t in v.items()}
                for k, v in _state(0.0).items()}
    step, out = elastic_restore(d, template, "cpu")
    assert step == 1
    assert out["params"]["w"].device.type == "cpu"
    assert torch.equal(out["params"]["w"], torch.full((4, 3), 2.0))
