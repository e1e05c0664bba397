"""The engine's telemetry vector on the card (marker ``gpu``), at smoke
width, float32:

  * ``EngineTelemetry.observe_result`` refuses an undrained CUDA result
    and takes it once ``convert_to_numpy`` has drained it;
  * the vector is an output of the captured step: an engine with
    telemetry captures the graphs one without it captures (2 an SOI
    engine; a speculative engine one a window key), its replays count the
    same kernel-wrapper launches, and the profiler sees a few device
    kernels more a step (the vector's, at most 8) — tokens equal;
  * every drained vector equals the one the host computes from its clocks,
    its ``mid_fired`` the branch the host chose;
  * ``drain_count`` rises by one a step, telemetry on or off;
  * under ``torch.cuda.set_sync_debug_mode("error")`` the dense
    telemetry-on generate step makes no host sync between drains.

Without a CUDA device every test here skips (decided inside the ``cuda``
fixture, so every worker collects the same tests). On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_obs_gpu.py

(``--noconftest``: tests/conftest.py manages JAX, which the card's machine
does not have; this file imports no JAX.)
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import qwen3_1_7b as PQ
from repro_torch.engine import SOIEngine, contracts
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.obs import EngineTelemetry

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

LAYOUTS = {"dense": {}, "paged": {"paged": True, "page_size": 4},
           "paged-spec4": {"paged": True, "page_size": 4, "speculate": 4}}
# one phase class, so the steps alternate between the two branches
LENS = (9, 11, 7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _setup(dev, telemetry, **kw):
    cfg = dataclasses.replace(PQ.smoke_config(soi="pp"), dtype="float32")
    params = T.init(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=64, device=dev,
                    telemetry=telemetry, **kw)
    ds = eng.init_decode_state(params)
    rng = np.random.default_rng(0)
    for slot, n in enumerate(LENS):
        p = torch.from_numpy(rng.integers(0, cfg.vocab, n).astype(np.int32))
        ds = eng.insert(eng.prefill(params, p.to(dev)), ds, slot)
    return cfg, params, eng, ds


def _host_vector(eng) -> list:
    """The telemetry vector of the host's clocks and occupancy."""
    st = eng.cfg.soi.stride
    occ = eng._occupied
    hist = np.bincount(eng._clock[occ] % st, minlength=st)
    return hist.tolist() + [int(hist[0] > 0), int(occ.sum())]


def test_observe_result_refuses_undrained_cuda_result(cuda):
    _cfg, params, eng, ds = _setup(cuda, True)
    ds, res = eng.generate(params, ds)
    assert res.data.is_cuda and res.metrics.is_cuda
    tel = EngineTelemetry(eng.cfg.soi.stride)
    with pytest.raises(TypeError, match="DRAINED"):
        tel.observe_result(res)
    tel.observe_result(res.convert_to_numpy())
    assert tel.registry.as_dict()["engine.steps"] == 1


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_vector_rides_the_graph_one_drain_a_step(cuda, layout):
    runs = {}
    for tele in (True, False):
        _cfg, params, eng, ds = _setup(cuda, tele, **LAYOUTS[layout])
        toks = []
        d0 = contracts.drain_count()
        for _ in range(10):
            want = _host_vector(eng)
            if eng.speculate is not None:
                branch = eng._window_key()[1][0]
            else:
                branch = bool(want[eng.cfg.soi.stride])
            ds, res = eng.generate(params, ds)
            res = res.convert_to_numpy()
            toks.append(res.data.copy())
            if tele:
                assert isinstance(res.metrics, np.ndarray)
                assert res.metrics.tolist() == want
                assert bool(res.metrics[-2]) == branch
            else:
                assert res.metrics is None
        assert contracts.drain_count() - d0 == 10
        g = eng.spec_graph if eng.speculate is not None else eng.graph
        runs[tele] = (toks, g.captures, {k: v["launches"]
                                         for k, v in g.stats().items()})
        if eng.speculate is None:
            assert g.captures == 2
        else:
            assert g.captures == len(eng.spec_keys) > 0
    (t_on, c_on, l_on), (t_off, c_off, l_off) = runs[True], runs[False]
    assert all(np.array_equal(a, b) for a, b in zip(t_on, t_off))
    assert c_on == c_off and l_on == l_off


def _kernels_a_step(eng, params, ds, n=8):
    """Device events (kernels, copies) a step of ``n`` drained steps under
    the profiler. One step runs first, then a marker kernel: the profiler
    can miss the start of its window, so only the events after the marker
    count; a profile that lost the marker is taken again."""
    from torch.profiler import ProfilerActivity, profile
    st = {"ds": ds, "prev": None}

    def step():
        st["ds"], res = eng.generate(params, st["ds"])
        if st["prev"] is not None:
            st["prev"].convert_to_numpy()
        st["prev"] = res
    step()
    step()
    cuda_t = torch.autograd.DeviceType.CUDA
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            for _ in range(n):
                step()
            torch.cuda.synchronize()
        ev = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.device_type == cuda_t)
        marks = [s_ for s_, name in ev if "spin_kernel" in name]
        if marks:
            break
    assert marks, "the profiler saw no marker kernel in two profiles"
    return sum(1 for s_, _ in ev if s_ > marks[-1]) / n


def test_vector_adds_a_few_kernels(cuda):
    counts = {}
    for tele in (True, False):
        _cfg, params, eng, ds = _setup(cuda, tele)
        counts[tele] = _kernels_a_step(eng, params, ds)
    extra = counts[True] - counts[False]
    assert 1 <= extra <= 8, counts


def test_no_sync_between_drains(cuda):
    _cfg, params, eng, ds = _setup(cuda, True)
    prev = None
    for i in range(12):
        if i >= 4:          # both branches captured: steady state
            torch.cuda.set_sync_debug_mode("error")
        try:
            ds, res = eng.generate(params, ds)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if prev is not None:
            prev.convert_to_numpy()
        prev = res
    assert eng.graph.captures == 2
    assert ops.launch_counts()["decode_attention"] > 0
