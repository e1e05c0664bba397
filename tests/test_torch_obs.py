"""repro_torch.obs and the engine's telemetry against the JAX package on the
CPU (the port of ``tests/test_obs.py``), float32 smoke configs,
numpy-seeded weights and prompts:

  * one scripted sequence of metric operations and request marks (explicit
    times) gives both packages equal ``as_dict()``, ``Tracer.summary()``
    and ``chrome_trace()``, byte-identical ``write_metrics`` files, and the
    same exception types for a kind conflict, a negative increment and a
    duplicate request id;
  * ``step_metrics`` equals ``repro.engine.step.step_metrics`` at stride
    1-4 and B 1-8, and on the reference test's three fixed cases;
  * ``EngineTelemetry`` refuses CPU torch tensors (metrics or speculative
    rows), raises on a stride mismatch, and equals the reference's
    counters, occupancy table and coherence on the same vectors and on a
    (B, K+3) speculative result;
  * the engine's drained telemetry vector equals the JAX engine's at every
    step (pp and fp, dense and paged, ``speculate=4`` paged), its
    ``mid_fired`` equals the branch the host chose, ``telemetry=False``
    gives no vector and the same tokens, and every step (window) makes
    one sanctioned drain either way;
  * ``SOIEngine(n_pages=, n_pages_mid=)`` sizes the pools as the
    reference's does: ``pool_stats`` and ``can_insert`` equal on one
    schedule, an exhausted pool raises;
  * ``make_trace`` gives the reference's requests for three seeds;
    ``run_load`` on the reference test's engine, every arrival before the
    first admission, gives the reference's schedule counters, engine
    registry, occupancy table and coherence, first-come and phase-aligned;
  * ``launch/serve.py --trace-out --metrics-out`` writes the reference's
    metrics keys less the three compile gauges, with equal schedule
    counters, and a trace of one track a request;
  * ``unet_stream_session(registry=)`` counts its pushes and leaves the
    frames bit for bit.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.qwen3_1_7b as Q
import repro.obs as J
from repro.distributed.sharding import split_axes
from repro.engine import SOIEngine as JEngine
from repro.engine.step import step_metrics as jstep_metrics
from repro.launch import serve as jserve
from repro.launch.bench import validate_bench
from repro.models import transformer as JT
import repro_torch.obs as P
from repro_torch.configs import qwen3_1_7b as PQ
from repro_torch.configs import soi_unet_dns as PU
from repro_torch.convert import from_jax_params
from repro_torch.engine import SOIEngine, contracts
from repro_torch.engine.api import ResultTokens
from repro_torch.engine.session import unet_stream_session
from repro_torch.engine.step import step_metrics
from repro_torch.launch import serve as pserve
from repro_torch.models import unet as U

torch.set_num_threads(1)

# the compile gauges of the reference's engine, which the port's lacks
COMPILE_GAUGES = {"engine.prefill_compiles", "engine.spec_compiles",
                  "engine.hydrate_compiles"}


def _random_params(cfg, seed=0):
    """Reference-shaped parameter tree drawn by numpy (fan-in scaled
    weights, unit embeddings, nonzero norm scales)."""
    shapes, _ = split_axes(jax.eval_shape(
        lambda k: JT.init(k, cfg), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def draw(x):
        if len(x.shape) == 1:
            s = 0.3
        elif x.shape[0] == cfg.vocab:
            s = 1.0
        elif len(x.shape) == 3 and x.shape[-1] == cfg.d_model:
            s = float(np.prod(x.shape[:-1])) ** -0.5
        else:
            s = x.shape[0] ** -0.5
        return (rng.standard_normal(x.shape) * s).astype(np.float32)

    return jax.tree.map(draw, shapes)


@functools.lru_cache(maxsize=None)
def _qwen(mode):
    jc = dataclasses.replace(Q.smoke_config(soi=mode), dtype="float32")
    pc = dataclasses.replace(PQ.smoke_config(soi=mode), dtype="float32")
    np_params = _random_params(jc)
    return (jc, pc, jax.tree.map(jnp.asarray, np_params),
            from_jax_params(np_params, pc, device="cpu"))


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


# -- registry, spans, trace files ------------------------------------------

def _scripted(obs):
    """One scripted sequence of metric operations and request marks."""
    reg = obs.MetricsRegistry()
    reg.counter("engine.steps").inc(3)
    reg.counter("engine.steps").inc()
    reg.gauge("engine.pages.outer.free").set(17)
    reg.gauge("rate").set(2.5)
    h = reg.histogram("serve.ttft_s")
    for v in (0.5, 0.25, 1.0, 0.125, 2.0):
        h.observe(v)
    reg.histogram("empty")
    tracer = obs.Tracer(t0=10.0)
    marks = [(0, 1, 10.0, 10.5, 11.0, 11.25, [(1, 12.0), (2, 12.5)], 12.5),
             (1, None, 10.25, 11.0, 11.5, 11.5, [(4, 13.0)], None),
             (2, 3, 11.0, None, None, None, [], None)]
    for rid, tenant, tq, tps, tpe, tins, decs, tdone in marks:
        tr = tracer.request(rid, tenant=tenant, t_queued=tq)
        if tps is not None:
            tr.mark_prefill_start(24 + rid, t=tps)
            tr.mark_prefill_end(cache_hit=rid == 1, tokens_skipped=8 * rid,
                                t=tpe)
            tr.mark_inserted(t=tins)
            tr.mark_first_token(t=tins)
        for n, t in decs:
            tr.mark_decode(n, t=t)
        if tdone is not None:
            tr.mark_done(t=tdone)
    return reg, tracer


def _errors(obs) -> list:
    """The exception types of a kind conflict, a negative increment and a
    duplicate request id."""
    out = []
    reg = obs.MetricsRegistry()
    reg.counter("a")
    tracer = obs.Tracer(t0=0.0)
    tracer.request(1)
    for fn in (lambda: reg.gauge("a"), lambda: reg.counter("a").inc(-1),
               lambda: tracer.request(1)):
        try:
            fn()
        except Exception as e:      # noqa: BLE001 — the type is the result
            out.append(type(e).__name__)
        else:
            out.append(None)
    return out


def test_registry_spans_and_trace_equal_reference(tmp_path):
    (jreg, jtr), (preg, ptr) = _scripted(J), _scripted(P)
    assert preg.as_dict() == jreg.as_dict()
    assert ptr.summary() == jtr.summary()
    assert P.chrome_trace(ptr) == J.chrome_trace(jtr)
    assert P.percentile([], 99) == J.percentile([], 99) == 0.0
    assert P.percentile([3, 1, 2], 50) == J.percentile([3, 1, 2], 50)
    for name, (reg, tr, obs) in {"j": (jreg, jtr, J),
                                 "p": (preg, ptr, P)}.items():
        obs.write_metrics(tmp_path / f"m_{name}.json", registry=reg,
                          tracer=tr, extra={"x": 1})
        obs.write_trace(tr, tmp_path / f"t_{name}.json")
    for kind in ("m", "t"):
        assert ((tmp_path / f"{kind}_p.json").read_bytes()
                == (tmp_path / f"{kind}_j.json").read_bytes())
    assert _errors(P) == _errors(J) == ["TypeError", "ValueError",
                                        "ValueError"]
    assert P.__all__ == J.__all__


# -- step_metrics ----------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 2, 3, 4])
def test_step_metrics_equal_reference(stride):
    rng = np.random.default_rng(stride)
    for b in range(1, 9):
        for _ in range(3):
            t = rng.integers(0, 200, (b,)).astype(np.int32)
            active = rng.random(b) < 0.6
            for act in (active, None):
                want = np.asarray(jstep_metrics(t, act, stride))
                got = step_metrics(torch.from_numpy(t),
                                   None if act is None
                                   else torch.from_numpy(act), stride)
                assert got.dtype == torch.int32
                assert got.numpy().tolist() == want.tolist()


def test_step_metrics_reference_cases():
    cases = [([0, 1, 2, 5], [True, True, True, False], 2, [2, 1, 1, 3]),
             ([1, 3], [True, True], 2, [0, 2, 0, 2]),
             ([4], None, 1, [1, 1, 1])]
    for t, act, stride, want in cases:
        got = step_metrics(torch.tensor(t, dtype=torch.int32),
                           None if act is None else torch.tensor(act),
                           stride)
        assert got.tolist() == want


# -- EngineTelemetry -------------------------------------------------------

class _Res:
    def __init__(self, metrics=None, data=None, accepted_idx=None,
                 valid_idx=(1, 2)):
        self.metrics = metrics
        self.data = data
        self.accepted_idx = accepted_idx
        self.valid_idx = valid_idx


def test_engine_telemetry_refuses_tensors():
    with pytest.raises(TypeError, match="DRAINED"):
        P.EngineTelemetry(2).observe_result(
            _Res(metrics=torch.zeros(4, dtype=torch.int32)))
    with pytest.raises(TypeError, match="DRAINED"):
        P.EngineTelemetry(2).observe_result(
            _Res(data=torch.zeros((2, 7), dtype=torch.int32),
                 accepted_idx=(6, 7), valid_idx=(4, 5)))
    # an undrained engine result is refused too
    res = ResultTokens(data=torch.zeros((2, 3), dtype=torch.int32),
                       metrics=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError, match="DRAINED"):
        P.EngineTelemetry(2).observe_result(res)
    P.EngineTelemetry(2).observe_result(res.convert_to_numpy())


def test_engine_telemetry_stride_mismatch():
    with pytest.raises(ValueError, match="stride"):
        P.EngineTelemetry(2).observe_result(
            _Res(metrics=np.zeros(5, np.int32)))
    with pytest.raises(ValueError):
        P.EngineTelemetry(0)


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_engine_telemetry_equals_reference(stride):
    rng = np.random.default_rng(10 + stride)
    tel = {"j": J.EngineTelemetry(stride), "p": P.EngineTelemetry(stride)}
    for _ in range(40):
        b = int(rng.integers(1, 6))
        t = rng.integers(0, 50, (b,)).astype(np.int32)
        act = rng.random(b) < 0.7
        met = np.asarray(jstep_metrics(t, act, stride))
        for x in tel.values():
            x.observe_result(_Res(metrics=met))
    # a (B, K+3) speculative window: rows [tok x K, valid, length, accepted]
    k = 4
    data = rng.integers(0, 9, (3, k + 3)).astype(np.int32)
    data[:, k] = [1, 0, 1]
    data[:, k + 2] = [4, 2, 1]
    spec = _Res(metrics=np.asarray(jstep_metrics(
        np.array([2, 3, 4], np.int32), np.array([True, False, True]),
        stride)), data=data, accepted_idx=(k + 2, k + 3),
        valid_idx=(k, k + 1))
    for x in tel.values():
        x.observe_result(spec)
    j, p = tel["j"], tel["p"]
    assert p.registry.as_dict() == j.registry.as_dict()
    assert p.off_phase_rate_by_occupancy() == j.off_phase_rate_by_occupancy()
    assert p.phase_coherence() == j.phase_coherence()
    assert p.registry.as_dict()["engine.spec_accepted_per_window.count"] == 2


# -- the engine's telemetry vector -----------------------------------------

# (label, mode, engine options): the schedules of the parity below
ENGINE_CASES = {
    "pp-dense": ("pp", {}),
    "fp-dense": ("fp", {}),
    "pp-paged": ("pp", {"paged": True, "page_size": 4}),
    "fp-paged": ("fp", {"paged": True, "page_size": 4}),
    "pp-paged-spec4": ("pp", {"paged": True, "page_size": 4,
                              "speculate": 4}),
}
LENS = (9, 12, 7)           # slots 0 and 1 at the start, slot 2 after 3 steps
N_STEPS = 9


def _schedule(eng, params, prompts, prefill, step_hook=None):
    """Insert two prompts, run N_STEPS steps (the third prompt inserted
    after step 3, slot 0 freed after step 6); returns the drained results
    and the host's branch at every step (``step_hook``)."""
    ds = eng.init_decode_state(params)
    for slot in (0, 1):
        ds = eng.insert(eng.prefill(params, prefill(prompts[slot])), ds,
                        slot)
    out, branches = [], []
    for i in range(N_STEPS):
        if i == 3:
            ds = eng.insert(eng.prefill(params, prefill(prompts[2])), ds, 2)
        if i == 6:
            ds = eng.free_slot(ds, 0)
        if step_hook is not None:
            branches.append(step_hook(eng))
        ds, res = eng.generate(params, ds)
        out.append(res.convert_to_numpy())
    return out, branches


def _host_branch(eng):
    """The branch the port's host takes at the next step: the plain
    step's ``run_mid_any``, a window's first verify step's."""
    if eng.speculate is not None:
        return eng._window_key()[1][0]
    st = eng.cfg.soi.stride
    return bool(np.any((eng._clock % st == 0) & eng._occupied))


@functools.lru_cache(maxsize=None)
def _engine_runs(case):
    mode, kw = ENGINE_CASES[case]
    jc, pc, jparams, model = _qwen(mode)
    prompts = _prompts(pc.vocab, LENS, seed=3)
    jeng = JEngine(jc, max_concurrent_decodes=3, max_len=32,
                   telemetry=True, **kw)
    jout, _ = _schedule(jeng, jparams, prompts, jnp.asarray)
    runs = {}
    for tele in (True, False):
        eng = SOIEngine(pc, max_concurrent_decodes=3, max_len=32,
                        device="cpu", telemetry=tele, **kw)
        d0 = contracts.drain_count()
        mid0 = eng.mid_steps
        out, branches = _schedule(eng, model, prompts, torch.from_numpy,
                                  _host_branch)
        runs[tele] = (out, branches, contracts.drain_count() - d0,
                      eng.mid_steps - mid0)
    return jout, runs


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_metrics_equal_reference_every_step(case):
    jout, runs = _engine_runs(case)
    out, branches, _, _ = runs[True]
    stride = _qwen(ENGINE_CASES[case][0])[1].soi.stride
    for i, (j, p) in enumerate(zip(jout, out)):
        assert isinstance(p.metrics, np.ndarray), i
        assert p.metrics.dtype == np.int32 and p.metrics.shape == (stride + 2,)
        assert p.metrics.tolist() == np.asarray(j.metrics).tolist(), i
        # the device's mid_fired is the branch the host chose
        assert bool(p.metrics[stride]) == branches[i], i
        assert np.array_equal(p.data, np.asarray(j.data)), i
    assert any(not b for b in branches) and any(branches)


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_telemetry_off_same_tokens_one_drain_a_step(case):
    _, runs = _engine_runs(case)
    on, off = runs[True], runs[False]
    assert all(r.metrics is None for r in off[0])
    for a, b in zip(on[0], off[0]):
        assert np.array_equal(a.data, b.data)
    assert on[2] == off[2] == N_STEPS
    assert on[1] == off[1]
    if ENGINE_CASES[case][1].get("speculate") is None:
        # the host's branch counter against the drained vectors
        assert on[3] == sum(int(r.metrics[-2]) for r in on[0])


# -- pool sizing -----------------------------------------------------------

def _pool_schedule(eng, params, prompts, prefill):
    """pool_stats and can_insert along one schedule on small pools, then
    an insert the pools cannot back; returns the record and the raised
    exception's type."""
    rec = []
    ds = eng.init_decode_state(params)

    def look(tag):
        rec.append((tag, eng.pool_stats(),
                    [eng.can_insert(n, s) for n in (4, 12, 20, 28)
                     for s in (0, 1)]))
    look("init")
    ds = eng.insert(eng.prefill(params, prefill(prompts[0])), ds, 0)
    look("insert 0")
    for i in range(6):
        ds, _res = eng.generate(params, ds)
        look(f"step {i}")
    ds = eng.free_slot(ds, 0)
    look("free 0")
    ds = eng.insert(eng.prefill(params, prefill(prompts[1])), ds, 1)
    look("insert 1")
    try:
        eng.insert(eng.prefill(params, prefill(prompts[2])), ds, 0)
    except RuntimeError as e:
        return rec, type(e).__name__
    return rec, None


def test_pool_sizing_equals_reference():
    jc, pc, jparams, model = _qwen("pp")
    prompts = _prompts(pc.vocab, (10, 20, 18), seed=5)
    kw = dict(max_concurrent_decodes=2, max_len=32, paged=True, page_size=4,
              n_pages=9, n_pages_mid=5)
    jrec, jerr = _pool_schedule(JEngine(jc, **kw), jparams, prompts,
                                jnp.asarray)
    prec, perr = _pool_schedule(SOIEngine(pc, device="cpu", **kw), model,
                                prompts, torch.from_numpy)
    assert prec == jrec
    assert perr == jerr == "RuntimeError"
    assert prec[0][1] == {"outer": {"n_pages": 8, "free": 8, "used": 0,
                                    "high_water": 0},
                          "mid": {"n_pages": 4, "free": 4, "used": 0,
                                  "high_water": 0}}
    flags = [f for _t, _s, fl in prec for f in fl]
    assert any(flags) and not all(flags)
    # the default still backs every slot at full length
    eng = SOIEngine(pc, device="cpu", max_concurrent_decodes=2, max_len=32,
                    paged=True, page_size=4)
    eng.init_decode_state(model)
    assert eng.pool_stats()["outer"]["n_pages"] == 2 * 32 // 4


# -- load generator --------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_make_trace_equals_reference(seed):
    kw = dict(n_tenants=4, zipf_a=1.1, prefix_len=12, suffix_lens=(2, 9),
              gen_lens=(1, 7), burst_rate_hz=20.0, burst_mean=2.5,
              seed=seed)
    jr, pr = J.make_trace(30, 97, **kw), P.make_trace(30, 97, **kw)
    assert len(pr) == len(jr) == 30
    for a, b in zip(jr, pr):
        assert (b.rid, b.tenant, b.arrival_s, b.prefix_len, b.gen_len) == (
            a.rid, a.tenant, a.arrival_s, a.prefix_len, a.gen_len)
        assert b.tokens.dtype == a.tokens.dtype
        assert np.array_equal(b.tokens, a.tokens)
    with pytest.raises(ValueError):
        P.make_trace(0, 97)


# the reference test's engine (tests/test_obs.py::
# test_run_load_end_to_end_with_telemetry)
LOAD_ENGINE = dict(max_concurrent_decodes=2, max_len=96, paged=True,
                   page_size=16, prefill_chunk=16, prefix_cache=True,
                   n_pages=48, n_pages_mid=24, telemetry=True)
# every arrival lands before the first admission, so the schedule does not
# depend on how fast the host runs
LOAD_TRACE = dict(n_tenants=2, prefix_len=32, suffix_lens=(4, 8),
                  gen_lens=(1, 6), burst_rate_hz=1e9, seed=1)
SCHEDULE_KEYS = ("requests", "completed", "steps", "deferred_admissions",
                 "phase_deferred", "hit_rate", "tokens_skipped",
                 "cache_hits", "decode_tokens", "phase_coherent_step_rate",
                 "phase_modal_fraction_mean")
TIMING_KEYS = ("ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s",
               "queue_wait_p50_s", "queue_wait_p99_s", "elapsed_s",
               "tok_s")


@functools.lru_cache(maxsize=None)
def _load_runs():
    jc, pc, jparams, model = _qwen("pp")
    reqs = J.make_trace(6, jc.vocab, **LOAD_TRACE)
    jeng = JEngine(jc, **LOAD_ENGINE)
    peng = SOIEngine(pc, device="cpu", **LOAD_ENGINE)
    out = {}
    for align in (False, True):
        # each package's engine count of drains differs (the reference's
        # windows drain twice); the gauge is compared as a delta below
        d0 = contracts.drain_count()
        out[align] = (J.run_load(jeng, jparams, reqs, phase_align=align),
                      P.run_load(peng, model, P.make_trace(
                          6, pc.vocab, **LOAD_TRACE), phase_align=align),
                      contracts.drain_count() - d0)
    return out


@pytest.mark.parametrize("align", [False, True], ids=["fcfs", "aligned"])
def test_run_load_equals_reference(align):
    jres, pres, drains = _load_runs()[align]
    js, ps = jres.summary, pres.summary
    assert set(ps) == set(js)
    for k in SCHEDULE_KEYS:
        assert ps[k] == js[k], k
    assert ps["completed"] == 6 and ps["hit_rate"] > 0
    for k in TIMING_KEYS:
        assert np.isfinite(ps[k]) and ps[k] >= 0.0, k
    assert validate_bench(ps, "test") == []
    jd, pd = jres.telemetry.registry.as_dict(), pres.telemetry.registry \
        .as_dict()
    assert set(pd) == set(jd) - COMPILE_GAUGES
    for k in pd:
        if k != "engine.sanctioned_drains":
            assert pd[k] == jd[k], k
    # one drain a generate step (and none elsewhere in the loop)
    assert drains == ps["steps"]
    assert (pres.telemetry.off_phase_rate_by_occupancy()
            == jres.telemetry.off_phase_rate_by_occupancy())
    assert pres.telemetry.phase_coherence() == jres.telemetry \
        .phase_coherence()
    assert [t.rid for t in pres.tracer.traces] == [
        t.rid for t in jres.tracer.traces]


# -- launch/serve.py -------------------------------------------------------

SERVE_ARGV = ["--smoke", "--soi", "pp", "--paged", "--page-size", "4"]


def _serve_files(tmp):
    out = {}
    for name, mod, extra in (("j", jserve, []),
                             ("p", pserve, ["--device", "cpu"])):
        trace, metrics = f"{tmp}/trace_{name}.json", f"{tmp}/m_{name}.json"
        mod.main(SERVE_ARGV + extra + ["--trace-out", trace,
                                       "--metrics-out", metrics])
        with open(trace) as fh, open(metrics) as fm:
            out[name] = (json.load(fh), json.load(fm))
    return out


@pytest.fixture(scope="module")
def serve_files(tmp_path_factory):
    return _serve_files(str(tmp_path_factory.mktemp("serve")))


def test_serve_metrics_equal_reference(serve_files):
    (_, jm), (_, pm) = serve_files["j"], serve_files["p"]
    assert set(pm) == set(jm) - COMPILE_GAUGES
    assert COMPILE_GAUGES <= set(jm)
    keys = ["engine.steps", "engine.mid_fired_steps",
            "engine.off_phase_steps", "trace.requests", "trace.completed",
            "trace.decode_tokens"] + [k for k in pm if k.startswith(
                "engine.phase_occupancy.p")]
    for k in keys:
        assert pm[k] == jm[k], k
    assert pm["trace.completed"] == 4 and pm["engine.steps"] > 0
    assert validate_bench(pm, "test") == []


def test_serve_trace_one_track_a_request(serve_files):
    doc, _ = serve_files["p"]
    ev = doc["traceEvents"]
    tracks = {e["tid"] for e in ev}
    assert len(tracks) == 4
    for tid in tracks:
        mine = [e for e in ev if e["tid"] == tid]
        assert sum(e["ph"] == "M" for e in mine) == 1
        assert {e["name"] for e in mine if e["ph"] == "X"} == {
            "queued", "prefill", "decode"}
        commits = [e for e in mine if e["ph"] == "i"]
        assert commits and all(e["name"] == "commit" for e in commits)
        assert all(e["dur"] >= 0.0 for e in mine if e["ph"] == "X")
    jdoc, _ = serve_files["j"]
    assert len(jdoc["traceEvents"]) == len(ev)


def test_serve_without_trace_flags_has_no_telemetry():
    args = pserve.parse_args(SERVE_ARGV + ["--device", "cpu"])
    assert args.trace_out is None and args.metrics_out is None
    _cfg, _p, _pr, _pl, eng = pserve.setup(args)
    assert not eng.telemetry


# -- the U-Net session -----------------------------------------------------

def test_unet_session_registry_counts_pushes():
    cfg = PU.smoke_config()
    model = U.init(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 11, cfg.in_channels)).astype(np.float32))
    reg = P.MetricsRegistry()
    plain = unet_stream_session(model, cfg, batch=2, device="cpu")
    timed = unet_stream_session(model, cfg, batch=2, device="cpu",
                                registry=reg)
    for i in range(x.shape[1]):
        assert torch.equal(timed.push(x[:, i]), plain.push(x[:, i])), i
    for (pa, a), (_, b) in zip(contracts.state_leaves(plain.state["inner"]),
                               contracts.state_leaves(timed.state["inner"])):
        assert torch.equal(a, b), pa
    d = reg.as_dict()
    assert d["session.pushes"] == x.shape[1]
    assert d["session.push_dispatch_s.count"] == x.shape[1]
    assert d["session.push_dispatch_s.p99"] >= d[
        "session.push_dispatch_s.p50"] > 0.0
