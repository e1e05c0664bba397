"""StreamSession: the synchronous push-one/get-one facade over SOI
streaming (port of ``repro.engine.session``).

An LM session (``lm_stream_session``) wraps ``engine.step.generate_step``:
token ids in, logits out, over a decode state of its own (prefilled from a
prompt through the compressed trunk, or empty). Every row shares one clock,
which the session carries on the host, so the step's SOI branch — does
this token complete a compression window? — is a Python bool, as the
engine's is: the step runs through one ``contracts.CheckedGraph`` with
that bool as its static key, two CUDA graphs on the card (one for a plain
config), captured at their first step and replayed over the state, which
the step writes in place, and a static token buffer. The reference
resolves the branch inside its jitted step (``lax.cond``) from the clocks
on the device.

A U-Net session cycles through the per-phase graphs of
``models.unet.make_phase_steppers``. The reference fuses them into one
jitted program with ``lax.switch`` on a clock carried on the device
(``_unet_step_program``); the port carries the clock ``t`` on the host, as
its ``SOIEngine`` does, and runs ``steppers[t % period]`` through one
``contracts.CheckedGraph`` with the phase as its static branch: on the card
each phase is captured once as a CUDA graph over the stream state (which
the steppers write in place) and a static frame buffer, then replayed —
no device sync per frame, no per-kernel dispatch. Each phase's graph still
runs only its own layers (the paper's MAC saving). On the CPU the same
code runs the steppers eagerly.
"""

from __future__ import annotations

import functools

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelCfg
from repro_torch.engine.contracts import CheckedGraph


class StreamSession:
    """Drives a ``step(state, inp) -> (state, out)`` function over a
    stream. The session owns the carried state; callers push inputs in
    arrival order.

    ``registry`` (optional ``repro_torch.obs.MetricsRegistry``) records
    per-push observability: the ``session.pushes`` counter and the
    ``session.push_dispatch_s`` histogram. The histogram measures
    *dispatch* latency on the host clock — on the card a push returns once
    its graph replay is enqueued, before the frame is computed — so a
    healthy session shows microseconds; milliseconds mean the host blocks
    inside the push (a capture, or a hidden sync). Without a registry a
    push reads no clock.
    ``graph`` is the ``CheckedGraph`` the step runs through, if any (its
    captures, replays and ``stats()``).
    """

    def __init__(self, step, state, registry=None, graph=None):
        self._step = step
        self.state = state
        self._registry = registry
        self.graph = graph

    @torch.no_grad()
    def push(self, inp):
        """Feed one input (token ids (B,) / a frame (B, C)); returns the
        step's output (logits (B, V) float32 / the separated frame)."""
        if self._registry is None:
            self.state, out = self._step(self.state, inp)
            return out
        from repro_torch.obs.clock import now
        t0 = now()
        self.state, out = self._step(self.state, inp)
        self._registry.counter("session.pushes").inc()
        self._registry.histogram("session.push_dispatch_s").observe(
            now() - t0)
        return out

    def run(self, xs):
        """Stream a whole (B, T, ...) sequence; returns stacked outputs."""
        outs = [self.push(xs[:, i]) for i in range(xs.shape[1])]
        return torch.stack(outs, dim=1)


def _lm_step(params, cfg: ModelCfg, state: dict, tokens, run_mid: bool):
    """One token for every row: (state, logits), the state written in
    place."""
    from repro_torch.engine.step import generate_step
    logits, state = generate_step(params, cfg, state, tokens,
                                  run_mid_any=run_mid)
    return state, logits


def lm_stream_session(params, cfg: ModelCfg, *, batch: int = 1,
                      max_len: int = 256, prompt=None, device=None,
                      registry=None) -> StreamSession:
    """Token-streaming session over the unified LM step (SOI or plain);
    ``params`` a ``Transformer`` on ``device`` — the card unless the caller
    asks for the CPU.

    With ``prompt`` (B, S), the prompt is prefilled through the compressed
    trunk (online SOI prefill, ``models.decode.prefill``) before the session
    starts, and the first pushed token decodes at position S; without it
    the session starts from an empty state of ``batch`` rows. Each push
    copies the tokens into the session's token buffer, runs the step (a
    graph replay on the card) and returns a copy of its logits.
    ``session.state`` is the decode state, ``session.graph`` the
    ``CheckedGraph`` (its captures, replays and ``stats()``)."""
    from repro_torch.models import decode as D
    from repro_torch.models.transformer import cast_params
    dev = resolve_device(device)
    params = cast_params(params, cfg)
    if params.embed.device.type != dev.type:
        raise ValueError(f"params are on {params.embed.device}, the "
                         f"session on {dev}")
    if prompt is not None:
        prompt = torch.as_tensor(prompt, device=dev)
        _, state = D.prefill(params, cfg, prompt, max_len=max_len)
        batch, clock = prompt.shape[0], [int(prompt.shape[1])]
    else:
        state = D.init_decode_state(params, cfg, batch, max_len=max_len)
        clock = [0]
    stride = cfg.soi.stride if cfg.soi is not None else 0
    tok_buf = torch.zeros(batch, dtype=torch.int32, device=dev)
    graph = CheckedGraph(lambda p, st, tok, mid: _lm_step(p, cfg, st, tok,
                                                          mid),
                         state_argnums=(1,), static_argnums=(3,),
                         name="lm_step")

    def step(s_, tok):
        tok_buf.copy_(torch.as_tensor(tok))
        run_mid = bool(stride) and clock[0] % stride == 0
        s_, logits = graph(params, s_, tok_buf, run_mid)
        clock[0] += 1
        return s_, logits.clone()

    return StreamSession(step, state, registry=registry, graph=graph)


@functools.lru_cache(maxsize=None)
def _unet_steppers(cfg) -> tuple:
    """The per-phase steps of a UNetConfig, built once per config."""
    from repro_torch.models import unet as U
    return tuple(U.make_phase_steppers(cfg))


def unet_stream_session(model, cfg, *, batch: int = 1, dtype=torch.float32,
                        device=None, registry=None) -> StreamSession:
    """Frame-streaming session for the causal U-Net (``models.unet``):
    ``model`` a ``UNet``, ``cfg`` its ``UNetConfig``. The stream state lives
    on ``device`` — the card unless the caller asks for the CPU — which
    must be where the model's weights are. Each push copies the frame into
    the session's frame buffer, runs the phase's step (a graph replay on
    the card) and returns a copy of its output. ``registry`` counts the
    pushes and their dispatch latency (``StreamSession``)."""
    from repro_torch.models import unet as U
    dev = resolve_device(device)
    w_dev = model.proj.w.device
    if w_dev.type != dev.type:
        raise ValueError(f"the model is on {w_dev}, the session on {dev}")
    steppers = _unet_steppers(cfg)
    period = len(steppers)
    state = {"t": 0, "inner": U.init_stream_state(batch, cfg, dtype=dtype,
                                                  device=dev)}
    frame_buf = torch.zeros((batch, cfg.in_channels), dtype=dtype,
                            device=dev)
    graph = CheckedGraph(lambda m, inner, f, ph: steppers[ph](m, inner, f),
                         state_argnums=(1,), static_argnums=(3,),
                         name="unet_step")

    def step(s_, frame):
        frame_buf.copy_(frame)
        inner, y = graph(model, s_["inner"], frame_buf, s_["t"] % period)
        return {"t": s_["t"] + 1, "inner": inner}, y.clone()

    return StreamSession(step, state, registry=registry, graph=graph)
