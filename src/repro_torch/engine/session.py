"""StreamSession: the synchronous push-one/get-one facade over SOI
streaming (port of the U-Net half of ``repro.engine.session``).

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
from repro_torch.engine.contracts import CheckedGraph


class StreamSession:
    """Drives a ``step(state, inp) -> (state, out)`` function over a
    stream. The session owns the carried state; callers push inputs in
    arrival order.

    ``registry`` (the reference's per-push metrics) raises
    ``NotImplementedError``: the observability layer is not ported yet.
    ``graph`` is the ``CheckedGraph`` the step runs through, if any (its
    captures, replays and ``stats()``).
    """

    def __init__(self, step, state, registry=None, graph=None):
        if registry is not None:
            raise NotImplementedError(
                "session metrics (registry=) need the observability layer, "
                "which is not ported yet (see ROADMAP.md)")
        self._step = step
        self.state = state
        self.graph = graph

    @torch.no_grad()
    def push(self, inp):
        """Feed one input (a frame (B, C)); returns the step's output."""
        self.state, out = self._step(self.state, inp)
        return out

    def run(self, xs):
        """Stream a whole (B, T, ...) sequence; returns stacked outputs."""
        outs = [self.push(xs[:, i]) for i in range(xs.shape[1])]
        return torch.stack(outs, dim=1)


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
    the card) and returns a copy of its output."""
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
