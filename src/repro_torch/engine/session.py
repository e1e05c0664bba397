"""StreamSession: the synchronous push-one/get-one facade over SOI
streaming (port of the U-Net half of ``repro.engine.session``).

A U-Net session cycles through the per-phase graphs of
``models.unet.make_phase_steppers``. The reference fuses them into one
jitted program with ``lax.switch`` on a clock carried on the device; the
port carries the clock ``t`` on the host, as its ``SOIEngine`` does, and
calls ``steppers[t % period]`` — no device sync per frame. Each phase's
step still runs only its own layers (the paper's MAC saving).
"""

from __future__ import annotations

import functools

import torch

from repro_torch import resolve_device


class StreamSession:
    """Drives a ``step(state, inp) -> (state, out)`` function over a
    stream. The session owns the carried state; callers push inputs in
    arrival order.

    ``registry`` (the reference's per-push metrics) raises
    ``NotImplementedError``: the observability layer is not ported yet.
    """

    def __init__(self, step, state, registry=None):
        if registry is not None:
            raise NotImplementedError(
                "session metrics (registry=) need the observability layer, "
                "which is not ported yet (see ROADMAP.md)")
        self._step = step
        self.state = state

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
    must be where the model's weights are."""
    from repro_torch.models import unet as U
    dev = resolve_device(device)
    w_dev = model.proj.w.device
    if w_dev.type != dev.type:
        raise ValueError(f"the model is on {w_dev}, the session on {dev}")
    steppers = _unet_steppers(cfg)
    period = len(steppers)
    state = {"t": 0, "inner": U.init_stream_state(batch, cfg, dtype=dtype,
                                                  device=dev)}

    def step(s_, frame):
        inner, y = steppers[s_["t"] % period](model, s_["inner"], frame)
        return {"t": s_["t"] + 1, "inner": inner}, y

    return StreamSession(step, state, registry=registry)
