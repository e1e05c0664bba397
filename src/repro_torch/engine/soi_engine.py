"""SOIEngine, dense layout (port of the dense path of
``repro.engine.soi_engine``): slot-based continuous batching over the
per-token generate step.

Every slot owns ``max_len`` rows of every layer's ring cache (the middle's
hold ``soi_mid_len`` frames). Prompts are padded to a bucket length
(``prefill_buckets``, default "pow2") and masked by their true length, so
the prefill runs at a few fixed shapes whatever the traffic.

The engine keeps a host mirror of every slot's clock (``_clock``) and
occupancy (``_occupied``). From them it tells the step, as a Python bool,
whether some active slot sits at SOI phase 0 — the middle's skip needs no
device read. ``insert`` sets the slot's clock to the prompt's true length
(the reference's dense insert leaves its host clock as it was; its paged
insert sets it).

The decode state is updated in place: ``insert`` copies a prefix into a
slot's rows, ``generate`` writes each slot's new K/V, ``free_slot`` scrubs
the slot's position lanes. The paged layout, chunked prefill, the prefix
cache, speculative windows and telemetry are later slices: their options
raise.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelCfg
from repro_torch.engine.api import Engine, Prefix, ResultTokens
from repro_torch.engine.step import generate_step
from repro_torch.models import decode as D
from repro_torch.models.transformer import cast_params


def _groups(cfg: ModelCfg) -> tuple:
    return ("segments",) if cfg.soi is None else ("pre", "mid", "post")


@torch.no_grad()
def insert_state(cfg: ModelCfg, dst: dict, src: dict, slot: int) -> dict:
    """Copy the batch-1 model state ``src`` into row ``slot`` of ``dst``, in
    place: clock, every layer's K/V/positions and, for SOI, the conv window
    and the queue."""
    dst["t"][slot] = src["t"][0]
    if cfg.soi is not None:
        for key in ("conv_buf", "queue"):
            dst[key][slot].copy_(src[key][0])
    for group in _groups(cfg):
        for d_c, s_c in zip(dst[group], src[group]):
            for name, d_leaf in d_c.items():
                d_leaf[slot].copy_(s_c[name][0])
    return dst


class SOIEngine(Engine):
    """Engine over the per-token step; handles SOI and plain configs alike.

    The decode state is ``{"model": <per-slot caches/clocks>, "tokens": (B,),
    "active": (B,)}``: ``tokens`` holds each slot's next input token (the
    greedy feedback; harnesses may replace it to force inputs), ``active``
    gates result validity.
    """

    def __init__(self, cfg: ModelCfg, *, max_concurrent_decodes: int = 8,
                 max_len: int = 256, device=None, paged: bool = False,
                 prefill_buckets="pow2", prefill_chunk: int | None = None,
                 prefix_cache: bool = False, speculate: int | None = None,
                 telemetry: bool = False):
        for name, val in (("paged", paged), ("prefill_chunk", prefill_chunk),
                          ("prefix_cache", prefix_cache),
                          ("speculate", speculate),
                          ("telemetry", telemetry)):
            if val:
                raise NotImplementedError(
                    f"SOIEngine({name}=...) is not ported yet; see "
                    f"ROADMAP.md")
        self.cfg = cfg
        self.max_len = int(max_len)
        self.device = resolve_device(device)
        self._slots = int(max_concurrent_decodes)
        self._occupied = np.zeros(self._slots, bool)
        self._clock = np.zeros(self._slots, np.int64)
        self._masked_ok = D.supports_masked_prefill(cfg)
        self._buckets = self._resolve_buckets(prefill_buckets)
        # host-side step counters: generate steps, and steps in which the
        # compressed middle ran (some active slot at phase 0)
        self.steps = 0
        self.mid_steps = 0

    def _resolve_buckets(self, policy):
        """Prefill bucket lengths: None (exact length), "pow2" (powers of
        two from 16 up to max_len, plus max_len), or explicit lengths."""
        if policy is None or not self._masked_ok:
            return None
        if policy == "pow2":
            out, b = [], 16
            while b < self.max_len:
                out.append(b)
                b *= 2
            out.append(self.max_len)
            return tuple(out)
        buckets = sorted({int(x) for x in policy})
        if not buckets or buckets[0] < 1:
            raise ValueError(f"invalid prefill buckets {policy}")
        if buckets[-1] > self.max_len:
            raise ValueError(f"prefill bucket {buckets[-1]} exceeds "
                             f"max_len {self.max_len}")
        if buckets[-1] < self.max_len:
            buckets.append(self.max_len)
        return tuple(buckets)

    @property
    def max_concurrent_decodes(self) -> int:
        return self._slots

    def init_decode_state(self, params):
        params = cast_params(params, self.cfg)
        self._check_params(params)
        ms = D.init_decode_state(params, self.cfg, self._slots,
                                 max_len=self.max_len)
        self._occupied[:] = False
        self._clock[:] = 0
        return {"model": ms,
                "tokens": torch.zeros(self._slots, dtype=torch.int32,
                                      device=self.device),
                "active": torch.zeros(self._slots, dtype=torch.bool,
                                      device=self.device)}

    def _check_params(self, params):
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params are on {params.embed.device}, the "
                             f"engine on {self.device}")

    # -- phase-aligned admission ------------------------------------------

    def batch_phase(self) -> int | None:
        """SOI phase class of the current batch: the modal value of
        ``clock % stride`` over active slots (ties break to the lowest).
        None without an SOI schedule or without active slots."""
        soi = self.cfg.soi
        if soi is None or soi.stride <= 1:
            return None
        occ = np.nonzero(self._occupied)[0]
        if len(occ) == 0:
            return None
        phases, counts = np.unique(self._clock[occ] % soi.stride,
                                   return_counts=True)
        return int(phases[np.argmax(counts)])

    def phase_gap(self, true_length: int) -> int:
        """Generate steps to wait before inserting a ``true_length``-token
        request so its slot lands in the batch's phase class."""
        bp = self.batch_phase()
        if bp is None:
            return 0
        return int((int(true_length) - bp) % self.cfg.soi.stride)

    def can_insert(self, true_length: int, slot: int | None = None,
                   phase_align=False) -> bool:
        """Admission check. Dense slots always have room; ``phase_align``
        defers an insert whose slot would land off the batch's phase class
        (``True``: by up to stride-1 steps; an int bounds the wait)."""
        if phase_align:
            cap = (self.cfg.soi.stride - 1
                   if phase_align is True and self.cfg.soi is not None
                   else int(phase_align))
            if 0 < self.phase_gap(true_length) <= cap:
                return False
        return True

    # -- prefill ----------------------------------------------------------

    def prefill(self, params, tokens, true_length: int | None = None
                ) -> Prefix:
        params = cast_params(params, self.cfg)
        self._check_params(params)
        tokens = torch.as_tensor(tokens, device=self.device)
        if tokens.dim() == 1:
            tokens = tokens[None]
        if tokens.shape[0] != 1:
            raise ValueError(f"prefill takes one request, got batch "
                             f"{tokens.shape[0]}")
        if tokens.shape[1] == 0:
            raise ValueError("prefill requires a non-empty prompt")
        if tokens.shape[1] > self.max_len:
            raise ValueError(f"prompt length {tokens.shape[1]} exceeds "
                             f"engine max_len {self.max_len}")
        tl = (int(true_length) if true_length is not None
              else int(tokens.shape[1]))
        if not 0 < tl <= tokens.shape[1]:
            raise ValueError(f"true_length {tl} outside (0, "
                             f"{tokens.shape[1]}]")
        if self._buckets is not None:
            bucket = next(b for b in self._buckets if b >= tl)
            pad = bucket - int(tokens.shape[1])
            if pad > 0:
                tokens = torch.nn.functional.pad(tokens, (0, pad))
            elif pad < 0:
                tokens = tokens[:, :bucket]
            logits, ms = D.prefill(params, self.cfg, tokens,
                                   max_len=self.max_len, true_length=tl)
        else:
            logits, ms = D.prefill(params, self.cfg, tokens[:, :tl],
                                   max_len=self.max_len)
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        return Prefix(state=ms, first_token=first, logits=logits, length=tl,
                      true_length=tl)

    # -- insert / generate / free ----------------------------------------

    def insert(self, prefix: Prefix, decode_state, slot: int):
        """Install a prefilled request into ``slot`` (in place)."""
        s_i = int(slot)
        if not 0 <= s_i < self._slots:
            raise ValueError(f"slot {slot} out of range [0, {self._slots})")
        insert_state(self.cfg, decode_state["model"], prefix.state, s_i)
        decode_state["tokens"][s_i] = prefix.first_token[0]
        decode_state["active"][s_i] = True
        self._clock[s_i] = prefix.true_length
        self._occupied[s_i] = True
        return decode_state

    def generate(self, params, decode_state):
        """One step for every slot. Returns (decode_state, ResultTokens)."""
        params = cast_params(params, self.cfg)
        st = self.cfg.soi.stride if self.cfg.soi is not None else 1
        run_mid_any = bool(np.any((self._clock % st == 0) & self._occupied))
        self.steps += 1
        self.mid_steps += int(run_mid_any)
        self._clock[self._occupied] += 1
        active = decode_state["active"]
        logits, ms = generate_step(params, self.cfg, decode_state["model"],
                                   decode_state["tokens"], active=active,
                                   run_mid_any=run_mid_any)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        data = torch.stack([nxt, active.to(torch.int32), ms["t"]], dim=1)
        host = ready = None
        if data.is_cuda:
            host = torch.empty(data.shape, dtype=data.dtype, pin_memory=True)
            host.copy_(data, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        new_ds = {"model": ms, "tokens": nxt, "active": active}
        return new_ds, ResultTokens(data=data, logits=logits, host=host,
                                    ready=ready)

    @torch.no_grad()
    def free_slot(self, decode_state, slot: int):
        """Mark ``slot`` unoccupied and scrub its cache positions (pos = -1)
        so a freed request's tokens are unreadable; ``insert`` rewrites the
        slot's rows wholesale on reuse."""
        s_i = int(slot)
        if not 0 <= s_i < self._slots:
            raise ValueError(f"slot {slot} out of range [0, {self._slots})")
        if not self._occupied[s_i]:
            raise ValueError(
                f"free_slot({s_i}): slot is not occupied — it was never "
                f"inserted into, or already freed (double-free)")
        self._occupied[s_i] = False
        model = decode_state["model"]
        for group in _groups(self.cfg):
            for c in model[group]:
                c["pos"][s_i] = -1
        decode_state["active"][s_i] = False
        return decode_state
