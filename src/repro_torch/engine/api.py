"""Engine protocol (port of ``repro.engine.api``): the device functions a
serving loop calls — prefill / insert / generate with slot-based continuous
batching — and the result types.

``ResultTokens`` packs [token, valid, length] per slot into one (B, 3) int32
tensor, so one device->host copy drains a step; a speculative window packs
[tok_0..tok_{K-1}, valid, length, accepted] into one (B, K+3) array, which
the engine has already drained (its accepted counts gate the host's
clocks and page rollback). On the card the engine
starts that copy (into pinned host memory, non-blocking) right after the
step's graph and records an event (``contracts.host_copy_async``);
``convert_to_numpy`` waits for the event through ``contracts.host_get``,
the one sanctioned drain a step (``contracts.drain_count`` counts it). The
copy thus sits in the stream before the next step's work, which is what
lets a serving loop drain step k while step k+1 runs.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.engine import contracts

Params = Any
DecodeState = Any


@dataclasses.dataclass(frozen=True)
class SlotData:
    """One slot's share of a generate step's output."""
    tokens: Any           # (n_tokens,) int32
    valid: Any            # (1,) int32 — 0 for unoccupied slots
    lengths: Any          # (1,) int32 — absolute position after the step
    accepted: Any = None  # (1,) int32 — committed-token count (speculative
    #                       engines; the first ``accepted`` entries of
    #                       ``tokens`` are real). None from per-token steps.


@dataclasses.dataclass(frozen=True)
class ResultTokens:
    """Tokens emitted by one generate step, one row per slot.

    ``data`` is one (B, 3) int32 tensor [token, valid, length]; ``logits``
    (B, V) float32 rides along on the device for verification harnesses.
    ``host`` / ``ready`` are the in-flight host copy of ``data`` and the
    event that marks it complete (None on the CPU). A speculative window
    emits up to K tokens a slot — [tok_0..tok_{K-1}, valid, length,
    accepted], as host numpy — and says so by widening ``tokens_idx`` and
    setting ``accepted_idx``."""
    data: Any
    logits: Optional[Any] = None
    host: Optional[Any] = None
    ready: Optional[Any] = None
    tokens_idx: tuple = (0, 1)
    valid_idx: tuple = (1, 2)
    length_idx: tuple = (2, 3)
    accepted_idx: Optional[tuple] = None

    def convert_to_numpy(self) -> "ResultTokens":
        """This step's ``data`` as host numpy — the one device->host copy of
        the step (``logits`` stay where they are). Call it on the
        *previous* step's results after dispatching the next step."""
        if isinstance(self.data, torch.Tensor):
            data = contracts.host_get(
                self.data if self.host is None else self.host,
                ready=self.ready)
            return dataclasses.replace(self, data=data, host=None,
                                       ready=None)
        return self

    def get_result_at_slot(self, slot: int) -> SlotData:
        row = self.data[slot]
        acc = self.accepted_idx
        return SlotData(tokens=row[slice(*self.tokens_idx)],
                        valid=row[slice(*self.valid_idx)],
                        lengths=row[slice(*self.length_idx)],
                        accepted=None if acc is None else row[slice(*acc)])


@dataclasses.dataclass(frozen=True)
class Prefix:
    """Result of prefilling one request: batch-1 decode caches positioned at
    ``true_length``, plus the first generated token (greedy over the
    prompt's last real position's logits). ``length`` mirrors
    ``true_length`` for unpadded prefills. ``cache_meta`` carries a
    prefix-cache engine's host bookkeeping from prefill to insert (the
    prompt's block keys, the hit boundary, the SOI carry snapshots)."""
    state: Any            # batch-1 model decode state (t == true_length)
    first_token: Any      # (1,) int32
    logits: Any           # (1, V) float32 — last real prompt position
    length: int
    true_length: Optional[int] = None
    cache_meta: Optional[dict] = None

    def __post_init__(self):
        if self.true_length is None:
            object.__setattr__(self, "true_length", self.length)


class Engine(abc.ABC):
    """The computational core of the serving loop."""

    @abc.abstractmethod
    def prefill(self, params: Params, tokens) -> Prefix:
        """Compute caches for a prompt; returns a slot-insertable Prefix."""

    @abc.abstractmethod
    def insert(self, prefix: Prefix, decode_state: DecodeState,
               slot: int) -> DecodeState:
        """Write ``prefix`` into batch row ``slot`` of the decode state."""

    @abc.abstractmethod
    def generate(self, params: Params,
                 decode_state: DecodeState) -> Tuple[DecodeState,
                                                     ResultTokens]:
        """Advance every slot by one token (a speculative engine: by up
        to K tokens, one draft and verify window)."""

    @abc.abstractmethod
    def init_decode_state(self, params: Params) -> DecodeState:
        """Empty decode state with ``max_concurrent_decodes`` free slots."""

    @abc.abstractmethod
    def free_slot(self, decode_state: DecodeState, slot: int) -> DecodeState:
        """Mark ``slot`` unoccupied (its results become invalid)."""

    @property
    @abc.abstractmethod
    def max_concurrent_decodes(self) -> int:
        """Total slot capacity."""
