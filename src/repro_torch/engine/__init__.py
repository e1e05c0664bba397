"""``repro_torch.engine`` — slot-based continuous batching with the
phase-dispatched SOI generate step (dense layout).

Lifecycle, as in ``repro.engine``::

    engine = SOIEngine(cfg, max_concurrent_decodes=B, max_len=L)
    state  = engine.init_decode_state(params)
    prefix = engine.prefill(params, prompt_tokens)
    state  = engine.insert(prefix, state, slot=3)
    state, result = engine.generate(params, state)     # ONE step, ALL slots
    tok = result.convert_to_numpy().get_result_at_slot(3).tokens
    state = engine.free_slot(state, 3)

On the card ``generate`` replays a CUDA graph of the step (``contracts``:
``CheckedGraph``, the counterpart of the reference's ``checked_jit``), and
``convert_to_numpy`` is the step's one sanctioned drain (``host_get``,
counted by ``drain_count``). ``SOIEngine(speculate=K)`` serves through
self-speculative windows (``engine.speculative``: ``draft_burst``,
``verify_commit``, ``speculative_window``), one CUDA graph per window key
on the card. ``lm_stream_session`` is the token-streaming facade over
the same step (``engine.session``).
"""

from repro_torch.engine.api import (Engine, Prefix, ResultTokens,  # noqa: F401
                                    SlotData)
from repro_torch.engine.contracts import (BIG_BYTES,  # noqa: F401
                                          CheckedGraph,
                                          DroppedDonationError, checked_graph,
                                          drain_count, host_get,
                                          in_sanctioned_drain,
                                          sanctioned_drain)
from repro_torch.engine.session import (StreamSession,  # noqa: F401
                                        lm_stream_session,
                                        unet_stream_session)
from repro_torch.engine.soi_engine import SOIEngine, insert_state  # noqa: F401
from repro_torch.engine.speculative import (draft_burst,  # noqa: F401
                                            speculative_window,
                                            verify_commit)
from repro_torch.engine.step import generate_step  # noqa: F401
