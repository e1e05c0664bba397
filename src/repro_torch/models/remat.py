"""Per-layer rematerialisation: the reference's ``jax.checkpoint`` around
each group of a scanned segment (``repro.models.transformer
._segment_forward``, ``cfg.remat`` / ``cfg.remat_policy``).

``remat_group`` runs one layer group — the ``len(seg.blocks)`` blocks of
the reference's scan body — under ``torch.utils.checkpoint.checkpoint``
(non-reentrant): the forward keeps the group's inputs, and the backward
runs the group again to rebuild what the group's own backward reads.
``cfg.remat_policy`` says what the group keeps besides, as the
reference's policies do:

* ``"full"`` and ``"none"``: nothing (the reference's ``"none"`` leaves
  ``policy=None``, which ``jax.checkpoint`` reads as saving nothing);
* ``"dots"``: every matmul's output (``checkpoint_dots``): aten's ``mm``,
  ``bmm``, ``addmm`` and ``baddbmm``, picked op by op by a selective
  checkpoint (``create_selective_checkpoint_contexts``). The hand-written
  kernels (``flash_attention``, ``lru_scan``) write their outputs through
  ctypes, out of the dispatcher's sight: the policy never saves them, so
  the backward launches their forwards again under every policy. Around
  the attention kernel "dots" keeps the q, k, v and output projections'
  matmuls; on the CPU the plain attention's own matmuls (scores and the
  weighted values) are saved too;
* ``"names"``: only the tensors tagged by ``checkpoint_name`` — the MLP's
  hidden, ``"ffn_hidden"`` (``save_only_these_names``).

The values do not depend on the policy: a recompute runs the same ops on
the same inputs, so loss and gradients are those of a run without remat,
bit for bit.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models.layers import layer_state, layer_state_as

_aten = torch.ops.aten
# the matmuls "dots" saves (torch.matmul and F.linear dispatch to these)
DOTS = frozenset({_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
                  _aten.baddbmm.default})

# the names a "names" group saves; the name being tagged, while it is
_SAVE_NAMES: frozenset = frozenset()
_NAMING = None


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``jax.ad_checkpoint.checkpoint_name``: ``x``; inside a layer group
    that saves ``name`` (``"names"``) a copy of ``x``, made by the one op
    that the group's policy saves."""
    global _NAMING
    if name not in _SAVE_NAMES:
        return x
    prev, _NAMING = _NAMING, name
    try:
        return x.clone()
    finally:
        _NAMING = prev


@contextlib.contextmanager
def _saving(names: frozenset):
    global _SAVE_NAMES
    prev, _SAVE_NAMES = _SAVE_NAMES, names
    try:
        yield
    finally:
        _SAVE_NAMES = prev


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_named(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if _NAMING is not None
            else CheckpointPolicy.PREFER_RECOMPUTE)


POLICIES = {"dots": _save_dots, "names": _save_named}
NAMES = {"names": frozenset({"ffn_hidden"})}


def remat_group(fn, policy: str, *args):
    """``fn(*args)`` — a layer group, tensors in and a tuple of tensors
    out — under a checkpoint that keeps what ``policy`` (a
    ``remat_policy``) says; the backward's recompute runs inside the
    layer contexts (``layers.layer_state``) of this call."""
    state = layer_state()
    names = NAMES.get(policy, frozenset())

    def run(*a):
        with layer_state_as(state), _saving(names):
            return fn(*a)
    kw = {}
    if policy in POLICIES:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, POLICIES[policy])
    # no block draws random numbers: no RNG state to stash and restore
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)
