"""SOIEngine (port of ``repro.engine.soi_engine``): slot-based continuous
batching over the per-token generate step.

Two cache layouts, selected by ``paged``:

* dense rings (default): every slot owns ``max_len`` rows of every layer's
  ring cache (the middle's hold ``soi_mid_len`` frames);
* paged pools: slots hold page *lists* into pools shared by every slot
  (``repro_torch.engine.pages``), allocated on insert, grown one page at a
  time as a slot's clock crosses a page boundary, and released on
  ``free_slot``. The SOI middle pages at 1/stride the outer rate.

Prompts are padded to a bucket length (``prefill_buckets``, default "pow2")
and masked by their true length, or, with ``prefill_chunk=C``, appended C
tokens at a time by the chunk program looped on the host.

``prefix_cache=True`` (needs ``paged`` and ``prefill_chunk``) layers the
copy-on-write prefix page cache on top: a host-side chain-hash index over
token-id page blocks maps a prompt's leading pages to pages already in the
pools. On a hit, chunked prefill skips the cached chunks: it copies the
cached pages into the batch-1 prefill buffer (hydration, bit-identical
K/V), restores the SOI conv window and queue from the entry's host
snapshots and resumes at the cached boundary; ``insert`` maps the shared
pages by refcount instead of copying. A decode write into a shared page
first copies it into a fresh page (COW), so sharers never observe each
other. Entries pin their pages and are evicted LRU under pool pressure.

The engine keeps a host mirror of every slot's clock (``_clock``) and
occupancy (``_occupied``). From them it tells the step, as a Python bool,
whether some active slot sits at SOI phase 0 — the middle's skip needs no
device read — and it decides every page allocation. ``insert`` sets the
slot's clock to the prompt's true length (the reference's dense insert
leaves its host clock as it was; its paged insert sets it).

The decode state is updated in place: ``insert`` copies a prefix into a
slot's rows or pages, ``generate`` writes each slot's new K/V, clocks,
queue, conv window and next tokens, ``free_slot`` scrubs the slot's rows or
freed pages. A paged engine drives ONE live decode state and must see every
``insert`` / ``generate`` / ``free_slot`` of it. Page maps live on the
device as fixed int32 tensors; a changed host table is copied into its
tensor (through a fresh pinned buffer) only when its ``version`` has moved.

``generate`` runs the reference's ``_gen`` — the step, the argmax and the
(B, 3) result stack — as one ``contracts.CheckedGraph`` over the live
decode state, with the SOI branch (``run_mid_any``) as its static key: on
the card two CUDA graphs (the middle and no middle; one for a plain
config), each captured at its first step and replayed from then on; on the
CPU the same code runs eagerly. There is no switch between the two: the
device decides. The COW flush, the scrub, ``insert`` and the page-map
copies stay outside the graph, before the replay, and write the tensors
the graph reads in place. ``init_decode_state`` drops the graphs.

``speculate=K`` serves through self-speculative windows
(``engine.speculative``): ``generate`` runs K-1 draft steps, restores the
rows they wrote, and verifies against the true schedule — up to K tokens a
slot a call, greedy tokens identical to the plain engine's. The window
(draft, restore and verify) is one ``CheckedGraph`` over the live state,
``spec_step``, whose static key is K and the verify's branch pattern: the
K-tuple of ``run_mid_any`` values the host clocks give if every
speculating slot committed every iteration (a superset of the reference's
per-iteration ``lax.cond``, and exact: a middle that runs with no
committing slot writes only the null page). Paged engines back all K
candidate positions before the window and drop the pages of rejected ones
after it. The accepted counts gate the host clocks and the page rollback,
so each window makes the reference's one sanctioned drain (``host_get``)
and its ``ResultTokens`` carries host data. ``insert(...,
speculate=False)`` opts a request out: it commits one token a window.

``telemetry=True`` adds the per-step metrics vector
(``step.step_metrics``: phase occupancy over ``t % stride``, whether the
middle ran, the active-slot count) to every ``ResultTokens.metrics``. It
is computed inside the graph from the clocks the step starts from, one
more output of ``gen_step`` (a window: sampled once from the clocks
before it, inside ``spec_step``'s graph), so it needs no host read. On
the card the plain step packs it with the result rows into one buffer
behind one host copy and one event; ``convert_to_numpy`` drains both in
one ``host_get``. A window drains it in its own ``host_get`` with the
result rows. Telemetry off, the steps return no vector and the graphs
are the ones captured before the option existed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelCfg
from repro_torch.engine.api import Engine, Prefix, ResultTokens
from repro_torch.engine.contracts import (CheckedGraph, host_copy_async,
                                          host_get)
from repro_torch.engine.pages import (PageTable, PrefixEntry, PrefixIndex,
                                      chain_keys)
from repro_torch.engine.speculative import speculative_window
from repro_torch.engine.step import generate_step, step_metrics
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import decode as D
from repro_torch.models.transformer import cast_params


def _table_groups(cfg: ModelCfg) -> dict:
    """The cache groups each page table ("outer", "mid") backs."""
    if cfg.soi is None:
        return {"outer": ("segments",)}
    return {"outer": ("pre", "post"), "mid": ("mid",)}


def _paged_put(pool, dense, rows):
    """Map a batch-1 dense prefill cache ``dense`` (1, s_log, ...) onto pool
    rows ``rows`` ((n_pp,) page ids), in place. Entries 0 land on the null
    page: prefix rows past the allocated prompt pages, and rows covered by
    *shared* pages, which must never be re-written, are discarded."""
    n_pp = rows.shape[0]
    vals = dense[0].reshape((n_pp, pool.shape[1]) + tuple(pool.shape[2:]))
    pool[rows.long()] = vals.to(pool.dtype)


@torch.no_grad()
def insert_state(cfg: ModelCfg, dst: dict, src: dict, slot: int, *,
                 page_rows=None) -> dict:
    """Copy the batch-1 model state ``src`` into slot ``slot`` of ``dst``, in
    place: clock, every layer's K/V/positions (RG-LRU layers: ``h`` and the
    conv window) and, for SOI, the conv window and the queue. With
    ``page_rows`` ({"outer": (n_pp,), "mid": (n_ppm,)} write targets) the
    attention caches go into the pools' pages instead of batch rows; 0
    entries (shared or unbacked pages) write onto the null page. RG-LRU
    states are per slot in both layouts: they go into the slot's row."""
    dst["t"][slot] = src["t"][0]
    if cfg.soi is not None:
        for key in ("conv_buf", "queue"):
            dst[key][slot].copy_(src[key][0])
    for table, groups in _table_groups(cfg).items():
        prow = None if page_rows is None else page_rows[table]
        for group in groups:
            for d_c, s_c in zip(dst[group], src[group]):
                pooled = prow is not None and D.is_attn_cache(d_c)
                for name, d_leaf in d_c.items():
                    if pooled:
                        _paged_put(d_leaf, s_c[name], prow)
                    else:
                        d_leaf[slot].copy_(s_c[name][0])
    return dst


def _metrics(ds: dict, stride: int | None):
    """The telemetry vector of the clocks ``ds`` holds now (before the
    step writes them), or None with telemetry off (``stride`` None)."""
    if stride is None:
        return None
    return step_metrics(ds["model"]["t"], ds["active"], stride)


@torch.no_grad()
def gen_step(params, cfg: ModelCfg, ds: dict, run_mid_any: bool,
             stride: int | None = None):
    """The engine's device step (the reference's ``_gen``): one
    ``generate_step`` over every slot, the greedy next tokens written into
    ``ds["tokens"]`` in place, and the (B, 3) int32 result rows [token,
    valid, length]. ``stride`` (telemetry on) adds the step's metrics
    vector, from the clocks before the step. Returns ``(ds, data, logits,
    metrics)``, ``metrics`` None with telemetry off."""
    met = _metrics(ds, stride)
    logits, ms = generate_step(params, cfg, ds["model"], ds["tokens"],
                               active=ds["active"], run_mid_any=run_mid_any)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    data = torch.stack([nxt, ds["active"].to(torch.int32), ms["t"]], dim=1)
    ds["tokens"].copy_(nxt)
    return ds, data, logits, met


@torch.no_grad()
def spec_step(params, cfg: ModelCfg, ds: dict, spec, key: tuple,
              stride: int | None = None):
    """The engine's speculative window (the reference's ``_specgen``):
    ``speculative_window`` over every slot with ``key`` = (K, the verify's
    branch pattern), the feedback tokens written into ``ds["tokens"]`` in
    place, and the (B, K+3) int32 result rows [tok_0..tok_{K-1}, valid,
    length, accepted]. ``stride`` (telemetry on) adds one metrics vector a
    window, from the clocks before it. Returns ``(ds, data, logits,
    metrics)``."""
    met = _metrics(ds, stride)
    k, run_mid = key
    ms, committed, n_acc, nxt, logits = speculative_window(
        params, cfg, ds["model"], ds["tokens"], k=k, active=ds["active"],
        spec=spec, run_mid=run_mid)
    data = torch.cat([committed, torch.stack(
        [ds["active"].to(torch.int32), ms["t"], n_acc], dim=1)], dim=1)
    ds["tokens"].copy_(nxt)
    return ds, data, logits, met


def _attn_caches(caches):
    """The attention caches (rings or pools) of a cache group, RG-LRU
    states left out."""
    return [c for c in caches if D.is_attn_cache(c)]


class SOIEngine(Engine):
    """Engine over the per-token step; handles SOI and plain configs alike.

    The decode state is ``{"model": <per-slot caches/clocks>, "tokens": (B,),
    "active": (B,)}``: ``tokens`` holds each slot's next input token (the
    greedy feedback, written in place; harnesses force inputs by writing
    into it — on the CPU they may also pass a state with another
    ``tokens`` tensor, which the card's graph refuses), ``active`` gates
    result validity.

    ``paged=True`` swaps the dense rings for shared page pools.
    ``n_pages`` / ``n_pages_mid`` size the pools (pool rows, the null page
    included); the default, ``slots * pages_per_slot + 1``, backs every
    slot at full length. Servers shrink the pools to the resident token
    population: the page tables then enforce it, ``can_insert`` defers a
    request the pools cannot back, and an allocation the pools cannot
    meet raises.
    ``prefill_chunk=C`` switches to chunked prefill; ``prefix_cache=True``
    (needs both) shares prompt-prefix pages copy-on-write.
    ``speculate=K`` (>= 1) serves through draft and verify windows.
    ``telemetry=True`` attaches the per-step metrics vector to every
    result (``ResultTokens.metrics``; see the module docstring).
    """

    def __init__(self, cfg: ModelCfg, *, max_concurrent_decodes: int = 8,
                 max_len: int = 256, device=None, paged: bool = False,
                 page_size: int = 16, n_pages: int | None = None,
                 n_pages_mid: int | None = None, prefill_buckets="pow2",
                 prefill_chunk: int | None = None,
                 prefix_cache: bool = False, speculate: int | None = None,
                 telemetry: bool = False):
        if speculate is not None and int(speculate) < 1:
            raise ValueError(f"speculate must be >= 1, got {speculate}")
        self.cfg = cfg
        # the stride of the telemetry vector, None with telemetry off
        self._metrics_stride = ((cfg.soi.stride if cfg.soi is not None
                                 else 1) if telemetry else None)
        self.max_len = int(max_len)
        self.device = resolve_device(device)
        self._slots = int(max_concurrent_decodes)
        self._occupied = np.zeros(self._slots, bool)
        self._clock = np.zeros(self._slots, np.int64)
        self._masked_ok = D.supports_masked_prefill(cfg)
        self._buckets = self._resolve_buckets(prefill_buckets)
        self._chunk = int(prefill_chunk) if prefill_chunk else None
        if self._chunk is not None:
            if not self._masked_ok:
                raise ValueError(f"chunked prefill is unsupported for config "
                                 f"'{cfg.name}' (see "
                                 f"models.decode.supports_masked_prefill)")
            if cfg.soi is not None and self._chunk % cfg.soi.stride:
                raise ValueError(
                    f"prefill_chunk {self._chunk} must be a multiple of the "
                    f"SOI stride {cfg.soi.stride}")
            if self._chunk > self.max_len:
                raise ValueError(f"prefill_chunk {self._chunk} exceeds "
                                 f"max_len {self.max_len}")
        self._paged = bool(paged)
        self._spec = None                 # PagedKV geometry when paged
        self._pt_outer = self._pt_mid = None
        if self._paged:
            outer_len, mid_len = D.paged_group_lens(cfg, self.max_len)
            for name, ln in (("outer", outer_len), ("middle", mid_len)):
                if ln and ln % page_size:
                    raise ValueError(f"page_size {page_size} must divide the "
                                     f"{name} cache length {ln}")
            if n_pages is None:
                n_pages = self._slots * (outer_len // page_size) + 1
            if n_pages_mid is None:
                n_pages_mid = self._slots * (mid_len // page_size) + 1
            self._outer_len, self._mid_len = outer_len, mid_len
            self._spec = attn.PagedKV(page_size, max(int(n_pages), 2),
                                      max(int(n_pages_mid), 2))
        self._prefix_cache = bool(prefix_cache)
        self._prefix_index = PrefixIndex()
        self._pc_stats = {"hits": 0, "misses": 0, "tokens_skipped": 0,
                          "pages_shared": 0, "cow_copies": 0, "evictions": 0}
        if self._prefix_cache:
            if not self._paged:
                raise ValueError("prefix_cache=True requires paged=True "
                                 "(sharing maps pool pages across slots)")
            if self._chunk is None:
                raise ValueError("prefix_cache=True requires prefill_chunk: "
                                 "the prefill skip fast-forwards the chunk "
                                 "loop past cached chunks")
            align = math.lcm(self._chunk, self._spec.page_size)
            if cfg.soi is not None:
                # middle pages hold page_size frames = page_size*stride
                # tokens: a boundary must close a middle page exactly
                align = math.lcm(align, cfg.soi.stride * self._spec.page_size)
            if align > self.max_len:
                raise ValueError(
                    f"prefix-cache boundary alignment {align} (lcm of chunk, "
                    f"page size, stride*page size) exceeds max_len "
                    f"{self.max_len}: no prompt could ever hit")
            self._pc_align = align
        # COW pairs found while backing a step's writes, flushed right before
        # the step (or before any eviction scrub, which could otherwise free
        # and scrub a pending pair's source page first)
        self._cow_pending = {"outer": [], "mid": []}
        # PageTable.version of each page map's last device upload
        self._pm_version = {"outer": -1, "mid": -1}
        self._live = None           # the ONE live decode state (paged)
        # host-side step counters: generate steps, and steps in which the
        # compressed middle ran (some active slot at phase 0)
        self.steps = 0
        self.mid_steps = 0
        # COW flushes that copied pages (one copy_pages launch each)
        self.cow_flushes = 0
        # the device step, one graph per SOI branch on the card
        stride = self._metrics_stride
        self.graph = CheckedGraph(
            lambda params, ds, mid: gen_step(params, cfg, ds, mid, stride),
            state_argnums=(1,), static_argnums=(2,), name="generate")
        self._speculate = None if speculate is None else int(speculate)
        # which slots run speculative windows (insert(..., speculate=...));
        # the others commit exactly one token a window
        self._spec_slots = np.zeros(self._slots, bool)
        # fresh pages backed for a window's candidate positions, per slot:
        # (table, page-map index, first backed position) — consumed after
        # the window (rejected positions' pages are dropped), cleared by
        # free_slot so a freed request never leaks speculative pages
        self._spec_pending = [[] for _ in range(self._slots)]
        self.spec_stats = {"windows": 0, "slot_windows": 0, "committed": 0,
                           "draft_candidates": 0, "draft_accepted": 0}
        # window keys passed since init_decode_state (on the card: one
        # capture each), and verify steps that ran the middle since
        # construction (as spec_stats)
        self.spec_keys = set()
        self.spec_mid_iters = 0
        # the spec mask on the device (a fixed tensor the window graph
        # reads) and the host mask it last took
        self._spec_dev = None
        self._spec_dev_host = None
        # the window, one graph per key on the card
        self.spec_graph = CheckedGraph(
            lambda params, ds, spec, key: spec_step(params, cfg, ds, spec,
                                                    key, stride),
            state_argnums=(1,), static_argnums=(3,), name="spec_window")

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

    @property
    def telemetry(self) -> bool:
        """Does every result carry the per-step metrics vector?"""
        return self._metrics_stride is not None

    @property
    def speculate(self) -> int | None:
        """K of a speculative engine, else None."""
        return self._speculate

    @property
    def prefix_cache_enabled(self) -> bool:
        return self._prefix_cache

    @property
    def prefix_cache_stats(self) -> dict:
        """Prefix-cache counters: lookup hits/misses (+ ``hit_rate``), prompt
        tokens whose prefill was skipped, pages mapped by refcount instead
        of copied (never the null page), COW copies, LRU evictions, and the
        live index ``entries``. They reset with ``init_decode_state``."""
        s = dict(self._pc_stats)
        total = s["hits"] + s["misses"]
        s["hit_rate"] = s["hits"] / total if total else 0.0
        s["entries"] = len(self._prefix_index)
        return s

    def pool_stats(self) -> dict:
        """Page-pool residency per cache group (paged engines; {} dense):
        real pages, free, used, and the lifetime high-water mark."""
        out = {}
        for name, pt in (("outer", self._pt_outer), ("mid", self._pt_mid)):
            if pt is not None:
                out[name] = {"n_pages": pt.n_pages - 1,
                             "free": pt.free_pages, "used": pt.used_pages,
                             "high_water": pt.high_water}
        return out

    # -- page maps, COW, scrub -------------------------------------------

    def _tables(self):
        return (("outer", self._pt_outer), ("mid", self._pt_mid))

    def _upload_map(self, name: str, pt: PageTable) -> torch.Tensor:
        """The host table's map staged for its upload: a fresh host copy,
        pinned on the card. The caching host allocator keeps a pinned
        buffer until the copy from it has run, so a later host mutation of
        ``pt.map`` or a later upload can never race with the transfer, and
        the host does not wait for it."""
        self._pm_version[name] = pt.version
        src = torch.from_numpy(pt.map)
        return src.pin_memory() if self.device.type == "cuda" else src.clone()

    def _refresh_page_maps(self, model: dict) -> dict:
        """Copy only the page maps whose host table changed since their
        last upload into their fixed device tensors (the ones a captured
        step reads); a steady-state step costs no host->device copy."""
        for name, pt in self._tables():
            if pt is not None and self._pm_version[name] != pt.version:
                model["pages"][name].copy_(self._upload_map(name, pt),
                                           non_blocking=True)
        return model

    def _ids(self, pids) -> torch.Tensor:
        return torch.tensor(np.asarray(pids, np.int32), dtype=torch.int32,
                            device=self.device)

    def _flush_cow(self, decode_state):
        """Copy every pending COW pair into every pool leaf (k, v, pos or
        latent, rope, pos of each attention layer) of its page table's cache
        groups: one ``copy_pages_leaves`` launch for the whole flush."""
        pending = self._cow_pending
        if not pending["outer"] and not pending["mid"]:
            return decode_state
        self._cow_pending = {"outer": [], "mid": []}
        model = decode_state["model"]
        pools, srcs, dsts = [], [], []
        for table, pairs in pending.items():
            if not pairs:
                continue
            src, dst = np.asarray(pairs, np.int64).T
            for key in _table_groups(self.cfg)[table]:
                for c in _attn_caches(model[key]):
                    pools.extend(c.values())
            srcs += [src] * (len(pools) - len(srcs))
            dsts += [dst] * (len(pools) - len(dsts))
        if pools:
            kops.copy_pages_leaves(pools, srcs, dsts)
            self.cow_flushes += 1
        self._live = decode_state
        return decode_state

    @torch.no_grad()
    def _scrub(self, decode_state, freed: dict):
        """Mark freed pages empty (pos = -1) in every pool of their group,
        so a later owner cannot read a freed request's tokens."""
        model = decode_state["model"]
        for table, pids in freed.items():
            if len(pids) == 0:
                continue
            rows = self._ids(pids).long()
            for key in _table_groups(self.cfg)[table]:
                for c in _attn_caches(model[key]):
                    c["pos"][rows] = -1
        self._live = decode_state
        return decode_state

    def init_decode_state(self, params):
        params = cast_params(params, self.cfg)
        self._check_params(params)
        ms = D.init_decode_state(params, self.cfg, self._slots,
                                 max_len=self.max_len, paged=self._spec)
        # the graphs were captured over the old state
        self.graph.reset()
        self.spec_graph.reset()
        self.spec_keys = set()
        self._spec_slots[:] = False
        self._spec_pending = [[] for _ in range(self._slots)]
        self._spec_dev = torch.zeros(self._slots, dtype=torch.bool,
                                     device=self.device)
        self._spec_dev_host = np.zeros(self._slots, bool)
        self._occupied[:] = False
        self._clock[:] = 0
        self._cow_pending = {"outer": [], "mid": []}
        # a fresh decode state invalidates every resident page: the prefix
        # index and its counters restart with it
        self._prefix_index = PrefixIndex()
        self._pc_stats = {k: 0 for k in self._pc_stats}
        if self._paged:
            p_sz = self._spec.page_size
            self._pt_outer = (PageTable(self._slots, self._outer_len, p_sz,
                                        self._spec.n_pages)
                              if self._outer_len else None)
            self._pt_mid = (PageTable(self._slots, self._mid_len, p_sz,
                                      self._spec.n_pages_mid)
                            if self._mid_len else None)
            ms["pages"] = {name: self._upload_map(name, pt).to(self.device)
                           for name, pt in self._tables() if pt is not None}
        state = {"model": ms,
                 "tokens": torch.zeros(self._slots, dtype=torch.int32,
                                       device=self.device),
                 "active": torch.zeros(self._slots, dtype=torch.bool,
                                       device=self.device)}
        self._live = state
        return state

    def _check_params(self, params):
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params are on {params.embed.device}, the "
                             f"engine on {self.device}")

    # -- prefix-cache host machinery -------------------------------------

    def _lookup_prefix(self, toks: np.ndarray, tl: int, keys: dict):
        """Longest registered boundary R (aligned, at least one chunk below
        ``tl``) whose tokens [0, R) are cached. Returns (R, key, entry) or
        None."""
        a = self._pc_align
        r_max = ((tl - 1) // self._chunk) * self._chunk
        r_max = (r_max // a) * a
        for r in range(r_max, a - 1, -a):
            key = keys.get(r)
            if key is None:
                continue
            e = self._prefix_index.get(key, toks[:r])
            if e is not None and e.length == r:
                return r, key, e
        return None

    def _evict_entry(self, decode_state):
        """Drop the LRU prefix-index entry; scrub the pages it held last."""
        # pending COW copies land first: the eviction may free (and scrub)
        # the last reference to a pending pair's source page
        decode_state = self._flush_cow(decode_state)
        e = self._prefix_index.pop_lru()
        if e is None:
            return decode_state
        self._pc_stats["evictions"] += 1
        freed = {"outer": [p for p in e.outer_pages
                           if self._pt_outer.unpin(p)]}
        if self._pt_mid is not None:
            freed["mid"] = [p for p in e.mid_pages if self._pt_mid.unpin(p)]
        return self._scrub(decode_state, freed)

    def _make_room(self, pt, n: int, decode_state):
        """Evict prefix-index entries (LRU) until ``pt`` has ``n`` free
        pages or the index is empty; allocation stays the authority on
        exhaustion."""
        while (pt.free_pages < n and self._prefix_cache
               and len(self._prefix_index)):
            decode_state = self._evict_entry(decode_state)
        return decode_state

    def _shared_plan(self, meta, true_len: int) -> tuple:
        """Resolve a prefill-time hit into {logical page: page id} adoption
        maps against the *current* index (the hit's pages may have been
        evicted since; the hydrated prefill state keeps the insert correct
        either way). Ring pages the prompt's suffix wrapped onto are left
        out: they diverged in the prefill buffer."""
        if (not self._prefix_cache or not meta or not meta.get("hit")
                or self._pt_outer is None):
            return {}, {}
        r = meta["hit"]
        e = self._prefix_index.get(meta["hit_key"], meta["tokens"][:r])
        if e is None or e.length != r:
            return {}, {}
        p_sz = self._spec.page_size
        s_log = self._pt_outer.logical_len
        over = set()
        if true_len > r:
            for p in range(max(r, true_len - s_log), true_len):
                over.add((p % s_log) // p_sz)
        shared_outer = {i: e.outer_pages[i] for i in range(r // p_sz)
                        if i not in over and e.outer_pages[i] > 0}
        shared_mid = {}
        if self._pt_mid is not None:
            st = self.cfg.soi.stride
            m_log = self._pt_mid.logical_len
            f_r, f_t = r // st, -(-true_len // st)
            over_m = set()
            if f_t > f_r:
                for fp in range(max(f_r, f_t - m_log), f_t):
                    over_m.add((fp % m_log) // p_sz)
            shared_mid = {i: e.mid_pages[i] for i in range(f_r // p_sz)
                          if i not in over_m and e.mid_pages[i] > 0}
        return shared_outer, shared_mid

    def _register_prefix(self, s_i: int, meta: dict, tl: int):
        """Pin and index the inserted slot's full prefix pages at every
        aligned boundary, so later prompts sharing those token blocks hit.
        Skipped when the prefill wrapped a ring (page contents then depend
        on the whole length, not the prefix)."""
        pt_o, pt_m = self._pt_outer, self._pt_mid
        if pt_o is None or tl > pt_o.logical_len:
            return
        st = self.cfg.soi.stride if self.cfg.soi is not None else 1
        if pt_m is not None and -(-tl // st) > pt_m.logical_len:
            return
        p_sz = self._spec.page_size
        soi = self.cfg.soi is not None
        for b in sorted(meta["keys"]):
            key = meta["keys"][b]
            if b > tl or key in self._prefix_index:
                continue
            if soi and b not in meta["snapshots"]:
                continue        # no carry snapshot: cannot resume here
            outer = tuple(int(pt_o.map[s_i, j]) for j in range(b // p_sz))
            midp = ()
            if pt_m is not None:
                midp = tuple(int(pt_m.map[s_i, j])
                             for j in range((b // st) // p_sz))
            if any(p <= 0 for p in outer) or any(p <= 0 for p in midp):
                continue        # never index the null page
            conv = queue = None
            if soi:
                conv, queue = meta["snapshots"][b]
            for p in outer:
                pt_o.pin(p)
            for p in midp:
                pt_m.pin(p)
            self._prefix_index.put(key, PrefixEntry(
                b, np.asarray(meta["tokens"][:b]).copy(), outer, midp,
                conv, queue))

    def _evictable_pages(self, pt, which: str) -> int:
        """Pages only the prefix index keeps alive (refs == pin count)."""
        if not self._prefix_cache or pt is None:
            return 0
        pins: dict = {}
        for e in self._prefix_index.entries():
            for pid in (e.outer_pages if which == "outer" else e.mid_pages):
                pins[pid] = pins.get(pid, 0) + 1
        return sum(1 for pid, c in pins.items() if pt.refs[pid] == c)

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
        """Admission check: can a ``true_length``-token prompt be backed now,
        counting free pages, the pages ``slot``'s release would free (when
        occupied) and those LRU eviction would free? Dense slots always have
        room. ``phase_align`` defers an insert whose slot would land off
        the batch's phase class (``True``: by up to stride-1 steps; an int
        bounds the wait)."""
        if phase_align:
            cap = (self.cfg.soi.stride - 1
                   if phase_align is True and self.cfg.soi is not None
                   else int(phase_align))
            if 0 < self.phase_gap(true_length) <= cap:
                return False
        if not self._paged or self._pt_outer is None:
            return True
        needs = [(self._pt_outer, "outer", true_length)]
        if self._pt_mid is not None:
            needs.append((self._pt_mid, "mid",
                          -(-true_length // self.cfg.soi.stride)))
        for pt, which, n in needs:
            have = (pt.freeable_after_release(slot)
                    if slot is not None and self._occupied[slot]
                    else pt.free_pages)
            have += self._evictable_pages(pt, which)
            if have < pt.pages_needed(n):
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
        if self._chunk is not None:
            return self._prefill_chunked(params, tokens, tl)
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

    @torch.no_grad()
    def _hydrate(self, ms: dict, rows: dict, n_tok: int, n_frames: int):
        """Fill the batch-1 prefill buffer's first ``n_tok`` rows (middle:
        ``n_frames``) from the live pools' pages ``rows``."""
        live = self._live["model"]
        for table, groups in _table_groups(self.cfg).items():
            limit = n_frames if table == "mid" else n_tok
            for group in groups:
                for d_c, p_c in zip(_attn_caches(ms[group]),
                                    _attn_caches(live[group])):
                    attn.hydrate_cache_prefix(d_c, p_c, rows[table], limit)

    def _prefill_chunked(self, params, tokens, tl: int) -> Prefix:
        """Host loop over the chunk program: pad the prompt to a chunk
        multiple, append chunk by chunk, keep the logits of the chunk that
        holds position true_length-1 (chunks past it are all pad and are
        not run).

        With the prefix cache, a hit at boundary R hydrates the cached
        pages into the fresh prefill buffer, restores the SOI conv window
        and queue from the entry's host snapshots, and starts the loop at
        chunk R/C. The final chunk always runs, so the first token never
        comes from the cache. At every aligned boundary the loop passes it
        takes a host snapshot of the SOI carries (a device read), which a
        later hit resumes from."""
        c = self._chunk
        n = (tl - 1) // c + 1
        pad = n * c - int(tokens.shape[1])
        if pad > 0:
            tokens = torch.nn.functional.pad(tokens, (0, pad))
        elif pad < 0:
            tokens = tokens[:, :n * c]
        ms = D.init_decode_state(params, self.cfg, 1, max_len=self.max_len)
        i0 = 0
        meta = None
        soi = self.cfg.soi is not None
        if self._prefix_cache:
            toks_np = tokens[0, :tl].cpu().numpy()
            block_keys = chain_keys(toks_np, self._spec.page_size)
            meta = {"hit": 0, "hit_key": None, "tokens": toks_np,
                    "keys": {b: k for b, k in block_keys.items()
                             if b % self._pc_align == 0},
                    "snapshots": {}}
            hit = self._lookup_prefix(toks_np, tl, block_keys)
            if hit is not None:
                r, key, e = hit
                rows = {"outer": self._ids(e.outer_pages)}
                if self._pt_mid is not None:
                    rows["mid"] = self._ids(e.mid_pages)
                self._hydrate(ms, rows, r,
                              r // self.cfg.soi.stride if soi else 0)
                if soi:
                    ms["conv_buf"] = e.conv_buf.to(self.device, copy=True)
                    ms["queue"] = e.queue.to(self.device, copy=True)
                i0 = r // c
                meta["hit"], meta["hit_key"] = r, key
                self._pc_stats["hits"] += 1
                self._pc_stats["tokens_skipped"] += r
            else:
                self._pc_stats["misses"] += 1
        logits = None
        for i in range(i0, n):
            logits, ms = D.prefill_chunk(params, self.cfg, ms,
                                         tokens[:, i * c:(i + 1) * c], i * c,
                                         tl)
            b = (i + 1) * c
            if (meta is not None and soi and b in meta["keys"]
                    and meta["keys"][b] not in self._prefix_index):
                meta["snapshots"][b] = (ms["conv_buf"].to("cpu", copy=True),
                                        ms["queue"].to("cpu", copy=True))
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        return Prefix(state=ms, first_token=first, logits=logits, length=tl,
                      true_length=tl, cache_meta=meta)

    # -- insert / generate / free ----------------------------------------

    def insert(self, prefix: Prefix, decode_state, slot: int,
               speculate: bool | None = None):
        """Install a prefilled request into ``slot`` (in place). Paged: back
        the prompt's pages (adopting a prefix hit's shared pages by
        refcount), copy the prefix into the fresh ones, and index the new
        prefix boundaries. ``speculate`` opts the request in or out of
        speculative windows on a speculative engine (default: in)."""
        s_i = int(slot)
        if not 0 <= s_i < self._slots:
            raise ValueError(f"slot {slot} out of range [0, {self._slots})")
        if speculate and self._speculate is None:
            raise ValueError("insert(speculate=True) needs an engine built "
                             "with speculate=K")
        spec = (self._speculate is not None if speculate is None
                else bool(speculate))
        if not self._paged:
            insert_state(self.cfg, decode_state["model"], prefix.state, s_i)
            self._install(decode_state, prefix, s_i, spec)
            return decode_state
        decode_state = self._flush_cow(decode_state)
        true_len = prefix.true_length
        frames = (-(-true_len // self.cfg.soi.stride)
                  if self.cfg.soi is not None else 0)
        meta = prefix.cache_meta
        shared_outer, shared_mid = self._shared_plan(meta, true_len)
        # hold the shared pages across the evictions/frees below: losing the
        # hit entry mid-insert must not free pages about to be adopted
        temp_pins = ([(self._pt_outer, p) for p in shared_outer.values()]
                     + [(self._pt_mid, p) for p in shared_mid.values()])
        for pt, pid in temp_pins:
            pt.pin(pid)
        try:
            fresh = []
            if self._pt_outer is not None:
                fresh.append((self._pt_outer,
                              self._pt_outer.pages_needed(true_len)
                              - len(shared_outer)))
            if self._pt_mid is not None:
                fresh.append((self._pt_mid,
                              self._pt_mid.pages_needed(frames)
                              - len(shared_mid)))
            if self._occupied[s_i]:
                # check capacity before releasing the slot, so a failure
                # leaves the old request in place
                for pt, need in fresh:
                    while (pt.freeable_after_release(s_i) < need
                           and self._prefix_cache
                           and len(self._prefix_index)):
                        decode_state = self._evict_entry(decode_state)
                    if pt.freeable_after_release(s_i) < need:
                        raise RuntimeError(
                            f"KV page pool exhausted: re-inserting into "
                            f"slot {s_i} needs {need} fresh pages but only "
                            f"{pt.free_pages} (+ the slot's own) are free")
                decode_state = self.free_slot(decode_state, s_i)
            for pt, need in fresh:
                decode_state = self._make_room(pt, need, decode_state)
            page_rows = {}
            try:
                for name, pt, n_pos, shared in (
                        ("outer", self._pt_outer, true_len, shared_outer),
                        ("mid", self._pt_mid, frames, shared_mid)):
                    if pt is not None:
                        _, write = pt.alloc_slot(s_i, n_pos, shared=shared)
                        page_rows[name] = self._ids(write)
                insert_state(self.cfg, decode_state["model"], prefix.state,
                             s_i, page_rows=page_rows)
            except Exception:
                # transactional: the slot's pages go back, adopted shared
                # pages drop their new reference, and freed pages are
                # scrubbed (a failed copy may have written some)
                freed = {name: [p for p in pt.release(s_i) if p > 0]
                         for name, pt in self._tables() if pt is not None}
                self._scrub(decode_state, freed)
                raise
        except Exception:
            decode_state = self._unpin_scrubbed(temp_pins, decode_state)
            raise
        decode_state = self._unpin_scrubbed(temp_pins, decode_state)
        self._pc_stats["pages_shared"] += (
            sum(1 for p in shared_outer.values() if p > 0)
            + sum(1 for p in shared_mid.values() if p > 0))
        self._install(decode_state, prefix, s_i, spec)
        if self._prefix_cache and meta:
            self._register_prefix(s_i, meta, true_len)
        return decode_state

    def _install(self, decode_state, prefix: Prefix, s_i: int, spec: bool):
        decode_state["tokens"][s_i] = prefix.first_token[0]
        decode_state["active"][s_i] = True
        self._clock[s_i] = prefix.true_length
        self._occupied[s_i] = True
        # set last: re-inserting into an occupied slot frees it first
        self._spec_slots[s_i] = spec
        self._live = decode_state

    def _unpin_scrubbed(self, temp_pins, decode_state):
        """Drop insert-scoped temp pins; scrub any page that hit refcount 0
        (possible only when the hit entry was evicted during the insert)."""
        freed = {"outer": [], "mid": []}
        for pt, pid in temp_pins:
            if pt.unpin(pid):
                freed["outer" if pt is self._pt_outer else "mid"].append(pid)
        return self._scrub(decode_state, freed)

    def _back_write_page(self, decode_state, pt: PageTable, slot: int,
                         pos: int, table: str):
        """Make the page this step's write lands on present and exclusive:
        allocate on first touch (grow-by-one), copy-on-write when the page
        is shared (another slot or a prefix-index pin references it).
        Returns ``(decode_state, fresh_idx)``: the page-map index of a
        first-touch allocation (a speculative window records it, so a
        rejected position's page can be dropped), else None."""
        idx = (pos % pt.logical_len) // pt.page_size
        pid = int(pt.map[slot, idx])
        if pid == 0:
            decode_state = self._make_room(pt, 1, decode_state)
            pt.ensure(slot, pos)
            return decode_state, idx
        if pt.refs[pid] > 1:
            if pt.free_pages < 1:
                decode_state = self._make_room(pt, 1, decode_state)
            if pt.refs[pid] > 1:   # eviction may have just unshared it
                old, new = pt.cow(slot, idx)
                # deferred: the step's whole COW set flushes at once,
                # right before the step
                self._cow_pending[table].append((old, new))
                self._pc_stats["cow_copies"] += 1
        return decode_state, None

    def generate(self, params, decode_state):
        """One step for every slot, in place. Returns (decode_state,
        ResultTokens). On the card the step replays the graph of its SOI
        branch (captured at the branch's first step); ``ResultTokens``
        holds copies of the graph's outputs, so the next step cannot
        overwrite them. A speculative engine runs one window instead."""
        if self._speculate is not None:
            return self._generate_spec(params, decode_state)
        params = cast_params(params, self.cfg)
        st = self.cfg.soi.stride if self.cfg.soi is not None else 1
        if self._paged:
            # back the row each live slot writes this step (grow-by-one and
            # COW off shared prefix pages), flush the copies, then hand the
            # changed maps to the step
            for slot in np.nonzero(self._occupied)[0]:
                t = int(self._clock[slot])
                if self._pt_outer is not None:
                    decode_state, _ = self._back_write_page(
                        decode_state, self._pt_outer, slot, t, "outer")
                if self._pt_mid is not None and t % st == 0:
                    decode_state, _ = self._back_write_page(
                        decode_state, self._pt_mid, slot, t // st, "mid")
            decode_state = self._flush_cow(decode_state)
            self._refresh_page_maps(decode_state["model"])
        run_mid_any = bool(np.any((self._clock % st == 0) & self._occupied))
        self.steps += 1
        self.mid_steps += int(run_mid_any)
        self._clock[self._occupied] += 1
        # a plain config has one branch: its step never reads the flag
        branch = run_mid_any if self.cfg.soi is not None else None
        _, data, logits, met = self.graph(params, decode_state, branch)
        host = ready = None
        if data.is_cuda:
            # the graph's static outputs: the next replay overwrites them.
            # One buffer, so the vector (if any) rides the rows' host copy
            n = data.numel()
            parts = [data.reshape(-1)] + ([met] if met is not None else [])
            buf = torch.cat(parts)
            data = buf[:n].view(data.shape)
            met = buf[n:] if met is not None else None
            logits = logits.clone()
            h, ready = host_copy_async(buf)
            host = (h[:n].view(data.shape),
                    h[n:] if met is not None else None)
        self._live = decode_state
        return decode_state, ResultTokens(data=data, logits=logits,
                                          metrics=met, host=host,
                                          ready=ready)

    # -- speculative windows ---------------------------------------------

    def _drop_spec_pending(self, slot: int):
        """Release every still-pending speculative page of ``slot``. No
        device scrub: a dropped page was written only by the draft, whose
        rows were restored, or through the null page."""
        for pt, idx, _pos in self._spec_pending[slot]:
            pt.drop(slot, idx)
        self._spec_pending[slot] = []

    def _back_spec_window(self, decode_state):
        """Back pages for every position a window might commit: K outer
        positions (1 for non-speculating slots) and every middle frame a
        phase-0 crossing inside the window would write. Over-backing is
        rolled back after the window; COW copies are kept (the page holds
        the right bytes, and the slot's clock will reach it)."""
        k = self._speculate
        st = self.cfg.soi.stride if self.cfg.soi is not None else 0
        for slot in np.nonzero(self._occupied)[0]:
            t0 = int(self._clock[slot])
            span = k if self._spec_slots[slot] else 1
            if self._pt_outer is not None:
                for pos in range(t0, t0 + span):
                    decode_state, fresh = self._back_write_page(
                        decode_state, self._pt_outer, slot, pos, "outer")
                    if fresh is not None:
                        self._spec_pending[slot].append(
                            (self._pt_outer, fresh, pos))
            if self._pt_mid is not None:
                for c in range(t0, t0 + span):
                    if c % st:
                        continue
                    decode_state, fresh = self._back_write_page(
                        decode_state, self._pt_mid, slot, c // st, "mid")
                    if fresh is not None:
                        self._spec_pending[slot].append(
                            (self._pt_mid, fresh, c // st))
        return decode_state

    def _rollback_spec_pages(self, n: np.ndarray):
        """Drop the fresh pages whose backed positions were all rejected.
        An outer page recorded at first-touch position ``pos`` held only
        positions >= pos of this window, so it survives iff ``pos``
        committed; a middle page recorded at frame ``f`` survives iff some
        committed clock value crossed phase 0 at frame >= f."""
        st = self.cfg.soi.stride if self.cfg.soi is not None else 0
        for slot in np.nonzero(self._occupied)[0]:
            if not self._spec_pending[slot]:
                continue
            t0 = int(self._clock[slot])      # clock BEFORE the window
            last = t0 + int(n[slot]) - 1     # last committed clock value
            f_hi = last // st if st else -1  # last committed frame...
            if st and f_hi * st < t0:
                f_hi = -1                    # ...if any crossing committed
            for pt, idx, pos in self._spec_pending[slot]:
                committed = (pos <= last if pt is self._pt_outer
                             else 0 <= f_hi and pos <= f_hi)
                if not committed:
                    pt.drop(slot, idx)
            self._spec_pending[slot] = []

    def _window_key(self) -> tuple:
        """(K, the verify's branch pattern) from the host clocks: iteration
        j runs the middle if an active slot — after iteration 0, a
        speculating one — would sit at phase 0 had it committed every
        iteration so far. None for a plain config (one branch)."""
        k = self._speculate
        if self.cfg.soi is None:
            return k, None
        st = self.cfg.soi.stride
        occ = self._occupied
        spec = occ & self._spec_slots
        return k, tuple(
            bool(np.any(((self._clock + j) % st == 0)
                        & (occ if j == 0 else spec)))
            for j in range(k))

    def _upload_spec_mask(self):
        """Copy the host's spec mask into its fixed device tensor when it
        changed (through fresh pinned staging on the card)."""
        if np.array_equal(self._spec_dev_host, self._spec_slots):
            return
        self._spec_dev_host = self._spec_slots.copy()
        src = torch.from_numpy(self._spec_dev_host.copy())
        if self.device.type == "cuda":
            src = src.pin_memory()
        self._spec_dev.copy_(src, non_blocking=True)

    def _generate_spec(self, params, decode_state):
        """One speculative window for every slot, in place: back the
        window's pages, replay the window's graph, drain its result rows
        (the accepted counts), advance the host clocks by them and drop the
        pages of rejected positions."""
        params = cast_params(params, self.cfg)
        k = self._speculate
        if self._paged:
            try:
                decode_state = self._back_spec_window(decode_state)
            except Exception:
                # transactional: a failed backing (pool exhausted mid-loop)
                # must not leak the pages already grown for this window;
                # COW pairs already recorded still describe real map state,
                # so their copies land on the live state
                for slot in range(self._slots):
                    self._drop_spec_pending(slot)
                self._flush_cow(self._live)
                raise
            decode_state = self._flush_cow(decode_state)
            self._refresh_page_maps(decode_state["model"])
        key = self._window_key()
        self._upload_spec_mask()
        self.spec_keys.add(key)
        _, data, logits, met = self.spec_graph(params, decode_state,
                                               self._spec_dev, key)
        # the accepted counts gate the host clocks and the page rollback,
        # so every window drains its result rows, and the telemetry vector
        # with them: the one sanctioned drain
        # sync-ok: accepted counts gate page rollback
        host, met = host_get((data, met))
        if logits.is_cuda:
            logits = logits.clone()      # the next replay overwrites it
        n = host[:, k + 2]
        if self._paged:
            self._rollback_spec_pages(n)
        occ = self._occupied
        self._clock[occ] += n[occ]
        s = self.spec_stats
        s["windows"] += 1
        s["slot_windows"] += int(occ.sum())
        s["committed"] += int(n[occ].sum())
        spec_occ = occ & self._spec_slots
        s["draft_candidates"] += int(spec_occ.sum()) * (k - 1)
        s["draft_accepted"] += int((n[spec_occ] - 1).sum())
        self.spec_mid_iters += sum(key[1] or ())
        self._live = decode_state
        return decode_state, ResultTokens(
            data=host, logits=logits, metrics=met, tokens_idx=(0, k),
            valid_idx=(k, k + 1), length_idx=(k + 1, k + 2),
            accepted_idx=(k + 2, k + 3))

    def spec_accept_stats(self) -> dict:
        """Accept-rate counters since engine construction: ``accept_rate``
        is the fraction of draft tokens the verifier kept;
        ``tokens_per_window`` the mean committed tokens a slot-window
        (at most K; 1.0 means speculation never paid off). Both are 0.0 on
        an idle engine."""
        s = dict(self.spec_stats)
        s["speculate"] = self._speculate
        s["accept_rate"] = (s["draft_accepted"] / s["draft_candidates"]
                            if s["draft_candidates"] else 0.0)
        s["tokens_per_window"] = (s["committed"] / s["slot_windows"]
                                  if s["slot_windows"] else 0.0)
        return s

    @torch.no_grad()
    def free_slot(self, decode_state, slot: int):
        """Mark ``slot`` unoccupied. Dense: scrub its cache positions
        (pos = -1), ``insert`` rewrites its rows on reuse. Paged: release
        its pages and scrub those whose refcount hit zero; shared pages
        keep their contents for the other holders."""
        s_i = int(slot)
        if not 0 <= s_i < self._slots:
            raise ValueError(f"slot {slot} out of range [0, {self._slots})")
        if not self._occupied[s_i]:
            raise ValueError(
                f"free_slot({s_i}): slot is not occupied — it was never "
                f"inserted into, or already freed (double-free)")
        # pending COW pairs land before this release can recycle a pair's
        # destination page
        decode_state = self._flush_cow(decode_state)
        self._occupied[s_i] = False
        # a freed request's pending draft tokens die with its active bit,
        # and its speculatively grown pages go with the release below: only
        # the host records are cleared, so no later rollback drops them
        self._spec_slots[s_i] = False
        self._spec_pending[s_i] = []
        model = decode_state["model"]
        if self._paged:
            freed = {name: [p for p in pt.release(s_i) if p > 0]
                     for name, pt in self._tables() if pt is not None}
            self._scrub(decode_state, freed)
            self._clock[s_i] = 0
        else:
            for groups in _table_groups(self.cfg).values():
                for group in groups:
                    for c in _attn_caches(model[group]):
                        c["pos"][s_i] = -1
        decode_state["active"][s_i] = False
        self._live = decode_state
        return decode_state
