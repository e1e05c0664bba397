"""repro_torch.engine.pages (the port's own copy of the page allocator and
the prefix index) against repro.engine.pages: the same seeded random
schedule of allocator and index operations drives both, and after every
operation the page maps, refcounts, versions, free lists and high-water
marks are identical, as are the raised errors and the LRU order."""

import jax  # noqa: F401  (JAX on the CPU, as conftest.py sets)
import numpy as np
import pytest
import torch

from repro.engine import pages as J
from repro_torch.engine import pages as P

torch.set_num_threads(1)


def _same_table(a, b):
    assert np.array_equal(a.map, b.map)
    assert np.array_equal(a.refs, b.refs)
    assert a.version == b.version
    assert a._free == b._free
    assert (a.high_water, a.free_pages, a.used_pages) == \
        (b.high_water, b.free_pages, b.used_pages)


def _both(fn_j, fn_p):
    """Run one operation on both tables; results and errors must agree."""
    try:
        want = fn_j()
    except (ValueError, RuntimeError) as e:
        with pytest.raises(type(e)):
            fn_p()
        return None
    got = fn_p()
    if isinstance(want, tuple):
        for w, g in zip(want, got):
            assert np.array_equal(w, g)
    elif isinstance(want, np.ndarray):
        assert np.array_equal(want, got)
    else:
        assert want == got
    return want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_table_matches_reference_on_random_schedule(seed):
    rng = np.random.default_rng(seed)
    n_slots, logical, p_sz, n_pages = 4, 32, 4, 20
    tj = J.PageTable(n_slots, logical, p_sz, n_pages)
    tp = P.PageTable(n_slots, logical, p_sz, n_pages)
    pins = []
    for _ in range(400):
        op = rng.integers(0, 7)
        slot = int(rng.integers(0, n_slots))
        if op == 0:                                   # insert (maybe shared)
            n_pos = int(rng.integers(1, logical + 8))
            shared = {}
            live = [int(p) for p in np.nonzero(tj.refs > 0)[0]]
            for i in range(min(2, -(-n_pos // p_sz))):
                if live and rng.random() < 0.5:
                    shared[i] = int(rng.choice(live))
            _both(lambda: tj.alloc_slot(slot, n_pos, shared=dict(shared)),
                  lambda: tp.alloc_slot(slot, n_pos, shared=dict(shared)))
        elif op == 1:                                 # decode growth
            pos = int(rng.integers(0, 3 * logical))
            _both(lambda: tj.ensure(slot, pos), lambda: tp.ensure(slot, pos))
        elif op == 2:                                 # copy-on-write
            idx = int(rng.integers(0, logical // p_sz))
            _both(lambda: tj.cow(slot, idx), lambda: tp.cow(slot, idx))
        elif op == 3:                                 # free
            _both(lambda: tj.release(slot), lambda: tp.release(slot))
        elif op == 4:                                 # index pin
            live = np.nonzero(tj.refs > 0)[0]
            pid = int(rng.choice(live)) if len(live) else 0
            if _both(lambda: tj.pin(pid), lambda: tp.pin(pid)) is None \
                    and pid and tj.refs[pid] > 0:
                pins.append(pid)
        elif op == 5 and pins:                        # index unpin
            pid = pins.pop(int(rng.integers(0, len(pins))))
            _both(lambda: tj.unpin(pid), lambda: tp.unpin(pid))
        elif op == 6:                                 # speculative drop
            idx = int(rng.integers(0, logical // p_sz))
            _both(lambda: tj.drop(slot, idx), lambda: tp.drop(slot, idx))
        _same_table(tj, tp)
        assert _both(lambda: tj.freeable_after_release(slot),
                     lambda: tp.freeable_after_release(slot)) is not None


def test_chain_keys_match_reference():
    toks = np.random.default_rng(3).integers(0, 1000, 61).astype(np.int32)
    for block in (4, 16):
        assert J.chain_keys(toks, block) == P.chain_keys(toks, block)


def test_prefix_index_matches_reference_lru_order():
    rng = np.random.default_rng(4)
    ij, ip = J.PrefixIndex(), P.PrefixIndex()
    toks = rng.integers(0, 50, 64).astype(np.int32)
    keys = J.chain_keys(toks, 4)
    for step in range(120):
        b = int(rng.choice(sorted(keys)))
        key = keys[b]
        op = rng.integers(0, 3)
        if op == 0:
            args = (b, toks[:b].copy(), (1, 2), (3,), None, None)
            _both(lambda: ij.put(key, J.PrefixEntry(*args)),
                  lambda: ip.put(key, P.PrefixEntry(*args)))
        elif op == 1:
            probe = toks[:b] if rng.random() < 0.8 else toks[1:b + 1]
            ej, ep = ij.get(key, probe), ip.get(key, probe)
            assert (ej is None) == (ep is None)
            if ej is not None:
                assert ej.length == ep.length
        else:
            ej, ep = ij.pop_lru(), ip.pop_lru()
            assert (ej is None) == (ep is None)
            if ej is not None:
                assert ej.length == ep.length
        assert len(ij) == len(ip)
        assert [e.length for e in ij.entries()] == \
            [e.length for e in ip.entries()]
        assert (key in ij) == (key in ip)
