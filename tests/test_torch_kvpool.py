"""The port's ``KVPool`` (``repro_torch.serve.kvpool``) against the
reference's, driven through the same seeded random sequence of operations:
allocate after ``match_prefix``, ``append_block``, ``ensure_writable``,
``seal_block``, ``truncate``, ``release``, ``forget`` and
``snapshot``/``restore``.  After every operation the two pools must have
returned the same value (or raised the same error) and hold the same
state: equal snapshots (free list, refcounts, hashes, LRU order, prefix
index, tables, chains, stats) and equal free, live, cached and holder
counts.  Exact: the allocator is integer bookkeeping."""

import numpy as np
import pytest

from repro.serve.kvpool import KVPool as RefPool
from repro_torch.serve.kvpool import KVPool
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

PREFIXES = [[1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 3, 4, 9, 9, 9, 9],
            [5, 5, 5, 5, 6, 6, 6, 6]]


def _call(pool, name, *args):
    try:
        return ("ok", getattr(pool, name)(*args))
    except (MemoryError, AssertionError, ValueError) as e:
        return ("raised", type(e).__name__)


def _state(pool):
    return (pool.snapshot(), pool.free_blocks, pool.live_blocks,
            pool.cached_blocks, pool.holders)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("prefix_cache", [True, False], ids=["prefix", "plain"])
def test_pool_matches_reference_op_by_op(seed, prefix_cache):
    rng = np.random.default_rng(seed)
    bs, nblocks = 4, 12 + 4 * (seed % 3)
    ref = RefPool(nblocks, bs, prefix_cache=prefix_cache)
    port = KVPool(nblocks, bs, prefix_cache=prefix_cache)
    assert _state(port) == _state(ref)
    live = {}            # rid → {"tokens", "sealed", "floor"}
    next_rid = 0
    ops = {"allocate": 0, "append_block": 0, "ensure_writable": 0,
           "seal_block": 0, "truncate": 0, "release": 0, "forget": 0,
           "restore": 0, "hit": 0}
    for step in range(300):
        kind = rng.choice(["allocate", "append", "cow", "seal", "truncate",
                           "release", "forget", "restore"],
                          p=[.25, .2, .1, .2, .08, .08, .04, .05])
        if kind == "allocate" or not live:
            base = PREFIXES[int(rng.integers(len(PREFIXES)))]
            tail = rng.integers(1, 4, size=int(rng.integers(1, 9))).tolist()
            tokens = base[: int(rng.integers(0, 9))] + tail
            off = int(rng.integers(0, 2))
            got = port.match_prefix(tokens, off)
            assert got == ref.match_prefix(tokens, off)
            shared, chain = got
            rid = next_rid
            next_rid += 1
            res = _call(port, "allocate", rid, len(tokens), shared, chain)
            assert res == _call(ref, "allocate", rid, len(tokens), shared,
                                chain)
            ops["allocate"] += 1
            if res[0] == "ok" and res[1] is not None:
                ops["hit"] += bool(shared)
                live[rid] = {"tokens": tokens, "sealed": len(shared),
                             "floor": max(1, len(shared))}
        else:
            rid = int(rng.choice(sorted(live)))
            st = live[rid]
            table = port.table(rid)
            if kind == "append":
                res = _call(port, "append_block", rid)
                assert res == _call(ref, "append_block", rid)
                if res[1] is not None:
                    st["tokens"] += rng.integers(1, 4, size=bs).tolist()
                ops["append_block"] += 1
            elif kind == "cow":
                logical = int(rng.integers(len(table)))
                res = _call(port, "ensure_writable", rid, logical)
                assert res == _call(ref, "ensure_writable", rid, logical)
                st["floor"] = max(st["floor"], logical + 1)
                ops["ensure_writable"] += 1
            elif kind == "seal":
                j = st["sealed"]
                toks = st["tokens"][j * bs:(j + 1) * bs]
                if j >= len(table) or len(toks) < bs:
                    continue
                res = _call(port, "seal_block", rid, j, toks)
                assert res == _call(ref, "seal_block", rid, j, toks)
                st["sealed"] += 1
                st["floor"] = max(st["floor"], st["sealed"])
                ops["seal_block"] += 1
            elif kind == "truncate":
                n = int(rng.integers(st["floor"], len(table) + 1))
                res = _call(port, "truncate", rid, n)
                assert res == _call(ref, "truncate", rid, n)
                st["tokens"] = st["tokens"][: n * bs]
                ops["truncate"] += 1
            elif kind in ("release", "forget"):
                assert _call(port, kind, rid) == _call(ref, kind, rid)
                del live[rid]
                ops[kind] += 1
            else:
                snap = port.snapshot()
                assert snap == ref.snapshot()
                drop = bool(rng.integers(2))
                port = KVPool(nblocks, bs, prefix_cache=prefix_cache)
                ref = RefPool(nblocks, bs, prefix_cache=prefix_cache)
                port.restore(snap, drop_unheld=drop)
                ref.restore(snap, drop_unheld=drop)
                ops["restore"] += 1
        assert _state(port) == _state(ref), (step, kind)
    # the sequence really exercised every operation
    assert all(n > 0 for k, n in ops.items() if k != "hit"), ops
    if prefix_cache:
        assert ops["hit"] > 0, ops


def test_pool_rejects_what_the_reference_rejects():
    for args in ((0, 4), (4, 0)):
        with pytest.raises(ValueError):
            RefPool(*args)
        with pytest.raises(ValueError):
            KVPool(*args)
    port, ref = KVPool(4, 4), RefPool(4, 4)
    snap = RefPool(5, 4).snapshot()
    for pool in (port, ref):
        with pytest.raises(ValueError, match="does not match"):
            pool.restore(snap)
