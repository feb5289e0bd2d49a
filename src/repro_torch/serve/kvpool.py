"""Paged KV-cache block pool: host-side allocator for the serving engine
(DESIGN.md §6).  The port's own copy of the reference's
``serve/kvpool.py``, which imports no JAX but lives in a package that does.

The device side of the paged cache is a flat pool of fixed-size token
blocks per attention layer plus one shared logical→physical ``block_table``
per slot (models/transformer.init_cache(kv_layout="paged")); this module is
the host-side bookkeeping that decides *which* physical block backs which
logical block:

* **free-list allocation** — capacity scales with live tokens, not
  slots × max_len: a request holds ceil(tokens/bs) blocks, growing one
  block at a time as it decodes.
* **refcounted sharing + copy-on-write** — a full (sealed) block can back
  the same token prefix of many requests at once; writes only ever target
  a request's unsealed tail block, and ``ensure_writable`` copies a block
  out of sharing if a write would land on one with other holders.
* **prefix cache** — sealed blocks are content-addressed by a chained hash
  of (previous-block hash, block tokens): on admission the engine walks a
  new prompt's full blocks through ``match_prefix`` and skips prefilling
  the matched span.  This is sound *because* the dither-quantised codes in
  a block are a pure function of (values, absolute position + offset,
  element index) — the paper's deterministic-in-position Θ(1/N²)
  construction — never of which request or engine tick wrote them;
  stochastic-rounded caches could not be shared this way.  The chain seed
  carries the per-request counter offset for the int8 layout, so hits only
  occur between requests whose codes would be bit-identical.
* **LRU eviction** — blocks released by finished requests stay in the
  prefix cache at refcount 0 until the allocator needs them; allocation
  prefers truly-free blocks and evicts the least-recently-used cached
  block otherwise ("preempt-to-evict").

The pool knows nothing about torch: the engine mirrors its tables into
the device ``block_tables`` tensor when they change.  Physical ids run
0..num_blocks-1; id ``num_blocks`` is the device-side *trash block* that
absorbs writes through unallocated table entries — the pool never hands it
out.

The pool also knows nothing about meshes: under sharded serving
(DESIGN.md §9) the engine instantiates one ``KVPool`` *per data shard*
(capacity = admission budget of that shard) and keeps every request's
blocks, prefix hits, copy-on-write copies and deadlock-breaking inside its
home shard's pool.  Physical ids are then shard-local: each rank holds
its own shard's sub-pool (with its own trash block) on its device, and
every rank keeps all the shards' host pools, so the id space above never
changes shape.  Prefix sharing is consequently per data shard.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["KVPool"]


class KVPool:
    def __init__(self, num_blocks: int, block_size: int, *,
                 prefix_cache: bool = True):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_cache = prefix_cache
        self.trash = num_blocks                     # device-side dump block
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref = [0] * num_blocks
        self._hash: List[Optional[int]] = [None] * num_blocks
        # refcount-0 sealed blocks, insertion order = LRU order (oldest first)
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self._lookup: Dict[int, int] = {}           # chain hash → physical id
        self._tables: Dict[int, List[int]] = {}     # rid → logical order
        self._chain: Dict[int, int] = {}            # rid → sealed-chain hash
        self.stats = {"allocated": 0, "evicted": 0, "prefix_hit_blocks": 0,
                      "cow_copies": 0}
        # block-provenance hook (DESIGN.md §13): when set by a tracing
        # engine, called as on_event(kind, **fields) at eviction / prefix
        # hit / CoW / exhaustion; None (the default) costs nothing.
        self.on_event = None

    # ------------------------------------------------------------- inspection

    @property
    def free_blocks(self) -> int:
        """Blocks an allocation could obtain right now (free + evictable)."""
        return len(self._free) + len(self._cached)

    @property
    def live_blocks(self) -> int:
        """Blocks referenced by at least one request."""
        return self.num_blocks - self.free_blocks

    @property
    def cached_blocks(self) -> int:
        return len(self._cached)

    @property
    def holders(self) -> int:
        """Requests currently holding blocks (active or preempted-queued)."""
        return len(self._tables)

    def table(self, rid: int) -> List[int]:
        return list(self._tables.get(rid, ()))

    def blocks_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    # ------------------------------------------------------------ prefix hash

    @staticmethod
    def chain_hash(prev: int, tokens: Sequence[int]) -> int:
        return hash((prev, tuple(tokens)))

    def match_prefix(self, tokens: Sequence[int],
                     seed: int = 0) -> Tuple[List[int], int]:
        """Longest cached chain of *full* blocks covering a proper prefix of
        ``tokens`` → (physical blocks, chain hash after them).

        The walk is capped at ``len(tokens) - 1`` tokens so at least one
        real token remains to prefill (the engine needs its logits to seed
        sampling); ``seed`` namespaces the chain (the int8 layout passes
        the request's counter offset — codes quantised under different
        offsets are different bits and must never alias).
        """
        hits: List[int] = []
        h = seed
        if not self.prefix_cache:
            return hits, h
        bs = self.block_size
        max_blocks = max(0, (len(tokens) - 1) // bs)
        for j in range(max_blocks):
            h2 = self.chain_hash(h, tokens[j * bs:(j + 1) * bs])
            phys = self._lookup.get(h2)
            if phys is None:
                return hits, h
            hits.append(phys)
            h = h2
        return hits, h

    # ------------------------------------------------------------- allocation

    def _pop_block(self) -> Optional[int]:
        if self._free:
            self.stats["allocated"] += 1
            return self._free.pop()
        if self._cached:
            phys, _ = self._cached.popitem(last=False)   # LRU victim
            h = self._hash[phys]
            if h is not None and self._lookup.get(h) == phys:
                del self._lookup[h]
            self._hash[phys] = None
            self.stats["allocated"] += 1
            self.stats["evicted"] += 1
            if self.on_event is not None:
                self.on_event("block_evict", phys=phys,
                              cached=len(self._cached))
            return phys
        return None

    def _acquire(self, phys: int) -> None:
        if self._ref[phys] == 0:
            self._cached.pop(phys, None)
        self._ref[phys] += 1

    def allocate(self, rid: int, n_tokens: int,
                 shared: Sequence[int] = (),
                 chain: int = 0) -> Optional[List[int]]:
        """Build ``rid``'s block table for an ``n_tokens``-token prompt:
        take references on the ``shared`` prefix blocks (from
        ``match_prefix``) and allocate fresh blocks for the rest.  Returns
        the full table, or None (state unchanged) if the pool cannot supply
        the fresh blocks — the admission gate of continuous batching."""
        assert rid not in self._tables, f"request {rid} already allocated"
        total = self.blocks_needed(max(1, n_tokens))
        fresh_needed = total - len(shared)
        assert fresh_needed >= 0
        # shared blocks sitting in the LRU cache (refcount 0) are about to
        # be re-acquired — they stop being evictable, so they must not be
        # counted as capacity for the fresh blocks
        shared_cached = sum(1 for phys in set(shared) if self._ref[phys] == 0)
        if fresh_needed > self.free_blocks - shared_cached:
            return None
        for phys in shared:
            self._acquire(phys)
        fresh = []
        for _ in range(fresh_needed):
            phys = self._pop_block()
            assert phys is not None   # guarded by free_blocks above
            self._ref[phys] = 1
            fresh.append(phys)
        self._tables[rid] = list(shared) + fresh
        self._chain[rid] = chain
        self.stats["prefix_hit_blocks"] += len(shared)
        if self.on_event is not None and shared:
            self.on_event("prefix_hit", rid=rid, blocks=len(shared),
                          fresh=len(fresh))
        return list(self._tables[rid])

    def append_block(self, rid: int) -> Optional[int]:
        """Grow ``rid`` by one block (decode crossed a block boundary).
        Returns the physical id, or None if the pool is exhausted — the
        caller preempts-and-requeues the request with its blocks intact."""
        phys = self._pop_block()
        if phys is None:
            if self.on_event is not None:
                self.on_event("pool_exhausted", rid=rid,
                              live=self.live_blocks)
            return None
        self._ref[phys] = 1
        self._tables[rid].append(phys)
        return phys

    def ensure_writable(self, rid: int, logical: int) -> Tuple[int, bool]:
        """Copy-on-write guard: the engine calls this before any write to
        ``rid``'s logical block.  If the backing block is shared (refcount
        > 1) a fresh private block is allocated and installed in the table;
        the caller must copy the device contents across and refresh the
        device block table.  Returns (physical id, copied?)."""
        phys = self._tables[rid][logical]
        if self._ref[phys] <= 1:
            return phys, False
        fresh = self._pop_block()
        if fresh is None:
            raise MemoryError("pool exhausted during copy-on-write")
        self._ref[phys] -= 1
        self._ref[fresh] = 1
        self._tables[rid][logical] = fresh
        self.stats["cow_copies"] += 1
        if self.on_event is not None:
            self.on_event("cow_copy", rid=rid, logical=logical)
        return fresh, True

    # ---------------------------------------------------------------- sealing

    def seal_block(self, rid: int, logical: int,
                   tokens: Sequence[int]) -> None:
        """Register ``rid``'s full logical block in the prefix cache under
        the chained content hash.  Only sealed blocks are shareable; the
        engine seals prompt blocks *after* their prefill dispatch returns
        (a same-wave hit would race the device scatter) and decode blocks
        when they fill."""
        if not self.prefix_cache:
            return
        assert len(tokens) == self.block_size
        phys = self._tables[rid][logical]
        h = self.chain_hash(self._chain[rid], tokens)
        self._chain[rid] = h
        if self._ref[phys] == 1 and self._hash[phys] is None \
                and h not in self._lookup:
            self._hash[phys] = h
            self._lookup[h] = phys

    def truncate(self, rid: int, n_blocks: int) -> List[int]:
        """Give back ``rid``'s tail blocks beyond the first ``n_blocks`` —
        the speculative-decode rollback path (DESIGN.md §14): draft coverage
        allocated ahead of a verify forward can outrun the committed
        position when a suffix is rejected.  Only unsealed, uniquely-owned
        tail blocks are ever truncated (the engine seals nothing until
        tokens commit), so popping reverses ``append_block`` exactly — the
        ids return to the free-list end they were taken from, leaving the
        allocator byte-identical to one that never over-allocated.  Returns
        the popped ids (newest first) so the engine can reset their
        block-table entries."""
        table = self._tables[rid]
        assert n_blocks >= 1
        popped = []
        while len(table) > n_blocks:
            phys = table[-1]
            assert self._ref[phys] == 1 and self._hash[phys] is None, \
                "spec rollback must only drop unsealed private tail blocks"
            table.pop()
            self._ref[phys] = 0
            self._free.append(phys)
            popped.append(phys)
        return popped

    # ---------------------------------------------------------------- release

    def release(self, rid: int) -> None:
        """Drop ``rid``'s references.  Sealed blocks at refcount 0 stay in
        the prefix cache (LRU-evictable); unsealed ones return to the free
        list immediately."""
        for phys in self._tables.pop(rid, ()):
            self._ref[phys] -= 1
            if self._ref[phys] == 0:
                if self._hash[phys] is not None:
                    self._cached[phys] = None          # newest = MRU end
                else:
                    self._free.append(phys)
        self._chain.pop(rid, None)

    def forget(self, rid: int) -> None:
        """Release without retaining anything in the prefix cache — the
        deadlock-breaking path (a preempted request giving up its blocks
        for re-prefill later)."""
        for phys in self._tables.pop(rid, ()):
            self._ref[phys] -= 1
            if self._ref[phys] == 0:
                h = self._hash[phys]
                if h is not None and self._lookup.get(h) == phys:
                    del self._lookup[h]
                self._hash[phys] = None
                self._cached.pop(phys, None)
                self._free.append(phys)
        self._chain.pop(rid, None)

    # --------------------------------------------------------- snapshot/restore

    def snapshot(self) -> dict:
        """JSON-able copy of the whole allocator state (DESIGN.md §12):
        free list, refcounts, per-block hashes, the LRU cache order, the
        prefix-lookup index, per-request tables/chains and the stats
        counters.  Chain hashes are hashes of int tuples, which Python
        computes deterministically (PYTHONHASHSEED only perturbs str/bytes),
        so a snapshot restored in a *new process* still matches prefixes."""
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "prefix_cache": self.prefix_cache,
            "free": list(self._free),
            "ref": list(self._ref),
            "hash": list(self._hash),
            "cached": list(self._cached),          # LRU order, oldest first
            "lookup": [[h, phys] for h, phys in self._lookup.items()],
            "tables": {str(rid): list(t) for rid, t in self._tables.items()},
            "chain": {str(rid): h for rid, h in self._chain.items()},
            "stats": dict(self.stats),
        }

    def restore(self, snap: dict, *, drop_unheld: bool = True) -> None:
        """Rebuild allocator state from :meth:`snapshot`.

        ``drop_unheld=True`` (the crash-recovery default) releases every
        refcount-0 prefix-cached block to the free list and forgets its
        hash: the engine's replay re-materialises device contents only for
        blocks *held by live requests* (their holders rewrite bit-identical
        KV), while an unheld cached block's tokens are not recorded
        anywhere, so its device bits cannot be rebuilt and it must not be
        matchable.  Held blocks keep their hash/index entries — sharing
        them stays sound because every holder's replay writes the same
        position-pure bits.  ``free_blocks`` is unchanged either way
        (cached blocks were already evictable), so admission capacity —
        and therefore scheduling — is unaffected."""
        if (snap["num_blocks"] != self.num_blocks
                or snap["block_size"] != self.block_size):
            raise ValueError(
                f"pool snapshot shape ({snap['num_blocks']}×"
                f"{snap['block_size']}) does not match this pool "
                f"({self.num_blocks}×{self.block_size})")
        self._free = [int(x) for x in snap["free"]]
        self._ref = [int(x) for x in snap["ref"]]
        self._hash = [None if h is None else int(h) for h in snap["hash"]]
        self._cached = OrderedDict((int(p), None) for p in snap["cached"])
        self._lookup = {int(h): int(p) for h, p in snap["lookup"]}
        self._tables = {int(r): [int(b) for b in t]
                        for r, t in snap["tables"].items()}
        self._chain = {int(r): int(h) for r, h in snap["chain"].items()}
        self.stats = {k: int(v) for k, v in snap["stats"].items()}
        if drop_unheld:
            self.drop_cached(list(self._cached))

    def drop_cached(self, blocks: Sequence[int]) -> None:
        """Return refcount-0 prefix-cached ``blocks`` to the free list and
        forget their hashes (what ``restore(drop_unheld=True)`` does to all
        of them; the port's engine keeps the ones it can rebuild)."""
        for phys in blocks:
            h = self._hash[phys]
            if h is not None and self._lookup.get(h) == phys:
                del self._lookup[h]
            self._hash[phys] = None
            self._cached.pop(phys)
            self._free.append(phys)
