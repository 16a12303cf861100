"""Paged KV-cache bookkeeping: block pool, refcounts, prefix map, COW.

The serving memory model (PagedAttention, Kwon et al., SOSP'23): instead
of one contiguous ``[max_len]`` KV plane per decode slot, the engine owns
a global pool of fixed-size blocks ``[L, num_blocks, block_size, Hkv,
Dh]`` and each request holds a *block table* — an ordered list of
physical block ids whose concatenation is the request's logical KV
sequence.  HBM is then allocated in ``block_size``-token pages as a
sequence grows, so a 10-token request costs one block, not ``max_len``
tokens, and the same HBM budget holds more concurrent requests.

This module is the HOST-side bookkeeping only — which blocks are free,
who holds them, and which prompt prefixes they cache.  The device arrays
and the gather/scatter programs that read them live in
``models/generate.py`` (paged forward) and ``serve/engine.py`` (the
jitted decode step).

Block states:

  * **free** — on the free list, contents garbage.
  * **held** — ``ref(block) >= 1`` request holders.
  * **cached** — ``ref == 0`` but registered in the prefix map: the
    block still holds a hashed full prompt block, parked on an LRU so a
    later identical prefix can reuse it without recompute.  ``alloc``
    evicts cached blocks (oldest first) only after the free list runs
    dry — prefix cache behaves like a page cache, reclaimable but warm.

Block 0 is the reserved **null block**: never allocated, never freed.
Device programs point inactive lanes and unallocated table slots at it,
so every scatter index is valid without per-lane branching; its contents
are garbage by construction and always masked.

Prefix sharing: full prompt blocks are keyed by a *chain key* — the
tuple ``(parent_key, block_tokens)`` — so a block only matches when the
entire prefix up to it matches (dict equality on nested tuples: exact,
no hash-collision false sharing).  Matched blocks are refcounted into
the new request's table; copy-on-write (``needs_copy`` + the engine's
block copy) protects any shared block a writer must mutate — reachable
today via ``fork_table`` (speculative decoding / beam search fork the
tail), structurally unreachable from plain append-only decode because
only FULL blocks are ever shared and full blocks take no appends.

``alloc`` fires the ``serve.kvcache.alloc`` fault seam before touching
the free list, so a chaos plan can inject pool exhaustion
(``kind: raise``) without shrinking the pool (docs/fault-injection.md).
Exhaustion raises :class:`BlockPoolExhausted`; the engine's contract is
to queue new admissions and preempt/requeue the newest request — never
to crash the decode loop.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.telemetry import instruments as ti

NULL_BLOCK = 0

# a chain key: ("root",) for the first block, else (parent_key, tokens)
PrefixKey = Tuple


class BlockPoolExhausted(RuntimeError):
    """Not enough free or evictable blocks to satisfy an allocation."""


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold `tokens` cache positions."""
    return max(0, -(-tokens // block_size))


def chain_keys(prompt: Sequence[int], block_size: int,
               namespace=None) -> List[PrefixKey]:
    """Chain keys for every FULL block of `prompt`, in order.

    ONE implementation shared by the pool's prefix map
    (`BlockPool.prefix_keys`) and the router's affinity hashing
    (serve/router.py) — the two must agree on key structure or
    affinity routing silently degrades to random placement.

    `namespace` salts the ROOT of the chain (multi-tenant serving
    passes the request's adapter_id): a prompt's KV depends on the
    adapter that computed it, so identical prompts under different
    adapters must never share blocks — a different root makes every
    downstream key differ, structurally, not probabilistically."""
    keys: List[PrefixKey] = []
    parent: PrefixKey = ("root",) if namespace is None \
        else ("root", namespace)
    for start in range(0, len(prompt) - block_size + 1, block_size):
        key = (parent, tuple(prompt[start:start + block_size]))
        keys.append(key)
        parent = key
    return keys


class BlockPool:
    """Free-list allocator + refcounts + prefix map over the KV pool.

    Not thread-safe by design: every mutation happens on the engine's
    loop thread (the same single-owner rule the device arrays follow).
    """

    def __init__(self, num_blocks: int, block_size: int,
                 role: str = "engine"):
        # gauge label: which serving role this pool belongs to
        # ("engine" monolithic, "prefill"/"decode" disaggregated) —
        # two pools in one process must not overwrite each other's
        # utilization series
        self.role = role
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is the "
                             "reserved null block)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # pop() order is ascending (1, 2, ...): deterministic layouts
        # make the paged-vs-static equivalence tests exact
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self._key_to_block: Dict[PrefixKey, int] = {}
        self._block_key: Dict[int, PrefixKey] = {}
        # cached-idle blocks (ref == 0, registered), LRU order
        self._evictable: "OrderedDict[int, None]" = OrderedDict()
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        self._emit_gauges()

    # -- capacity ---------------------------------------------------------
    @property
    def usable_blocks(self) -> int:
        """Allocatable blocks (the null block excluded)."""
        return self.num_blocks - 1

    def free_count(self) -> int:
        return len(self._free)

    def available(self) -> int:
        """Blocks an alloc() could return right now (free + evictable)."""
        return len(self._free) + len(self._evictable)

    def used(self) -> int:
        """Blocks held by requests (cached-idle blocks excluded — they
        are reclaimable, like a page cache)."""
        return self.usable_blocks - self.available()

    def utilization(self) -> float:
        return self.used() / self.usable_blocks

    def ref(self, block: int) -> int:
        return self._ref.get(block, 0)

    # -- allocation -------------------------------------------------------
    def alloc(self, n: int = 1) -> List[int]:
        """Allocate `n` blocks (ref 1 each).  Raises BlockPoolExhausted
        when free + evictable cannot cover the request; partial
        allocations never escape (all-or-nothing)."""
        seams.fire("serve.kvcache.alloc", need=n,
                   free=len(self._free), evictable=len(self._evictable))
        if n > self.available():
            raise BlockPoolExhausted(
                f"need {n} KV blocks, only {self.available()} "
                f"available ({len(self._free)} free, "
                f"{len(self._evictable)} evictable) of "
                f"{self.usable_blocks} usable")
        out: List[int] = []
        for _ in range(n):
            if self._free:
                block = self._free.pop()
            else:
                # reclaim the least-recently-parked cached block
                block, _ = self._evictable.popitem(last=False)
                key = self._block_key.pop(block)
                del self._key_to_block[key]
            self._ref[block] = 1
            out.append(block)
        self._emit_gauges()
        return out

    def incref(self, block: int) -> None:
        if block == NULL_BLOCK:
            raise ValueError("cannot reference the null block")
        self._ref[block] += 1

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block; a block reaching ref 0 returns
        to the free list, unless the prefix map still caches it — then
        it parks on the evictable LRU, warm for the next match."""
        for block in blocks:
            refs = self._ref.get(block)
            if refs is None:
                raise ValueError(f"block {block} is not allocated")
            if refs > 1:
                self._ref[block] = refs - 1
                continue
            del self._ref[block]
            if block in self._block_key:
                self._evictable[block] = None
                self._evictable.move_to_end(block)
            else:
                self._free.append(block)
        self._emit_gauges()

    def fork_table(self, table: Sequence[int]) -> List[int]:
        """Share every block with a second holder (speculative decoding
        / beam forks).  The fork must `needs_copy`-check before any
        write — that is the copy-on-write boundary."""
        for block in table:
            self.incref(block)
        return list(table)

    def needs_copy(self, block: int) -> bool:
        """True when writing this block would be visible to another
        holder — the caller must allocate a fresh block, device-copy
        the contents, and `release` this one (copy-on-write)."""
        return self.ref(block) > 1

    # -- prefix map -------------------------------------------------------
    def prefix_keys(self, prompt: Sequence[int],
                    namespace=None) -> List[PrefixKey]:
        """Chain keys for every FULL block of `prompt`, in order.
        `namespace` (an adapter_id) salts the chain root so different
        adapters' identical prompts never share blocks."""
        return chain_keys(prompt, self.block_size, namespace=namespace)

    def match_prefix(self, prompt: Sequence[int], count: bool = True,
                     namespace=None) -> Tuple[List[int], int]:
        """Longest cached full-block prefix of `prompt`.

        Returns ``(blocks, reuse_tokens)`` with every returned block
        already incref'd for the caller.  Reuse is capped BELOW the full
        prompt (at least one trailing token is always recomputed) so the
        final prefill chunk can produce the first-token logits.

        ``count=False`` skips the hit/tokens-saved accounting: for
        callers whose reuse avoids no prefill recompute (the migration
        import path — those tokens arrived computed) and whose retry
        loops would otherwise book the same match every engine tick.
        """
        bs = self.block_size
        matched: List[int] = []
        for key in self.prefix_keys(prompt, namespace=namespace):
            if len(matched) * bs + bs >= len(prompt):
                break                      # keep >= 1 token to prefill
            block = self._key_to_block.get(key)
            if block is None:
                break
            matched.append(block)
        for block in matched:
            if self._ref.get(block, 0) == 0:
                self._evictable.pop(block, None)
                self._ref[block] = 1
            else:
                self._ref[block] += 1
        reuse_tokens = len(matched) * bs
        if matched and count:
            self.prefix_hits += 1
            self.prefix_tokens_saved += reuse_tokens
            ti.SERVE_PREFIX_HITS.inc()
            ti.SERVE_PREFIX_TOKENS_SAVED.inc(reuse_tokens)
            self._emit_gauges()
        return matched, reuse_tokens

    def register_prefix(self, prompt: Sequence[int],
                        table: Sequence[int],
                        start_block: int = 0,
                        namespace=None) -> int:
        """Publish `prompt`'s full blocks from `table` into the prefix
        map (from `start_block` on — earlier ones came FROM the map).
        First writer wins: a key already cached keeps its block.
        Returns how many blocks were newly registered."""
        registered = 0
        for j, key in enumerate(self.prefix_keys(prompt,
                                                 namespace=namespace)):
            if j < start_block:
                continue
            if key in self._key_to_block:
                continue
            block = table[j]
            if block in self._block_key:   # already caches another key
                continue
            self._key_to_block[key] = block
            self._block_key[block] = key
            registered += 1
        return registered

    # -- telemetry --------------------------------------------------------
    def _emit_gauges(self) -> None:
        ti.SERVE_KV_BLOCKS_IN_USE.set(self.used(), role=self.role)
        ti.SERVE_KV_POOL_UTILIZATION.set(self.utilization(),
                                         role=self.role)
