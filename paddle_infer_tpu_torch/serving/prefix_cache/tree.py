"""Radix-tree prefix cache over paged KV blocks.

Port of ``paddle_infer_tpu/serving/prefix_cache/tree.py`` (pure Python
over the native block pool, ``native.KVBlockPool``): the same names,
ownership rules and eviction order, so the two trees make the same
decisions on the same operations.  Completed sequences donate their
full KV pages to a radix tree keyed on page-sized token chunks, and
admission walks the tree to map a new request's block table onto the
shared physical blocks — the prefill then covers only the uncached
suffix.

Ownership model (the part that keeps the pool honest):

  * every node (and every partial-tail entry) holds exactly ONE native
    reference on its physical block (``pool.ref_block`` at insert,
    ``pool.unref_block`` at evict);
  * a sequence that reuses shared blocks holds its own references via
    ``pool.assign`` — freeing the sequence never touches the tree's
    reference, and evicting the tree entry never yanks a block out from
    under a live sequence (the block survives until every holder drops
    it);
  * matched nodes are PINNED (``pins`` — an active-consumer count, not
    a block refcount) for the lifetime of the consuming request so
    eviction can never drop a node a queued row is about to attend to.

Chunks are keyed by the exact token tuple: dict lookup hashes the
tuple and the tuple equality check makes collisions impossible, so a
hit is always a true prefix match.  ``cache_salt`` isolates tenants:
each salt owns a disjoint tree, so one tenant can never observe (via
TTFT timing) whether another tenant's prompt shares its prefix.

Partial tail blocks (a prompt ending mid-page) are cached as
``partials`` entries keyed by the partial token tuple.  Consumers never
share them in place — the engine copies the page into a fresh block
(copy-on-write) before writing the suffix — but the *source* entry is
pinned from ``match`` until ``release``/``trim`` drops it: eviction
recycling the tail block between the match and the copy would hand the
consumer another request's KV.

Eviction is leaf-first LRU over entries with ``pins == 0``: partial
entries and childless nodes.  It runs on demand (``ensure_free``) when
admission needs blocks, and after every release (``enforce_watermark``)
to keep the cache under ``watermark × pool_blocks`` retained blocks.

``_tier_demote`` is the host KV tier's demotion hook (``graft`` its
promotion): the tier is not ported yet, so the hook stays ``None``
unless a caller wires one.
"""
from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Tuple

_log = logging.getLogger(__name__)


def _common(a, b) -> int:
    """Length of the common prefix of two token sequences."""
    k = 0
    for x, y in zip(a, b):
        if x != y:
            break
        k += 1
    return k


class _Node:
    """One page-sized chunk of a cached prefix."""
    __slots__ = ("chunk", "block", "children", "parent", "pins",
                 "last_used", "partials")

    def __init__(self, chunk: Tuple[int, ...], block: Optional[int],
                 parent: Optional["_Node"]):
        self.chunk = chunk
        self.block = block          # physical block id (None for roots)
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.parent = parent
        self.pins = 0               # active consumers (NOT block refcount)
        self.last_used = 0
        # partial tail pages extending this prefix: token tuple (shorter
        # than a page) -> [block, last_used, pins]
        self.partials: Dict[Tuple[int, ...], List[int]] = {}


class PrefixMatch:
    """The result of ``PrefixCache.match`` — pinned until ``release``."""
    __slots__ = ("nodes", "blocks", "partial_block", "partial_len",
                 "partial_node", "partial_entry", "salt", "_page")

    def __init__(self, nodes, blocks, partial_block, partial_len,
                 partial_node, partial_entry, salt, page):
        self.nodes: List[_Node] = nodes
        self.blocks: List[int] = blocks        # full shared blocks
        self.partial_block = partial_block     # tail block to CoW, or None
        self.partial_len = partial_len         # valid tokens in the tail
        self.partial_node = partial_node       # pinned source node, if any
        self.partial_entry = partial_entry     # pinned partials entry, if any
        self.salt = salt
        self._page = page

    @property
    def cached_tokens(self) -> int:
        return len(self.blocks) * self._page + self.partial_len


class PrefixCache:
    """Radix-tree index from token prefixes to ref-counted KV blocks.

    Thread-safe (one lock) though the serving scheduler drives it from a
    single thread; the lock keeps ``stats_snapshot`` readable from HTTP
    handler threads mid-step.
    """

    def __init__(self, pool, page_size: int, watermark: float = 0.5):
        """``pool``: a ``native.KVBlockPool``.  ``watermark``: retained
        (unpinned-or-not) cache blocks are evicted down to
        ``watermark × pool.num_blocks`` after every request release."""
        self._pool = pool
        self.page = int(page_size)
        self.watermark = float(watermark)
        self._roots: Dict[object, _Node] = {}
        self._clock = 0
        self._lock = threading.Lock()
        # host-tier demotion hook (``cache._tier_demote = fn``); called as
        # ``demote(salt, token_path, block)`` for every FULL node LRU
        # eviction drops, before the block reference is released.
        # ``clear()`` bypasses it — close/restart teardown must not
        # snapshot pages.  None = demotion disabled.
        self._tier_demote = None
        # counters (rendered under snapshot["prefix_cache"])
        self.queries = 0
        self.hits = 0
        self.peeks = 0              # read-only router probes (peek())
        self.cached_tokens_total = 0
        self.prompt_tokens_total = 0
        self.inserts = 0
        self.evicted_blocks = 0
        self.cow_copies = 0
        self.cached_blocks = 0      # gauge: blocks the tree holds refs on
        self.node_count = 0         # gauge: full-page nodes

    # ------------------------------------------------------------- match
    def match(self, tokens, salt=None) -> PrefixMatch:
        """Longest cached prefix of ``tokens`` (full pages, then the best
        partial tail), capped at ``len(tokens) - 1`` so at least one
        prompt token is always recomputed (its logits seed sampling).
        Matched nodes are pinned — call ``release`` when the request
        leaves its slot."""
        toks = [int(t) for t in tokens]
        with self._lock:
            self._clock += 1
            self.queries += 1
            self.prompt_tokens_total += len(toks)
            usable = len(toks) - 1
            node = self._roots.get(salt)
            nodes: List[_Node] = []
            blocks: List[int] = []
            depth = 0
            while node is not None and (depth + 1) * self.page <= usable:
                chunk = tuple(toks[depth * self.page:
                                   (depth + 1) * self.page])
                child = node.children.get(chunk)
                if child is None:
                    break
                child.pins += 1
                child.last_used = self._clock
                nodes.append(child)
                blocks.append(child.block)
                node = child
                depth += 1
            partial_block, partial_len, partial_node = None, 0, None
            best_entry = None
            if node is not None:
                rem = toks[depth * self.page:usable]
                best = 0
                # candidate tails: explicit partial entries, and full-page
                # child chunks sharing a proper prefix with the remainder
                # (the resubmitted-identical-prompt case) — either way the
                # consumer CoW-copies the block before writing its suffix
                for ptoks, entry in node.partials.items():
                    k = _common(ptoks, rem)
                    if k > best:
                        best, partial_block = k, entry[0]
                        best_entry, partial_node = entry, None
                for chunk, child in node.children.items():
                    k = _common(chunk, rem)
                    if k > best:
                        best, partial_block = k, child.block
                        best_entry, partial_node = None, child
                partial_len = best
                if best == 0:
                    partial_block = None
                elif partial_node is not None:
                    partial_node.pins += 1
                    partial_node.last_used = self._clock
                    best_entry = None
                elif best_entry is not None:
                    # pin the tail entry: eviction recycling this block
                    # before the consumer's CoW copy would alias KV
                    best_entry[1] = self._clock
                    best_entry[2] += 1
            m = PrefixMatch(nodes, blocks, partial_block, partial_len,
                            partial_node, best_entry, salt, self.page)
            if m.cached_tokens > 0:
                self.hits += 1
                self.cached_tokens_total += m.cached_tokens
            return m

    def peek(self, tokens, salt=None) -> int:
        """Read-only longest-match probe: how many tokens of ``tokens``
        a ``match`` would serve right now (full shared pages plus the
        best partial tail, capped at ``len(tokens) - 1`` exactly like
        ``match``), with NONE of match's side effects — no pins, no LRU
        clock movement, no hit/query counters.  A router calls this
        against every replica per dispatch decision, so the probe must
        never perturb eviction order or inflate the hit-rate gauges;
        probes are tallied separately under ``peeks``.  The
        answer is advisory — blocks are not pinned, so eviction between
        peek and the eventual ``match`` can only shrink it."""
        toks = [int(t) for t in tokens]
        with self._lock:
            self.peeks += 1
            usable = len(toks) - 1
            node = self._roots.get(salt)
            depth = 0
            while node is not None and (depth + 1) * self.page <= usable:
                chunk = tuple(toks[depth * self.page:
                                   (depth + 1) * self.page])
                child = node.children.get(chunk)
                if child is None:
                    break
                node = child
                depth += 1
            best = 0
            if node is not None:
                rem = toks[depth * self.page:usable]
                for ptoks in node.partials:
                    best = max(best, _common(ptoks, rem))
                for chunk in node.children:
                    best = max(best, _common(chunk, rem))
            return depth * self.page + best

    def lookahead(self, tokens, k, salt=None):
        """Read-only draft proposal: the tree is a free suffix index, so
        a row whose history ``tokens`` is a cached prefix can read the
        next up-to-``k`` cached continuation tokens straight out of the
        chunk keys (token ids live in the dict keys — no device reads,
        no pins, no LRU clock movement).  Returns a possibly-empty list;
        ties between sibling continuations resolve in insertion order.
        Proposals are only as good as the cache — acceptance, never
        correctness, depends on them."""
        if k <= 0:
            return []
        toks = [int(t) for t in tokens]
        with self._lock:
            node = self._roots.get(salt)
            depth = 0
            while node is not None and (depth + 1) * self.page <= len(toks):
                chunk = tuple(toks[depth * self.page:
                                   (depth + 1) * self.page])
                node = node.children.get(chunk)
                depth += 1
            if node is None:
                return []
            rem = tuple(toks[depth * self.page:])
            out: List[int] = []
            while len(out) < k:
                nxt = None
                for chunk, child in node.children.items():
                    if len(chunk) > len(rem) and chunk[:len(rem)] == rem:
                        out.extend(chunk[len(rem):])
                        nxt = child
                        break
                if nxt is None:
                    best = None
                    for ptoks in node.partials:
                        if (len(ptoks) > len(rem)
                                and ptoks[:len(rem)] == rem
                                and (best is None or len(ptoks) > len(best))):
                            best = ptoks
                    if best is not None:
                        out.extend(best[len(rem):])
                    break
                node, rem = nxt, ()
            return out[:k]

    def release(self, match: PrefixMatch):
        """Unpin a match's nodes (request left its slot)."""
        with self._lock:
            for node in match.nodes:
                if node.pins > 0:
                    node.pins -= 1
            match.nodes = []
            match.blocks = []
            self._drop_partial(match)

    @staticmethod
    def _drop_partial(match: PrefixMatch):
        if match.partial_node is not None and match.partial_node.pins > 0:
            match.partial_node.pins -= 1
        if match.partial_entry is not None and match.partial_entry[2] > 0:
            match.partial_entry[2] -= 1
        match.partial_block, match.partial_len = None, 0
        match.partial_node = None
        match.partial_entry = None

    def trim(self, match: PrefixMatch, max_tokens: int):
        """Shrink a match to at most ``max_tokens`` cached tokens
        (partial tail first, then whole pages), unpinning what's
        dropped.  The engine uses this to keep
        ``cached + padded_suffix <= table window``."""
        with self._lock:
            if match.partial_len and match.cached_tokens > max_tokens:
                self._drop_partial(match)
            while match.cached_tokens > max_tokens and match.nodes:
                node = match.nodes.pop()
                match.blocks.pop()
                if node.pins > 0:
                    node.pins -= 1

    # ------------------------------------------------------------ insert
    def insert(self, tokens, blocks, salt=None) -> int:
        """Retain a finished sequence's KV: walk/extend the tree over
        ``tokens``' full pages (``blocks`` is the sequence's block table,
        one entry per page) and cache any mid-page tail as a partial.
        Existing entries win dedup — the duplicate block stays owned by
        the sequence and returns to the pool when the sequence is freed.
        Returns the number of newly retained blocks."""
        toks = [int(t) for t in tokens]
        with self._lock:
            self._clock += 1
            self.inserts += 1
            root = self._roots.get(salt)
            if root is None:
                root = self._roots[salt] = _Node((), None, None)
            node = root
            retained = 0
            n_full = len(toks) // self.page
            for i in range(n_full):
                if i >= len(blocks):
                    return retained
                chunk = tuple(toks[i * self.page:(i + 1) * self.page])
                child = node.children.get(chunk)
                if child is None:
                    blk = int(blocks[i])
                    self._pool.ref_block(blk)
                    child = _Node(chunk, blk, node)
                    node.children[chunk] = child
                    self.cached_blocks += 1
                    self.node_count += 1
                    retained += 1
                child.last_used = self._clock
                node = child
            rem = tuple(toks[n_full * self.page:])
            if rem and n_full < len(blocks):
                entry = node.partials.get(rem)
                if entry is None:
                    blk = int(blocks[n_full])
                    self._pool.ref_block(blk)
                    node.partials[rem] = [blk, self._clock, 0]
                    self.cached_blocks += 1
                    retained += 1
                else:
                    entry[1] = self._clock
            return retained

    def on_cow(self, n: int = 1):
        """The engine copied a partial tail block before writing into it."""
        with self._lock:
            self.cow_copies += n

    # ------------------------------------------------------ host KV tier
    def _node_identity(self, node: _Node):
        """``(salt, full token path)`` of ``node``: walk the parent
        chain to its root and reverse-map the root to its salt."""
        chunks = []
        cur = node
        while cur.parent is not None:
            chunks.append(cur.chunk)
            cur = cur.parent
        path: List[int] = []
        for chunk in reversed(chunks):
            path.extend(chunk)
        for salt, root in self._roots.items():
            if root is cur:
                return salt, tuple(path)
        return None, tuple(path)

    def graft(self, match: PrefixMatch, chunk, block: int) -> bool:
        """Attach a promoted host-tier block as a new child extending
        ``match``'s deepest node, and extend the match in place (pinned
        and clocked exactly like a matched child).  The tree takes
        ownership of the block's existing allocation reference — the
        caller must NOT unref on success.  Returns False (the caller
        keeps its ref) when an equal child already exists."""
        chunk = tuple(int(t) for t in chunk)
        with self._lock:
            self._clock += 1
            node = match.nodes[-1] if match.nodes else \
                self._roots.get(match.salt)
            if node is None:
                node = self._roots[match.salt] = _Node((), None, None)
            child = node.children.get(chunk)
            grafted = child is None
            if grafted:
                child = _Node(chunk, int(block), node)
                node.children[chunk] = child
                self.cached_blocks += 1
                self.node_count += 1
                self.cached_tokens_total += len(chunk)
            child.pins += 1
            child.last_used = self._clock
            match.nodes.append(child)
            match.blocks.append(child.block)
            return grafted

    # ---------------------------------------------------------- eviction
    def _candidates(self):
        """(last_used, kind, node, key) for every evictable entry:
        unpinned partial entries, and unpinned childless partial-less
        nodes."""
        out = []
        stack = list(self._roots.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            for ptoks, entry in node.partials.items():
                if entry[2] == 0:
                    out.append((entry[1], "partial", node, ptoks))
            if (node.block is not None and not node.children
                    and not node.partials and node.pins == 0):
                out.append((node.last_used, "node", node, node.chunk))
        return out

    def _evict_one(self, demote: bool = True) -> bool:
        cands = self._candidates()
        if not cands:
            return False
        _, kind, node, key = min(cands, key=lambda c: c[0])
        if kind == "partial":
            blk = node.partials.pop(key)[0]
        else:
            blk = node.block
            if demote and self._tier_demote is not None:
                # demote-before-drop: the block is still referenced
                # (and its pages valid) until the unref below, so the
                # hook can gather its bytes to host.  Best-effort — a
                # failed demotion only loses the cache entry, exactly
                # what eviction without a tier does.
                salt, path = self._node_identity(node)
                try:
                    self._tier_demote(salt, path, blk)
                except Exception:       # pragma: no cover - hook safety
                    _log.exception("host-tier demote hook failed")
            if node.parent is not None:
                node.parent.children.pop(key, None)
            self.node_count -= 1
        self._pool.unref_block(blk)
        self.cached_blocks -= 1
        self.evicted_blocks += 1
        return True

    def ensure_free(self, need_free: int) -> bool:
        """Evict LRU entries until the pool has ``need_free`` free blocks
        (or nothing more is evictable).  Returns success."""
        with self._lock:
            while self._pool.free_blocks < need_free:
                if not self._evict_one():
                    return False
            return True

    def enforce_watermark(self):
        """Evict down to ``watermark × pool_blocks`` retained blocks."""
        cap = int(self.watermark * self._pool.num_blocks)
        with self._lock:
            while self.cached_blocks > cap:
                if not self._evict_one():
                    break

    def clear(self):
        """Drop every unpinned entry (engine close / restart).  Never
        demotes: at close the snapshot would be wasted work, and after
        a KV loss the pages are garbage."""
        with self._lock:
            while self._evict_one(demote=False):
                pass
            self._roots = {r: n for r, n in self._roots.items()
                           if n.children or n.partials}

    # ------------------------------------------------------------- stats
    def stats_snapshot(self) -> dict:
        with self._lock:
            return {
                "queries": self.queries,
                "hits": self.hits,
                "hit_rate": (self.hits / self.queries
                             if self.queries else 0.0),
                "peeks": self.peeks,
                "cached_tokens": self.cached_tokens_total,
                "prompt_tokens": self.prompt_tokens_total,
                "token_ratio": (self.cached_tokens_total /
                                self.prompt_tokens_total
                                if self.prompt_tokens_total else 0.0),
                "inserts": self.inserts,
                "evicted_blocks": self.evicted_blocks,
                "cow_copies": self.cow_copies,
                "cached_blocks": self.cached_blocks,
                "nodes": self.node_count,
            }
