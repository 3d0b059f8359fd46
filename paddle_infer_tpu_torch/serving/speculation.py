"""Draft-token sources for in-engine speculative decoding.

Port of ``paddle_infer_tpu/serving/speculation.py`` (host numpy, no
device work).  ``EngineCore(speculate=True)`` asks a source for up to
``k`` continuation tokens per decode row each step and packs them into
the ragged mixed step as a ``query_len = k + 1`` verify row
(``serving/programs.build_mixed_step`` with ``spec_window > 1``).
Drafts change throughput only: the accept rule
(``inference/spec_accept.py``) keeps greedy streams bitwise equal to
``speculate=False`` and sampled streams exactly distributed.

Sources:

  * ``NgramDraftSource`` — prompt-lookup decoding: the continuation
    after the most recent earlier occurrence of the row's trailing
    n-gram.  A pure function of the row's history, so the only kind
    sampled rows may use.
  * ``PrefixCacheDraftSource`` — tree drafts: the radix tree's cached
    continuation of the row's history (``PrefixCache.lookahead``), for
    greedy rows only (the tree changes under traffic).
  * ``CallableDraftSource`` — any ``fn(history, k) -> tokens`` (a small
    draft model, an oracle); non-deterministic unless declared.
  * ``AutoDraftSource`` — tree lookahead when the core has a prefix
    cache and the row tolerates non-determinism, ngram otherwise.

Sources return at most ``k`` ints and may return fewer or none (the row
then rides the step as a plain decode row).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np


class NgramDraftSource:
    """Prompt-lookup drafts: match the trailing n-gram (longest first)
    against the row's earlier history; propose what followed the most
    recent occurrence."""

    name = "ngram"
    deterministic = True

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, history: Sequence[int], k: int, salt=None,
                deterministic_only: bool = False) -> List[int]:
        h = np.asarray(history, dtype=np.int64)
        n_hist = int(h.size)
        if k <= 0 or n_hist < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, n_hist - 1),
                       self.min_ngram - 1, -1):
            pat = h[n_hist - n:]
            # m[s] <=> h[s:s+n] == pat, for windows strictly before the
            # trailing n-gram itself
            m = np.ones(n_hist - n, dtype=bool)
            for t in range(n):
                m &= h[t:t + n_hist - n] == pat[t]
            idx = np.nonzero(m)[0]
            if idx.size:
                s = int(idx[-1])
                cont = h[s + n:s + n + k]
                if cont.size:
                    return [int(t) for t in cont]
        return []


class PrefixCacheDraftSource:
    """Radix-tree lookahead drafts (greedy rows only — the tree mutates
    under concurrent traffic, so proposals are not replay-stable)."""

    name = "prefix_cache"
    deterministic = False

    def __init__(self, cache):
        self._cache = cache

    def propose(self, history: Sequence[int], k: int, salt=None,
                deterministic_only: bool = False) -> List[int]:
        if deterministic_only or self._cache is None or k <= 0:
            return []
        return self._cache.lookahead(history, k, salt=salt)


class CallableDraftSource:
    """Wrap ``fn(history, k) -> tokens`` (e.g. a small draft model)."""

    name = "callable"

    def __init__(self, fn: Callable[[Sequence[int], int], Sequence[int]],
                 deterministic: bool = False, name: Optional[str] = None):
        self._fn = fn
        self.deterministic = bool(deterministic)
        if name:
            self.name = str(name)

    def propose(self, history: Sequence[int], k: int, salt=None,
                deterministic_only: bool = False) -> List[int]:
        if k <= 0 or (deterministic_only and not self.deterministic):
            return []
        out = self._fn(history, k)
        return [int(t) for t in list(out)[:k]]


class AutoDraftSource:
    """Prefix-cache lookahead when the core has a tree (and the caller
    tolerates non-determinism), ngram prompt-lookup otherwise."""

    name = "auto"
    deterministic = False

    def __init__(self, cache=None, max_ngram: int = 3):
        self._tree = (PrefixCacheDraftSource(cache)
                      if cache is not None else None)
        self._ngram = NgramDraftSource(max_ngram=max_ngram)

    def propose(self, history: Sequence[int], k: int, salt=None,
                deterministic_only: bool = False) -> List[int]:
        if self._tree is not None and not deterministic_only:
            got = self._tree.propose(history, k, salt=salt)
            if got:
                return got
        return self._ngram.propose(history, k)


def resolve_draft_source(spec, cache=None):
    """Map an ``EngineCore(draft_source=...)`` argument to a source:
    a name ("auto" | "ngram" | "prefix_cache"), a callable (wrapped as
    ``CallableDraftSource``), or any object with ``propose``.  ``cache``
    is the core's ``PrefixCache`` (None without one)."""
    if spec is None or spec == "auto":
        return AutoDraftSource(cache=cache)
    if spec == "ngram":
        return NgramDraftSource()
    if spec == "prefix_cache":
        if cache is None:
            raise ValueError(
                "draft_source='prefix_cache' needs "
                "enable_prefix_cache=True")
        return PrefixCacheDraftSource(cache)
    if callable(spec) and not hasattr(spec, "propose"):
        return CallableDraftSource(spec)
    if hasattr(spec, "propose"):
        return spec
    raise ValueError(f"unknown draft_source: {spec!r}")
