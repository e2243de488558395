"""Radix cache of prompt-prefix KV pages over the paged pool.

A copy of the reference's ``serving/prefix_cache.py`` (numpy only), so
the port imports nothing of the reference package.

Served traffic often shares long common prefixes (system prompts,
few-shot templates, multi-turn history).  Recomputing a shared prefix
costs prefill compute and pool pages.  This module caches the *pages*
that back previously served prompts in a radix tree keyed by token
ids, at page granularity:

* an interior/full node covers exactly ``page_size`` tokens and owns
  one pool page holding their KV;
* a leaf may additionally be *partial* (fewer than ``page_size``
  tokens): the donor's last prompt page, shared up to the tokens the
  donor actually prefilled.  A consumer that maps a partial page must
  copy-on-write before its first append (the donor keeps decoding into
  the original).

Ownership: the cache holds its OWN reference on every cached page
(``PagePool.share`` on insert, ``PagePool.free`` on eviction/flush).
A cached page therefore stays allocated after its donor lane retires,
and a page mapped by live lanes survives cache eviction -- the pool's
refcount, not the tree, decides when bytes are really reclaimed.

Correctness of sharing a page whose donor is still decoding: a full
node's tokens all precede the donor's first decode write (the donor
writes at positions >= its prompt length, which live in later blocks),
so full pages are frozen.  A partial page IS appended to by the donor,
but only at slots >= the cached token count; consumers copy the page
before writing and never read past their own live length, so the
donor's junk in the copied tail is dead data.

The tree is deliberately host-side and tiny (a few nodes per cached
prompt): matching is a dict walk per page, far off the decode hot
path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PrefixCache"]


class _Node:
    """One cached page: ``tokens`` under the parent's position."""

    __slots__ = ("tokens", "page", "parent", "children", "last_used")

    def __init__(self, tokens: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.tokens = tokens
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0


def _key(prompt, start: int, stop: int) -> Tuple[int, ...]:
    return tuple(int(t) for t in prompt[start:stop])


class PrefixCache:
    """Page-granular radix tree of cached prompt prefixes.

    ``match`` walks the tree along an incoming prompt and returns the
    longest cached prefix in whole pages (plus, optionally, one partial
    tail page); ``insert`` records a freshly prefilled lane's prompt
    pages.  Eviction is LRU over leaves, so an interior page is never
    dropped while a longer cached prefix still extends it.
    """

    def __init__(self, pool, page_size: int):
        self.pool = pool
        self.page_size = int(page_size)
        # bounded only by pool pressure: the engine trims the cache
        # (``evict_lru``) when admission cannot reserve its pages
        self._root = _Node((), -1, None)
        self._clock = 0
        self._n_pages = 0

    @property
    def n_pages(self) -> int:
        """Pages the cache currently holds a reference on."""
        return self._n_pages

    # ------------------------------------------------------------------
    # lookup
    # ------------------------------------------------------------------
    def match(self, prompt: np.ndarray, allow_partial: bool = True
              ) -> Tuple[List[int], int, Optional[Tuple[int, int]]]:
        """Longest cached prefix of ``prompt``, in pages.

        Returns ``(pages, matched_len, partial)``:

        * ``pages`` -- full shared pages in logical block order;
        * ``matched_len`` -- prompt tokens they cover (including the
          partial page, when one matches);
        * ``partial`` -- ``(page_id, n_tokens)`` for a matched partial
          tail page, or None.

        At least one tail token is ALWAYS left unmatched
        (``matched_len <= len(prompt) - 1``): the admitting lane must
        run a real forward step over its final prompt token to produce
        the first-token logits, exactly like a cache miss would.
        """
        ps = self.page_size
        plen = int(len(prompt))
        max_full = max((plen - 1) // ps, 0)
        self._clock += 1
        node = self._root
        pages: List[int] = []
        pos = 0
        while len(pages) < max_full:
            child = node.children.get(_key(prompt, pos, pos + ps))
            if child is None:
                break
            child.last_used = self._clock
            pages.append(child.page)
            node = child
            pos += ps
        partial: Optional[Tuple[int, int]] = None
        if allow_partial:
            best = None
            for key, child in node.children.items():
                if len(key) >= ps or pos + len(key) > plen - 1:
                    continue
                if key == _key(prompt, pos, pos + len(key)):
                    if best is None or len(key) > len(best.tokens):
                        best = child
            if best is not None:
                best.last_used = self._clock
                partial = (best.page, len(best.tokens))
                pos += len(best.tokens)
        return pages, pos, partial

    # ------------------------------------------------------------------
    # insertion
    # ------------------------------------------------------------------
    def insert(self, prompt: np.ndarray, plen: int,
               lane_pages: List[int], allow_partial: bool = True) -> int:
        """Record a prefilled lane's prompt pages; returns pages newly
        cached.  ``lane_pages[i]`` must back prompt positions
        ``[i * page_size, (i + 1) * page_size)`` -- true for any lane
        the engine just prefilled (hit or miss: a hit lane's head
        blocks are the donor pages themselves, which the walk simply
        revisits).  Existing nodes win ties: a prefix already cached
        keeps its original page, the new lane's duplicate stays
        lane-private."""
        ps = self.page_size
        self._clock += 1
        node = self._root
        added = 0
        n_full = plen // ps
        for i in range(n_full):
            key = _key(prompt, i * ps, (i + 1) * ps)
            child = node.children.get(key)
            if child is None:
                child = self._add_node(node, key, lane_pages[i])
                added += 1
            child.last_used = self._clock
            node = child
        rem = plen - n_full * ps
        if allow_partial and rem > 0:
            key = _key(prompt, n_full * ps, plen)
            child = node.children.get(key)
            if child is None:
                child = self._add_node(node, key, lane_pages[n_full])
                added += 1
            child.last_used = self._clock
        return added

    def _add_node(self, parent: _Node, key: Tuple[int, ...],
                  page: int) -> _Node:
        self.pool.share([page], holder="cache")   # the cache's own ref
        child = _Node(key, page, parent)
        parent.children[key] = child
        self._n_pages += 1
        return child

    # ------------------------------------------------------------------
    # eviction / invalidation
    # ------------------------------------------------------------------
    def _lru_leaf(self) -> Optional[_Node]:
        best = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                if child.children:
                    stack.append(child)
                elif best is None or child.last_used < best.last_used:
                    best = child
        return best

    def evict_lru(self) -> bool:
        """Drop the least-recently-matched LEAF page (an interior page
        outlives every cached prefix that extends it).  The page's
        bytes return to the pool only if no live lane still maps it --
        that is the refcount's call, not ours."""
        leaf = self._lru_leaf()
        if leaf is None:
            return False
        del leaf.parent.children[leaf.tokens]
        self.pool.free([leaf.page], holder="cache")
        self._n_pages -= 1
        return True

    def flush(self) -> int:
        """Invalidate everything (weight unload / end of replay):
        releases the cache's reference on every cached page.  Returns
        the number of pages released."""
        released = 0
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            self.pool.free([node.page], holder="cache")
            released += 1
        self._root.children.clear()
        self._n_pages = 0
        return released
