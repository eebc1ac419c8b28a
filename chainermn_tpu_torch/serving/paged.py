"""Host-side page accounting for the paged KV cache.

Counterpart of ``chainermn_tpu/serving/paged.py`` (numpy-only host code,
kept here as the port's own copy).  The device side is a fixed pool of
KV pages (:func:`chainermn_tpu_torch.models.init_paged_kv_cache`) read
through per-sequence page tables
(:func:`chainermn_tpu_torch.ops.flash_attention_decode_paged`).
Allocation, refcounting, prefix sharing and copy-on-write are plain
Python here, consulted by the scheduler between device calls; what
reaches the device is int32 page tables.

- :class:`PagePool` -- free-list allocator over page ids with
  refcounts.  Page 0 is the SCRATCH page (pad rows and idle table
  entries point there; it is never handed out).
- :class:`RadixPrefixIndex` -- a radix trie over page-sized token chunks
  of completed prompts.  A lookup walks the longest banked prefix and
  returns its pages, so requests sharing a prompt prefix read one banked
  copy.  The index holds its own reference on every banked page; leaves
  are LRU-evicted when the pool runs dry.
- :func:`prefix_key` -- a stable hash of the page-aligned prompt prefix,
  stamped on requests at admission so the scheduler can co-admit
  shared-prefix requests; a pure function of the token ids.

Write-safety invariant: a sequence only writes at positions at or past
its admission-time shared prefix.  The page spanning that boundary is
copied once at admission; every later page is private.  A page banked
from a finished prefill may keep receiving that sequence's decode
tokens, but only at offsets past the banked ``tail_len``.
"""

import binascii

import numpy as np

__all__ = ['PagePool', 'RadixPrefixIndex', 'prefix_key']

SCRATCH_PAGE = 0


def prefix_key(prompt, page_size):
    """Stable key of the shareable prefix of ``prompt``: a CRC32 over
    the page-aligned prefix token ids (the whole prompt when shorter
    than one page -- short prompts still group exact duplicates).

    A pure function of the token values: two requests with the same
    prompt prefix get the same key no matter when or in what order
    they arrive.
    """
    toks = np.asarray(prompt, np.int32).reshape(-1)
    cut = (toks.size // int(page_size)) * int(page_size)
    if cut == 0:
        cut = toks.size
    return int(binascii.crc32(toks[:cut].tobytes()) & 0xffffffff)


class PagePool:
    """Refcounted free-list allocator over ``n_pages`` page ids.

    Page ids are plain ints; the device-side pool array is indexed by
    them.  ``alloc`` hands out a free page at refcount 1; ``retain``/
    ``release`` move the count; a page returns to the free list when
    its count hits zero.  Page 0 (:data:`SCRATCH_PAGE`) is never
    allocated.
    """

    def __init__(self, n_pages, page_size):
        if n_pages < 2:
            raise ValueError('need at least 2 pages (1 scratch + 1 '
                             'live), got %d' % n_pages)
        if page_size < 1:
            raise ValueError('page_size must be >= 1, got %d'
                             % page_size)
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._free = list(range(n_pages - 1, 0, -1))   # pop() -> low ids
        self._ref = {}
        self.peak_in_use = 0

    def available(self):
        return len(self._free)

    def in_use(self):
        return len(self._ref)

    def refcount(self, page):
        return self._ref.get(page, 0)

    def alloc(self):
        """One free page at refcount 1, or ``None`` when dry (the
        caller decides between eviction and shedding -- the pool
        itself never blocks)."""
        if not self._free:
            return None
        page = self._free.pop()
        self._ref[page] = 1
        self.peak_in_use = max(self.peak_in_use, len(self._ref))
        return page

    def retain(self, page):
        if page not in self._ref:
            raise ValueError('retain of free page %d' % page)
        self._ref[page] += 1

    def release(self, page):
        count = self._ref.get(page)
        if count is None:
            raise ValueError('release of free page %d' % page)
        if count == 1:
            del self._ref[page]
            self._free.append(page)
        else:
            self._ref[page] = count - 1


class _Node:
    __slots__ = ('children', 'page', 'tails', 'touch')

    def __init__(self, page=None):
        self.children = {}     # page-sized token tuple -> _Node
        self.page = page       # pool page banking this chunk (root: None)
        self.tails = {}        # partial-chunk token tuple -> [page, touch]
        self.touch = 0


class RadixPrefixIndex:
    """Radix trie over page-sized token chunks of banked prompts.

    Each trie edge is one FULL page worth of token ids; the node it
    leads to records the pool page holding that chunk's K/V.  Nodes
    additionally carry ``tails``: banked partial pages (a prompt whose
    length is not page-aligned) keyed by their token suffix.  The
    index owns one reference per banked page (taken at
    :meth:`insert`, dropped at eviction), so a banked page survives
    its sequence and is shared by every later lookup that matches it.

    ``lookup`` returns page ids only -- callers retain what they keep.
    Matching is exact on token ids (the radix property: one walk,
    longest banked prefix wins).
    """

    def __init__(self, pool):
        self.pool = pool
        self._root = _Node()
        self._clock = 0
        self.lookups = 0
        self.hits = 0
        self.tokens_reused = 0

    # -- stats ---------------------------------------------------------
    def hit_rate(self):
        return self.hits / self.lookups if self.lookups else 0.0

    def banked_pages(self):
        n = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            n += len(node.tails) + sum(
                1 for _ in node.children)
            stack.extend(node.children.values())
        return n

    # -- queries -------------------------------------------------------
    def lookup(self, prompt):
        """Longest banked prefix of ``prompt``.

        Returns ``(pages, tail_page, tail_len)``: ``pages`` are the
        FULL banked pages in position order (``len(pages) *
        page_size`` matched tokens) and ``tail_page`` (or ``None``)
        banks ``tail_len`` further tokens.  No references are taken
        -- the caller retains exactly the pages it keeps.
        """
        ps = self.pool.page_size
        toks = tuple(int(t) for t in np.asarray(prompt).reshape(-1))
        self.lookups += 1
        self._clock += 1
        node, pages = self._root, []
        i = 0
        while i + ps <= len(toks):
            child = node.children.get(toks[i:i + ps])
            if child is None:
                break
            child.touch = self._clock
            pages.append(child.page)
            node = child
            i += ps
        tail_page, tail_len = None, 0
        # longest banked partial page continuing the match
        rest = toks[i:]
        for tail, entry in node.tails.items():
            n = len(tail)
            if n > tail_len and rest[:n] == tail:
                tail_page, tail_len = entry[0], n
        if tail_page is not None:
            node.tails[self._tail_key(node, tail_page)][1] = self._clock
        matched = len(pages) * ps + tail_len
        if matched:
            self.hits += 1
            self.tokens_reused += matched
        return pages, tail_page, tail_len

    @staticmethod
    def _tail_key(node, page):
        for key, entry in node.tails.items():
            if entry[0] == page:
                return key
        raise KeyError(page)

    # -- updates -------------------------------------------------------
    def insert(self, prompt, pages):
        """Bank a finished prompt's pages: ``pages`` cover
        ``ceil(len(prompt) / page_size)`` pages in position order.
        Already-banked chunks keep their existing page (first banking
        wins -- later duplicates are simply not indexed); each NEWLY
        indexed page gains one index-owned reference.
        """
        ps = self.pool.page_size
        toks = tuple(int(t) for t in np.asarray(prompt).reshape(-1))
        self._clock += 1
        node = self._root
        i = 0
        while i + ps <= len(toks):
            chunk = toks[i:i + ps]
            child = node.children.get(chunk)
            if child is None:
                page = pages[i // ps]
                child = _Node(page)
                self.pool.retain(page)
                node.children[chunk] = child
            child.touch = self._clock
            node = child
            i += ps
        rest = toks[i:]
        if rest and rest not in node.tails:
            page = pages[i // ps]
            self.pool.retain(page)
            node.tails[rest] = [page, self._clock]
        elif rest:
            node.tails[rest][1] = self._clock

    def evict(self, n_needed=1):
        """LRU-drop banked leaves until ``n_needed`` pages could be
        freed or nothing evictable remains.  Only drops the INDEX's
        reference -- a page still used by live sequences stays
        allocated (and stays counted in ``in_use``) until they finish.
        Returns the number of references dropped."""
        dropped = 0
        while dropped < n_needed:
            victim = self._lru_leaf()
            if victim is None:
                break
            parent, kind, key, page = victim
            if kind == 'tail':
                del parent.tails[key]
            else:
                del parent.children[key]
            self.pool.release(page)
            dropped += 1
        return dropped

    def _lru_leaf(self):
        best = None
        stack = [(self._root, None, None)]
        while stack:
            node, parent, key = stack.pop()
            for tkey, (page, touch) in node.tails.items():
                if best is None or touch < best[0]:
                    best = (touch, node, 'tail', tkey, page)
            for ckey, child in node.children.items():
                if not child.children and not child.tails:
                    if best is None or child.touch < best[0]:
                        best = (child.touch, node, 'child', ckey,
                                child.page)
                stack.append((child, node, ckey))
        if best is None:
            return None
        return best[1], best[2], best[3], best[4]

    def flush(self):
        """Drop every banked reference (used by tests and by engines
        tearing down)."""
        while self.evict(1):
            pass
