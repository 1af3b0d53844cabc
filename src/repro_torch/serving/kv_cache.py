"""KV cache pools for continuous batching (mirror of
``repro.serving.kv_cache``).

* :class:`KVCachePool` -- the dense layout, one ``s_max``-wide cache row
  per slot: (L, n_slots, S_max, H_kv, D).
* :class:`PagedKVCachePool` -- fixed-size pages (L, n_pages, page, H_kv,
  D) with a per-slot page table and a content-addressed prefix cache; for
  a latent-attention config one latent row a token, {"kv"}: (L, n_pages,
  page, 1, latent_dim), which every method below moves as it moves K/V.  The
  host policy -- page tables, refcounts, chain keys, copy-on-extend, LRU
  eviction -- is numpy and the same line for line as the JAX pool, so both
  pools make the same decisions from the same calls.

Both keep their cache as torch tensors on the engine's device and write
into it in place.  Handoff payloads carry host numpy arrays with the pool
dtype's exact bytes; numpy has no bfloat16, so a bf16 pool's rows travel
as int16 views of the same bits, and ``payload_checksum`` CRCs the same
bytes the JAX pool's bf16 arrays hold.
"""

from __future__ import annotations

import hashlib
import zlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import transformer as tr


def to_host(t: torch.Tensor) -> np.ndarray:
    """Host copy holding the tensor's exact bytes (bf16 as int16 bits)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def host_empty(shape, dtype, device) -> np.ndarray:
    """An empty host array of numpy ``dtype`` (bfloat16 as int16 bits) to
    stage a copy to ``device``: page-locked when that is a GPU, so the copy
    runs as one DMA at the link's rate."""
    dtype = np.dtype(np.int16 if np.dtype(dtype).name == "bfloat16"
                     else dtype)
    t = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                    pin_memory=torch.device(device).type == "cuda")
    return t.numpy()


def from_host(a, dtype: torch.dtype, device) -> torch.Tensor:
    """Inverse of :func:`to_host`; also takes ml_dtypes bfloat16 arrays."""
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:            # torch wants memory it may write
        a = a.copy()
    if a.dtype.name == "bfloat16":
        a = a.view(np.int16)
    t = torch.from_numpy(a)
    if t.dtype == torch.int16 and dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(device=device, dtype=dtype)


class ImportStats(NamedTuple):
    """What one ``import_slot`` actually moved over the (logical) wire."""
    nbytes: int          # payload bytes shipped (deduplicated pages excluded)
    pages: int           # pages shipped
    pages_shared: int    # pages satisfied from the destination's prefix cache


@dataclass
class PagedPrefix:
    """Page-granular KV handoff payload.

    ``keys[j]`` is the chain key of logical page j (None for the partial
    tail page, which is never content-addressed), ``pages[j]`` the page's
    valid K/V rows as host arrays: {"k","v"}: (L, rows<=page, H_kv, D).
    Only the valid rows of the tail page travel, so ``nbytes`` equals the
    dense whole-prefix payload; the *shipped* savings come from the
    importer referencing pages it already caches instead of writing them.
    """
    page_size: int
    length: int
    keys: list
    pages: dict

    @property
    def nbytes(self) -> int:
        """Total payload size == what a dense whole-prefix export ships."""
        return int(sum(v.nbytes for p in self.pages.values()
                       for v in p.values()))


class KVCachePool:
    """Dense slot-per-request pool (the pre-paging layout, kept for parity
    with the paged one and for the pre-fusion decode path)."""

    def __init__(self, cfg: tr.TransformerConfig, n_slots: int, s_max: int,
                 dtype=torch.bfloat16, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_slots = n_slots
        self.s_max = s_max
        self.cache = tr.make_cache(cfg, n_slots, s_max, dtype,
                                   device=self.device)
        self.lengths = np.zeros(n_slots, np.int32)
        self.free = list(range(n_slots))
        self.owner: dict[int, int] = {}       # slot -> request id

    def alloc(self, rid: int) -> int | None:
        if not self.free:
            return None
        slot = self.free.pop()
        self.owner[slot] = rid
        self.lengths[slot] = 0
        return slot

    def release(self, slot: int) -> None:
        self.owner.pop(slot, None)
        self.lengths[slot] = 0
        # zero the slot so stale keys can never leak across requests
        for v in self.cache.values():
            v[:, slot].zero_()
        self.free.append(slot)

    def write_prefix(self, slot: int, layer_cache: dict, prefix_len: int,
                     tokens=None, key_salt: bytes = b"") -> None:
        """Install a prefill-produced cache (L, 1, P, H, D) into the slot.

        ``tokens``/``key_salt`` are accepted for protocol compatibility
        with the paged pool and ignored (dense slots cannot share)."""
        p = min(int(prefix_len), self.s_max)
        for k, v in layer_cache.items():
            self.cache[k][:, slot, :p] = v[:, 0, :p].to(self.cache[k].dtype)
        self.lengths[slot] = p

    def export_slot(self, slot: int) -> tuple[dict, int]:
        """The slot's valid prefix as host arrays ``{"k","v"}: (L, length,
        H_kv, D)`` in the pool dtype's exact bytes, and its length: K and V
        stacked on the device, then one copy to host memory."""
        length = int(self.lengths[slot])
        names = sorted(self.cache)
        host = to_host(torch.stack([self.cache[k][:, slot, :length]
                                    for k in names]))
        return dict(zip(names, host)), length

    def import_slot(self, slot: int, prefix: dict,
                    length: int) -> ImportStats:
        """Install an exported prefix into a (freshly alloc'd) slot,
        bit-exactly.  Raises if it does not fit: truncating it would decode
        from a corrupted context."""
        p = int(length)
        if p > self.s_max:
            raise ValueError(
                f"cannot import a {p}-token cache prefix into a pool with "
                f"s_max={self.s_max}; prefill and decode pools must agree")
        for k, v in self.cache.items():
            v[:, slot, :p] = from_host(np.asarray(prefix[k])[:, :p], v.dtype,
                                       self.device)
        self.lengths[slot] = p
        return ImportStats(self.handoff_bytes(prefix), 0, 0)

    @staticmethod
    def handoff_bytes(prefix: dict) -> int:
        """Payload size of one exported prefix (handoff traffic accounting)."""
        return int(sum(v.nbytes for v in prefix.values()))

    def positions(self) -> torch.Tensor:
        # a copy: on the CPU as_tensor would alias the lengths advance() bumps
        return torch.tensor(self.lengths, device=self.device)

    def advance(self, slots: list[int]) -> None:
        for s in slots:
            self.lengths[s] += 1
            assert self.lengths[s] <= self.s_max, \
                f"slot {s} advanced past s_max={self.s_max}"


class PagedKVCachePool:
    """Paged pool: fixed-size KV pages + per-slot page tables + a
    content-addressed prefix cache.

    Physical storage is (L, n_pages, page, H_kv, D); a slot's logical
    positions [0, lengths[slot]) live in ``page_tables[slot]`` (a list of
    physical page ids, at most ``pages_per_slot`` long).  ``block_tables``
    renders the tables as the dense (n_slots, pages_per_slot) int32 array
    the paged entry points consume.

    Sharing: full pages written by ``write_prefix``/``import_slot`` are
    keyed by a chained hash of their token ids (plus the producing
    prefill's bucket, see module docstring) and registered in
    ``prefix_index``.  A later prefix with the same chain key references
    the cached page (refcount bump) instead of writing it.  Released
    pages whose refcount reaches zero stay cached (LRU-evictable) until
    page pressure reclaims them.  Writes into a shared or cached page go
    through copy-on-extend (``_make_writable``), so a cached page's
    content is immutable for its lifetime in the index.

    ``metrics``: pages_allocated (fresh physical pages written),
    pages_shared (pages satisfied by the prefix cache), pages_cow
    (copy-on-extend copies), pages_evicted (cached pages reclaimed).
    """

    def __init__(self, cfg: tr.TransformerConfig, n_slots: int, s_max: int,
                 page_size: int = 16, spare_pages: int | None = None,
                 dtype=torch.bfloat16, device="cuda", h2d=None):
        self.device = resolve_device(device)
        self.h2d = h2d      # a telemetry Counter of copies to the device
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        self.cfg = cfg
        self.n_slots = n_slots
        self.s_max = s_max
        self.page_size = page_size
        self.pages_per_slot = -(-s_max // page_size)
        if spare_pages is None:
            # headroom for the prefix cache: evicted only under pressure
            spare_pages = n_slots * self.pages_per_slot
        self.n_pages = n_slots * self.pages_per_slot + max(spare_pages, 1)
        self.cache = tr.make_paged_cache(cfg, self.n_pages, page_size, dtype,
                                         device=self.device)
        self.lengths = np.zeros(n_slots, np.int32)
        self.free = list(range(n_slots))
        self.owner: dict[int, int] = {}               # slot -> request id
        self.page_tables: list[list[int]] = [[] for _ in range(n_slots)]
        self.ref = np.zeros(self.n_pages, np.int32)   # per physical page
        self.free_pages = list(range(self.n_pages))
        self.prefix_index: dict[bytes, int] = {}      # chain key -> phys page
        self.key_of: dict[int, bytes] = {}            # phys page -> chain key
        self._evictable: OrderedDict[int, None] = OrderedDict()  # LRU ref==0
        self.metrics = {"pages_allocated": 0, "pages_shared": 0,
                        "pages_cow": 0, "pages_evicted": 0}

    # ---------------- slots -------------------------------------------------

    def alloc(self, rid: int) -> int | None:
        if not self.free:
            return None
        slot = self.free.pop()
        self.owner[slot] = rid
        self.lengths[slot] = 0
        self.page_tables[slot] = []
        return slot

    def release(self, slot: int) -> None:
        """Free the slot; its pages drop a reference.  Content-addressed
        pages that reach refcount zero stay in the prefix cache
        (evictable) -- releasing one sharer never frees a live page, and
        a hot retrieved-context page survives its requests."""
        self.owner.pop(slot, None)
        for phys in self.page_tables[slot]:
            self._unref(phys)
        self.page_tables[slot] = []
        self.lengths[slot] = 0
        self.free.append(slot)

    # ---------------- physical page management -----------------------------

    def _unref(self, phys: int) -> None:
        self.ref[phys] -= 1
        assert self.ref[phys] >= 0, f"page {phys} refcount underflow"
        if self.ref[phys] == 0:
            if phys in self.key_of:
                self._evictable[phys] = None      # cached until pressure
            else:
                self.free_pages.append(phys)

    def _take_page(self) -> int:
        """A writable physical page: free first, then evict the coldest
        cached (refcount-zero) page from the prefix index."""
        if self.free_pages:
            phys = self.free_pages.pop()
        elif self._evictable:
            phys, _ = self._evictable.popitem(last=False)
            del self.prefix_index[self.key_of.pop(phys)]
            self.metrics["pages_evicted"] += 1
        else:
            raise RuntimeError(
                f"paged KV pool out of pages ({self.n_pages} total); "
                f"every page is referenced by a live slot")
        self.ref[phys] = 1
        self.metrics["pages_allocated"] += 1
        return phys

    def _reference(self, phys: int) -> None:
        if self.ref[phys] == 0:
            self._evictable.pop(phys, None)
        self.ref[phys] += 1
        self.metrics["pages_shared"] += 1

    def _register(self, phys: int, key: bytes) -> None:
        if key not in self.prefix_index:
            self.prefix_index[key] = phys
            self.key_of[phys] = key

    def _make_writable(self, slot: int, logical_page: int) -> None:
        """Copy-on-extend: before writing into a logical page, make sure
        the backing physical page is private and un-cached.  A shared page
        (refcount > 1) or a content-addressed one must not mutate -- other
        slots / future lookups see its bytes -- so the slot gets a copy."""
        phys = self.page_tables[slot][logical_page]
        if self.ref[phys] == 1 and phys not in self.key_of:
            return
        new = self._take_page()
        for v in self.cache.values():
            v[:, new] = v[:, phys]
        self.page_tables[slot][logical_page] = new
        self._unref(phys)
        self.metrics["pages_cow"] += 1

    def prepare_append(self, slot: int, n_tokens: int) -> None:
        """Make positions [length, length+n) writable: allocate tail pages
        and copy-on-extend any shared/cached page the write range touches.
        Host-side policy so the decode scatter never lands on a page it
        must not mutate."""
        start = int(self.lengths[slot])
        end = start + int(n_tokens)
        assert end <= self.s_max, \
            f"append to {end} would pass s_max={self.s_max} on slot {slot}"
        table = self.page_tables[slot]
        while len(table) * self.page_size < end:
            table.append(self._take_page())
        for lp in range(start // self.page_size,
                        -(-end // self.page_size)):
            self._make_writable(slot, lp)

    # ---------------- content addressing -----------------------------------

    def chain_keys(self, tokens, salt: bytes = b"") -> list[bytes]:
        """Chained content keys for the FULL pages covered by ``tokens``:
        ``key_j = H(key_{j-1} || tokens[j*page:(j+1)*page])`` seeded with
        the model name, page size and caller salt -- a page is only equal
        to another if its entire token prefix (and producing program, via
        the salt) is."""
        tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
        prev = hashlib.sha1(
            f"{self.cfg.name}:{self.page_size}:".encode() + salt).digest()
        out = []
        for j in range(len(tokens) // self.page_size):
            chunk = tokens[j * self.page_size:(j + 1) * self.page_size]
            prev = hashlib.sha1(prev + chunk.tobytes()).digest()
            out.append(prev)
        return out

    # ---------------- prefix install / handoff -----------------------------

    def write_prefix(self, slot: int, layer_cache: dict, prefix_len: int,
                     tokens=None, key_salt: bytes = b"") -> None:
        """Install a prefill-produced cache (L, 1, P, H, D) into the slot.

        With ``tokens`` (the prompt ids) given, every full page is
        content-addressed: a chain-key hit references the cached page and
        skips the write, a miss writes a fresh page and registers it.
        The partial tail page is always written privately."""
        p = min(int(prefix_len), self.s_max)
        ps = self.page_size
        assert not self.page_tables[slot], "write_prefix into a used slot"
        keys = self.chain_keys(np.asarray(tokens)[:p], key_salt) \
            if tokens is not None else []
        n_pages = -(-p // ps)
        table, fresh = [], []
        for j in range(n_pages):
            key = keys[j] if j < len(keys) else None
            hit = self.prefix_index.get(key) if key is not None else None
            if hit is not None:
                self._reference(hit)
                table.append(hit)
            else:
                phys = self._take_page()
                table.append(phys)
                fresh.append((j, phys))
                if key is not None:
                    self._register(phys, key)
        self.page_tables[slot] = table
        if fresh:
            # one scatter installs every freshly written page
            pad = n_pages * ps - p
            log_idx = torch.as_tensor([j for j, _ in fresh],
                                      device=self.device)
            phys_idx = torch.as_tensor([q for _, q in fresh],
                                       device=self.device)
            if self.h2d is not None:
                self.h2d.value += 2
            for k, v in layer_cache.items():
                rows = F.pad(v[:, 0, :p], (0, 0, 0, 0, 0, pad))
                pool = self.cache[k]
                pool[:, phys_idx] = rows.reshape(
                    pool.shape[0], n_pages, ps, *pool.shape[3:])[
                        :, log_idx].to(pool.dtype)
        self.lengths[slot] = p

    def export_slot(self, slot: int) -> tuple[PagedPrefix, int]:
        """Extract the slot's pages for a KV handoff.

        Every page's valid rows travel as host arrays together with its
        chain key (None for the unkeyed tail), so the payload is
        self-describing: the importer writes the pages it lacks and
        references the ones its prefix cache already holds.  The pages
        are fetched with one device gather per K/V into one page-major
        buffer and one copy to host memory; each page's arrays are views
        of that host buffer (a full page's are contiguous)."""
        length = int(self.lengths[slot])
        ps = self.page_size
        table = self.page_tables[slot][:-(-length // ps)] if length else []
        keys = [self.key_of.get(phys) for phys in table]
        if not table:
            return PagedPrefix(ps, length, keys, {}), length
        names = sorted(self.cache)
        pool = self.cache[names[0]]
        idx = torch.as_tensor(table, device=self.device)
        buf = torch.empty((len(names), len(table), pool.shape[0], ps,
                           *pool.shape[3:]),
                          dtype=pool.dtype, device=self.device)
        for i, k in enumerate(names):
            # (L, P, page, H, D) viewed page-major, pages picked in order
            torch.index_select(self.cache[k].transpose(0, 1), 0, idx,
                               out=buf[i])
        # page-locked on a GPU: the copy runs as one DMA at the link's rate
        host = torch.empty(buf.shape, dtype=buf.dtype,
                           pin_memory=self.device.type == "cuda")
        host = to_host(host.copy_(buf))
        pages = {j: {k: host[i, j, :, :min(length - j * ps, ps)]
                     for i, k in enumerate(names)}
                 for j in range(len(table))}
        return PagedPrefix(ps, length, keys, pages), length

    def import_slot(self, slot: int, prefix: PagedPrefix,
                    length: int | None = None) -> ImportStats:
        """Install a handed-off prefix.  Keyed pages already present in
        this pool's prefix cache are referenced (bit-identical by key
        construction) and their payload is NOT counted as shipped;
        everything else is written and registered.  The shipped pages'
        valid rows go to the device in one host-to-device copy and land
        with one indexed write per K/V.  Bit-exactness of the round trip
        is the same contract as the dense pool's."""
        if not isinstance(prefix, PagedPrefix):
            raise TypeError("paged pool can only import a PagedPrefix")
        if prefix.page_size != self.page_size:
            raise ValueError(
                f"cannot import page_size={prefix.page_size} pages into a "
                f"pool with page_size={self.page_size}")
        p = int(length if length is not None else prefix.length)
        if p > self.s_max:
            raise ValueError(
                f"cannot import a {p}-token cache prefix into a pool with "
                f"s_max={self.s_max}; prefill and decode pools must agree")
        assert not self.page_tables[slot], "import_slot into a used slot"
        ps = self.page_size
        names = sorted(self.cache)
        table, rows, pages = [], [], []
        shipped_bytes = shipped = shared = 0
        for j in range(-(-p // ps) if p else 0):
            key = prefix.keys[j]
            hit = self.prefix_index.get(key) if key is not None else None
            if hit is not None:
                self._reference(hit)
                table.append(hit)
                shared += 1
                continue
            payload = prefix.pages[j]
            phys = self._take_page()
            n = payload[names[0]].shape[1]
            rows.extend(range(phys * ps, phys * ps + n))
            pages.append(payload)
            if key is not None:
                self._register(phys, key)
            table.append(phys)
            shipped += 1
            shipped_bytes += sum(v.nbytes for v in payload.values())
        if pages:
            # the shipped rows side by side in one (n_names, L, rows, H_kv,
            # D) host buffer, then one copy
            first = np.asarray(pages[0][names[0]])
            staged = host_empty((len(names), first.shape[0], len(rows),
                                 *first.shape[2:]), first.dtype, self.device)
            at = 0
            for payload in pages:
                n = payload[names[0]].shape[1]
                for i, k in enumerate(names):
                    staged[i, :, at:at + n] = np.asarray(payload[k]).view(
                        staged.dtype)
                at += n
            dev = from_host(staged, self.cache[names[0]].dtype, self.device)
            row_idx = torch.as_tensor(rows, device=self.device)
            for i, k in enumerate(names):
                v = self.cache[k]
                v.view(v.shape[0], -1, *v.shape[3:])[:, row_idx] = dev[i]
        self.page_tables[slot] = table
        self.lengths[slot] = p
        return ImportStats(shipped_bytes, shipped, shared)

    @staticmethod
    def handoff_bytes(prefix: PagedPrefix) -> int:
        """Full payload size (== dense equivalent; see PagedPrefix)."""
        return prefix.nbytes

    # ---------------- decode-loop interface --------------------------------

    def block_tables(self) -> np.ndarray:
        """Dense (n_slots, pages_per_slot) int32 page-table view for the
        paged entry points.  Unallocated logical pages map to page 0;
        attention masking by length keeps them inert."""
        bt = np.zeros((self.n_slots, self.pages_per_slot), np.int32)
        for s, table in enumerate(self.page_tables):
            if table:
                bt[s, :len(table)] = table
        return bt

    def positions(self) -> torch.Tensor:
        # a copy: on the CPU as_tensor would alias the lengths advance() bumps
        return torch.tensor(self.lengths, device=self.device)

    def advance(self, slots: list[int]) -> None:
        for s in slots:
            self.lengths[s] += 1
            assert self.lengths[s] <= self.s_max, \
                f"slot {s} advanced past s_max={self.s_max}"


def payload_nbytes(prefix) -> int:
    """Dense-equivalent payload size of any exported prefix."""
    if isinstance(prefix, PagedPrefix):
        return prefix.nbytes
    return int(sum(v.nbytes for v in prefix.values()))


def payload_summary(prefix, length: int) -> dict:
    """Span-attribution view of a handoff payload: token count, dense
    payload bytes and (paged layout) page count -- the byte/token sizes
    the telemetry layer attaches to each HANDOFF span.  Tolerates a
    payload already lost in transit (``None``)."""
    if prefix is None:
        return {"tokens": int(length), "bytes_full": 0, "pages": 0}
    out = {"tokens": int(length), "bytes_full": payload_nbytes(prefix)}
    if isinstance(prefix, PagedPrefix):
        out["pages"] = len(prefix.pages)
    return out


def payload_checksum(prefix) -> int:
    """CRC32 over an exported KV payload's bytes (+ its logical layout).

    Computed at export and verified before import, so a handoff payload
    corrupted or truncated "on the wire" is REJECTED and the request
    retried instead of decoding from a garbage context -- the fault
    layer's end of the bit-exact handoff contract.  Covers both layouts:
    the paged :class:`PagedPrefix` (page order, chain keys and page bytes
    all feed the sum) and the dense ``{"k","v"}`` dict."""
    crc = 0
    if isinstance(prefix, PagedPrefix):
        crc = zlib.crc32(
            f"{prefix.page_size}:{prefix.length}".encode(), crc)
        for j in sorted(prefix.pages):
            key = prefix.keys[j] if j < len(prefix.keys) else None
            crc = zlib.crc32(key or b"\0", crc)
            page = prefix.pages[j]
            for name in sorted(page):
                crc = zlib.crc32(np.ascontiguousarray(
                    np.asarray(page[name])).view(np.uint8), crc)
        return crc
    for name in sorted(prefix):
        crc = zlib.crc32(np.ascontiguousarray(
            np.asarray(prefix[name])).view(np.uint8), crc)
    return crc
