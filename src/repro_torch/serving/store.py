"""SlotStore: the serving cache behind one protocol — the port of
``repro.serving.store`` for the dense family.

The engine decodes a fixed ``n_slots``-row batch; each row ("slot") is
leased to one in-flight request. Everything the engine knows about the
cache goes through the store: ``fits``/``available_now``/``lease``
(capacity checks and reservation), ``write_slots`` (one admission bucket's
K/V into its leased slots), ``reset`` (retire: back to the pristine
pattern), ``decode_cache``/``swap`` (the cache handed to and adopted back
from the decode step; ``swap_window`` after a speculative verify step),
``rollback`` (speculative decode: rejected window positions back to
pristine), ``gather_view`` (contiguous layout, for inspection) and
``memory_stats``.

Backends
  ContiguousKVStore  K/V rows (L, B, S, KV, hd) sized to ``max_seq_len``.
  PagedKVStore       a pool of ``block_size``-token blocks and per-slot block
                     tables; a request leases ceil((prompt + gen) / bs)
                     blocks, so a dry pool is admission backpressure. Two
                     decode bridges: the GATHER bridge (``native=False``)
                     gathers each slot's blocks into the contiguous view,
                     runs the contiguous store's decode step on it, and
                     writes the one new entry per row back into its block —
                     which makes it bit-identical to the contiguous store;
                     NATIVE mode hands the pool itself to the block-native
                     decode step (``decode_view_bytes: 0``).

Shared-prefix radix cache (paged, ``prefix_cache=True``): every FULL block
of an admitted prompt enters a trie keyed on chained token-id block hashes;
a later lease walks the trie with its prompt and leases each matched block
by refcount instead of drawing a fresh one, and the engine prefills only the
suffix. Shared blocks are immutable: admission writes to shared positions
go to the null block, and a prompt that diverges mid-block gets a
copy-on-write fork of the divergence block. ``reset`` scrubs and frees only
blocks whose refcount reaches zero and the trie does not hold; under pool
pressure unreferenced cached prefixes are evicted leaf first in LRU order.
Every non-null block is in exactly one of {free, referenced, cached and
unreferenced} (``debug_block_census``).

Cross-host shipping (paged; prefill/decode disaggregation): ``export_blocks``
serializes a slot's written blocks into a layout-tagged, checksummed payload
and moves the slot's lease onto an export ledger (the blocks stay referenced
until ``release_exported``); ``import_blocks`` validates such a payload and
writes it verbatim into a freshly leased slot of another pool. bf16 leaves
travel as their raw 16-bit words (numpy has no bfloat16) under the
reference's layout tag, so the checksum runs over the reference's bytes.

Leaf convention: ``index`` (B,) carries the slot on axis 0, ``tables``
(B, MB) too; every other leaf on axis 1 (L, B, ...). ``pristine_value`` is
the one definition of each leaf's empty fill. The stores write their
tensors in place where the JAX package donates them.
"""

from __future__ import annotations

import abc
import math
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import serve as SV

_META = ("index", "tables")


def pristine_value(name: str) -> float:
    """A cache leaf's empty-state fill value, shared by every reset, pad
    scrub and block scrub (int8-KV dequant scales park at 1e-12 so a
    pristine entry dequantizes to exactly 0; the recurrent families'
    non-zero fills come with those families)."""
    return 1e-12 if name.endswith("_scale") else 0.0


def _kv_leaves(cache: Dict) -> Dict[str, torch.Tensor]:
    return {n: t for n, t in cache.items() if n not in _META}


# a shipped leaf's numpy dtype, by the dtype its layout tag names: numpy has
# no bfloat16, so bf16 travels as its raw 16-bit words
_WIRE_DTYPES = {"bfloat16": np.dtype(np.uint16)}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _to_wire(t: torch.Tensor) -> np.ndarray:
    """A cache leaf's bits as a host numpy array (bf16 as uint16 words)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _from_wire(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`_to_wire`: the same bits as a ``dtype`` tensor."""
    arr = np.ascontiguousarray(arr)
    if dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _set_entries(cache: Dict, name: str, idx, values) -> Dict:
    """A copy of the small ``name`` leaf (index or tables) with
    ``leaf[idx] = values``; the caller swaps it in."""
    leaf = cache[name].clone()
    leaf[idx] = values
    return dict(cache, **{name: leaf})


class SlotStore(abc.ABC):
    """Slot-granular ownership of the decode batch's cache. Subclasses
    build the cache in ``alloc`` and seed it in ``write_slots``; the
    row-generic lifecycle (reset, decode bridge, info) is shared."""

    kind = "abstract"

    def __init__(self, cfg: ArchConfig, n_slots: int, max_seq_len: int, device=None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq_len = max_seq_len
        self.device = torch.device("cpu" if device is None else device)
        self.cache: Dict[str, torch.Tensor] = self.alloc()

    @abc.abstractmethod
    def alloc(self) -> Dict:
        """Build the cache dict, once."""

    @abc.abstractmethod
    def write_slots(self, slots: Sequence[int], kv: Dict, n_valid: Sequence[int]) -> None:
        """Seed the leased rows of one admission bucket from its prefill's
        K/V (L, B, Sb, ...), in place."""

    # ----------------------------------------------------------- reservation

    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Whether a request of this size could EVER be leased (total
        capacity): the engine rejects at submit when False, so a request
        that can never fit bounces at the door instead of deferring forever
        at the queue head."""
        return True

    def lease(self, slot: int, prompt_len: int, max_new_tokens: int,
              tokens: Optional[np.ndarray] = None) -> bool:
        """Reserve capacity for a request on ``slot``; False is admission
        backpressure. ``tokens`` (the prompt) lets a prefix-aware store
        match cached content; other stores ignore it."""
        return True

    def available_now(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Whether a ``lease`` would succeed right now, reserving nothing."""
        return self.fits(prompt_len, max_new_tokens)

    # ------------------------------------------------------------- lifecycle

    def reset(self, slot: int) -> None:
        """Retire a request: scrub the slot's row to pristine so nothing
        leaks into its next tenant, and park its index at 0."""
        assert 0 <= slot < self.n_slots
        for name, leaf in _kv_leaves(self.cache).items():
            leaf[:, slot] = pristine_value(name)
        self.cache = _set_entries(self.cache, "index", slot, 0)

    # ---------------------------------------------------------- decode bridge

    def decode_cache(self) -> Dict:
        """The cache handed to the decode step."""
        return self.cache

    def swap(self, new_cache: Dict) -> None:
        """Adopt the cache returned by a decode step."""
        self.cache = new_cache

    def swap_window(self, new_cache: Dict, window: int) -> None:
        """Adopt the cache returned by a W-position verify step (speculative
        decode). Stores whose decode bridge is the cache itself just swap;
        the paged gather bridge writes all W entries per row back."""
        self.swap(new_cache)

    def rollback(self, slots, new_index, positions) -> None:
        """Speculative rollback: scrub the rejected window positions
        ``positions[i, :]`` (pad: max_seq_len) of each row ``slots[i]``
        (pad: n_slots) back to pristine and set the row's index to
        ``new_index[i]`` (host arrays). Correctness, not hygiene: later
        verify horizons reach these positions, so a stale rejected entry
        would move scores."""
        slots_np = np.asarray(slots, np.int64)
        pos_np = np.asarray(positions, np.int64)
        live = slots_np < self.n_slots
        cell = live[:, None] & (pos_np < self.max_seq_len)
        rows = np.broadcast_to(slots_np[:, None], pos_np.shape)[cell]
        self._scrub_positions(rows, pos_np[cell])
        self.cache = _set_entries(
            self.cache, "index", torch.as_tensor(slots_np[live], device=self.device),
            torch.as_tensor(np.asarray(new_index, np.int32)[live], device=self.device))

    def _scrub_positions(self, slots: np.ndarray, positions: np.ndarray) -> None:
        """Back to pristine: position ``positions[i]`` of slot ``slots[i]``,
        each pair valid (host arrays)."""
        raise NotImplementedError(f"{self.kind} store does not support speculative rollback")

    def gather_view(self) -> Dict:
        """Contiguous-layout view of the cache (inspection and tests)."""
        return self.cache

    # ------------------------------------------------------------------ info

    def slot_index(self, slot: int) -> int:
        """The slot's write position (= valid length): 0 when pristine, the
        prompt length after admission, +1 per decode step. Reads the
        device: for inspection, not the decode path."""
        return int(self.cache["index"][slot])

    def nbytes(self) -> int:
        """Resident bytes of the cache (every leaf). The paged bridge's
        transient decode view is not in here: ``decode_view_bytes``."""
        return sum(t.numel() * t.element_size() for t in self.cache.values())

    def memory_stats(self) -> Dict:
        b = self.nbytes()
        return {"backend": self.kind, "bytes": b,
                "bytes_per_slot": b // max(self.n_slots, 1), "slots": self.n_slots}


class ContiguousKVStore(SlotStore):
    """Dense-family K/V rows sized to ``max_seq_len``: k/v (L, B, S, KV, hd)
    and int8 scales (L, B, S, KV) carry the slot on axis 1; index (B,)."""

    kind = "contiguous"

    def __init__(self, cfg: ArchConfig, n_slots: int, max_seq_len: int, device=None):
        if cfg.family != "dense":
            raise ValueError(f"ContiguousKVStore supports dense-family caches, "
                             f"not {cfg.family}")
        super().__init__(cfg, n_slots, max_seq_len, device)

    def alloc(self) -> Dict:
        return SV.init_cache(self.cfg, self.n_slots, self.max_seq_len,
                             per_slot_index=True, device=self.device)

    def write_slots(self, slots, kv: Dict, n_valid) -> None:
        """Scatter one admission bucket's K/V (L, B, Sb, ...) into rows
        ``slots``, set each row's index to its prompt length, and scrub every
        position at or past it to pristine, in place."""
        slots_t = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        n_valid_t = torch.as_tensor(np.asarray(n_valid, np.int32), device=self.device)
        S = self.max_seq_len
        valid = torch.arange(S, device=self.device)[None, :] < n_valid_t[:, None]
        for name, leaf in _kv_leaves(self.cache).items():
            src = kv[name].to(leaf.dtype)
            Sb = src.shape[2]
            if S > Sb:                       # pad the bucket out to the row length
                pad = src.new_zeros(src.shape[:2] + (S - Sb,) + src.shape[3:])
                src = torch.cat([src, pad], dim=2)
            keep = valid.reshape(valid.shape + (1,) * (src.ndim - 3))
            leaf[:, slots_t] = torch.where(keep, src, torch.full_like(src, pristine_value(name)))
        self.cache = _set_entries(self.cache, "index", slots_t, n_valid_t)

    def _scrub_positions(self, slots: np.ndarray, positions: np.ndarray) -> None:
        s_t = torch.as_tensor(slots, device=self.device)
        p_t = torch.as_tensor(positions, device=self.device)
        for name, leaf in _kv_leaves(self.cache).items():
            leaf[:, s_t, p_t] = pristine_value(name)


class PagedKVStore(SlotStore):
    """Block-paged K/V. Pool leaves k/v (L, NB, bs, KV, hd) and int8 scales
    (L, NB, bs, KV); per-slot tables (B, MB) map position p to pool cell
    ``(tables[slot, p // bs], p % bs)``. Block 0 is the reserved null block:
    never leased, it absorbs idle-slot writes and backs table entries past a
    lease. A request leases ceil((prompt + gen) / bs) blocks at admission,
    so decode never runs out mid-flight. Leases edit a host mirror of the
    tables, uploaded once when the device next needs them (``table_uploads``).

    ``native`` hands the pool to the block-native decode step; otherwise
    the gather bridge runs the contiguous decode step on a gathered view.
    ``prefix_cache`` keeps the shared-prefix radix cache (module doc):
    ``lease`` then takes the prompt ``tokens`` and ``prefix_lease_info``
    tells the engine how much prefill to skip."""

    kind = "paged"

    def __init__(self, cfg: ArchConfig, n_slots: int, max_seq_len: int, *,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 native: bool = False, prefix_cache: bool = False, device=None):
        if cfg.family != "dense":
            raise ValueError(f"PagedKVStore supports dense-family caches, not {cfg.family}")
        if max_seq_len % block_size:
            # the gathered view must be exactly max_seq_len long, so the bridge
            # runs the contiguous store's decode step: the bit-identity contract
            raise ValueError(
                f"block_size {block_size} must divide max_seq_len {max_seq_len}")
        self.block_size = block_size
        self.blocks_per_slot = max_seq_len // block_size
        full = n_slots * self.blocks_per_slot + 1          # +1: null block
        self.n_blocks = full if n_blocks is None else n_blocks
        if self.n_blocks < 2:
            raise ValueError(f"n_blocks must be >= 2, got {self.n_blocks}")
        self.native = native
        super().__init__(cfg, n_slots, max_seq_len, device)
        # block 0 reserved as the null block; free blocks hand out low ids first
        self._free: List[int] = list(range(1, self.n_blocks))[::-1]
        self._leased: Dict[int, List[int]] = {}
        self._tables = np.zeros((n_slots, self.blocks_per_slot), np.int32)
        self._tables_dirty = False
        self.table_uploads = 0
        # per-block lease refcount (kept with the prefix cache off too, so
        # reset's scrub decision is the same code): 0 = free or cached and
        # unreferenced, n > 0 = leased by n slots
        self.prefix_cache = prefix_cache
        self._ref = np.zeros(self.n_blocks, np.int64)
        # radix trie over FULL prompt blocks: node 0 is the root; every other
        # node owns one pool block holding one full block of an admitted
        # prompt, keyed under its parent by the block's token hash (the
        # stored token ids settle collisions)
        self._nodes: Dict[int, Dict] = {
            0: {"parent": -1, "hash": 0, "block": 0, "tokens": None,
                "kids": {}, "children": 0, "tick": 0}}
        self._block_node: Dict[int, int] = {}     # pool block -> trie node
        self._node_ids = 1
        self._lru_tick = 0
        self._slot_meta: Dict[int, Dict] = {}     # prefix-lease record per slot
        self.prefix_hits = 0
        self.prefix_blocks_reused = 0
        self.prefix_tokens_reused = 0
        self.prefix_evictions = 0
        self.cow_forks = 0
        # cross-host export ledger: payload id -> the blocks an exported
        # slot's lease moved to. The ledger holds their refcount until
        # release_exported, so an unacked block is never leased as fresh
        self._exported: Dict[str, List[int]] = {}
        self.blocks_exported = 0
        self.blocks_imported = 0

    def alloc(self) -> Dict:
        return SV.init_paged_cache(self.cfg, self.n_slots, self.n_blocks,
                                   self.block_size, self.blocks_per_slot,
                                   device=self.device)

    # ----------------------------------------------------------- reservation

    def _blocks_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        return math.ceil((prompt_len + max_new_tokens) / self.block_size)

    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        # against the WHOLE pool and the table width: lease would refuse a
        # wider request forever (livelock)
        return (self._blocks_needed(prompt_len, max_new_tokens)
                <= min(self.n_blocks - 1, self.blocks_per_slot))

    def _n_evictable(self) -> int:
        """Cached blocks no lease references: all reachable by leaf-first
        eviction once nothing holds a reference into them."""
        if not self.prefix_cache:
            return 0
        return sum(1 for b in self._block_node if self._ref[b] == 0)

    def available_now(self, prompt_len: int, max_new_tokens: int) -> bool:
        # cached but unreferenced blocks count: lease evicts them before refusing
        need = self._blocks_needed(prompt_len, max_new_tokens)
        return (need <= len(self._free) + self._n_evictable()
                and need <= self.blocks_per_slot)

    # ----------------------------------------------------- prefix radix trie

    def _tick(self) -> int:
        self._lru_tick += 1
        return self._lru_tick

    def _block_hash(self, blk: np.ndarray) -> int:
        return zlib.crc32(np.ascontiguousarray(blk, np.int32).tobytes())

    def _match_prefix(self, tokens: np.ndarray, prompt_len: int):
        """Walk the trie with the prompt's full blocks. Returns
        ``(matched_node_ids, fork_src_block)``: the chain of cached nodes
        holding the prompt's leading full blocks verbatim and, when every
        full block matched and the prompt's partial tail (r = prompt_len mod
        bs tokens) equals the first r tokens of a cached child, that child's
        block (the freshest) as the copy-on-write source."""
        node, matched = 0, []
        bs = self.block_size
        full = prompt_len // bs
        for i in range(full):
            blk = tokens[i * bs:(i + 1) * bs]
            kid = self._nodes[node]["kids"].get(self._block_hash(blk))
            if kid is None or not np.array_equal(self._nodes[kid]["tokens"], blk):
                return matched, None          # divergence at a block boundary
            matched.append(kid)
            node = kid
        r = prompt_len - full * bs
        if r:
            best = None
            for kid in self._nodes[node]["kids"].values():
                nd = self._nodes[kid]
                if np.array_equal(nd["tokens"][:r], tokens[full * bs:prompt_len]):
                    if best is None or nd["tick"] > self._nodes[best]["tick"]:
                        best = kid
            if best is not None:
                return matched, self._nodes[best]["block"]
        return matched, None

    def _evict_cached(self, n: int, pinned: frozenset) -> None:
        """Free up to ``n`` blocks by evicting unreferenced cached prefixes,
        least recently used LEAF first (an interior node is evictable only
        once its children are gone). ``pinned`` protects the blocks the
        lease in progress is about to reference. Evicted blocks are scrubbed
        to pristine before they rejoin the free list."""
        freed: List[int] = []
        while len(freed) < n:
            best = None
            for nid, nd in self._nodes.items():
                if (nid == 0 or nd["children"] or nd["block"] in pinned
                        or self._ref[nd["block"]] > 0):
                    continue
                if best is None or nd["tick"] < self._nodes[best]["tick"]:
                    best = nid
            if best is None:
                break
            nd = self._nodes.pop(best)
            parent = self._nodes[nd["parent"]]
            del parent["kids"][nd["hash"]]
            parent["children"] -= 1
            del self._block_node[nd["block"]]
            freed.append(nd["block"])
            self.prefix_evictions += 1
        if freed:
            self._scrub_free(freed)

    def _scrub_blocks(self, blocks: List[int]) -> None:
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        for name, leaf in _kv_leaves(self.cache).items():
            leaf[:, idx] = pristine_value(name)

    def _scrub_free(self, blocks: List[int]) -> None:
        """Scrub freed blocks to pristine and return them to the free list."""
        self._scrub_blocks(blocks)
        self._free.extend(blocks)

    def _copy_block(self, src: int, dst: int) -> None:
        """The copy-on-write fork: every K/V leaf (scales included) of block
        ``src`` into ``dst``. Copying the same source again gives the same
        bits, so a repeated fork is harmless."""
        for leaf in _kv_leaves(self.cache).values():
            leaf[:, dst] = leaf[:, src]

    # ----------------------------------------------------------------- lease

    def lease(self, slot: int, prompt_len: int, max_new_tokens: int,
              tokens: Optional[np.ndarray] = None) -> bool:
        need = self._blocks_needed(prompt_len, max_new_tokens)
        if need > self.blocks_per_slot:
            return False
        shared_nodes: List[int] = []
        fork_src: Optional[int] = None
        if self.prefix_cache and tokens is not None:
            tokens = np.asarray(tokens, np.int32).reshape(-1)
            assert len(tokens) == prompt_len
            shared_nodes, fork_src = self._match_prefix(tokens, prompt_len)
        shared = [self._nodes[n]["block"] for n in shared_nodes]
        need_fresh = need - len(shared)
        if need_fresh > len(self._free):
            pinned = frozenset(shared if fork_src is None else shared + [fork_src])
            self._evict_cached(need_fresh - len(self._free), pinned)
        if need_fresh > len(self._free):
            return False
        tick = self._tick()
        for nid in shared_nodes:
            self._nodes[nid]["tick"] = tick
            self._ref[self._nodes[nid]["block"]] += 1
        fresh: List[int] = []
        for _ in range(need_fresh):
            b = self._free.pop()
            # a block handed out as fresh must be wholly unowned
            assert self._ref[b] == 0 and b not in self._block_node, (
                f"block {b} leased as fresh while referenced/cached (ref={self._ref[b]})")
            self._ref[b] = 1
            fresh.append(b)
        blocks = shared + fresh
        self._leased[slot] = blocks
        self._tables[slot, :] = 0
        self._tables[slot, :need] = blocks
        self._tables_dirty = True
        shared_tok = len(shared) * self.block_size
        matched_tok = shared_tok
        if fork_src is not None:
            # the divergence block's leading tokens are the prompt's tail: a
            # private copy supplies them, and the cached original stays
            # immutable when decode writes mid-block
            self._copy_block(fork_src, fresh[0])
            self.cow_forks += 1
            matched_tok = prompt_len
        if self.prefix_cache and tokens is not None:
            # recompute at least the last prompt position: admission must
            # produce the first token's logits
            start = min(matched_tok, prompt_len - 1)
            self._slot_meta[slot] = {
                "tokens": tokens.copy(), "prompt_len": prompt_len,
                "shared_tokens": shared_tok, "prefill_start": start,
                "forked": fork_src is not None, "committed": False}
            if shared or fork_src is not None:
                self.prefix_hits += 1
                self.prefix_blocks_reused += len(shared)
                self.prefix_tokens_reused += start
        return True

    def prefix_lease_info(self, slot: int) -> Dict:
        """What the prefix cache did for this slot's lease: ``hit``,
        ``shared_blocks``/``shared_tokens`` (cached blocks leased by
        refcount), ``forked`` (a COW fork supplied the mid-block tail) and
        ``prefill_start``, the first position admission must compute."""
        meta = self._slot_meta.get(slot)
        if meta is None:
            return {"hit": False, "shared_blocks": 0, "shared_tokens": 0,
                    "forked": False, "prefill_start": 0}
        return {"hit": meta["shared_tokens"] > 0 or meta["forked"],
                "shared_blocks": meta["shared_tokens"] // self.block_size,
                "shared_tokens": meta["shared_tokens"],
                "forked": meta["forked"],
                "prefill_start": meta["prefill_start"]}

    def _sync_tables(self) -> None:
        if self._tables_dirty:
            self.cache = dict(self.cache, tables=torch.as_tensor(
                self._tables, device=self.device))
            self.table_uploads += 1
            self._tables_dirty = False

    # ------------------------------------------------------------- lifecycle

    def write_slots(self, slots, kv: Dict, n_valid) -> None:
        """Scatter one admission bucket's K/V (L, B, Sb, ...) through each
        row's block table, in place. Pad positions are written pristine; pad
        positions past a lease, and the positions of shared prefix blocks
        (immutable: the cached entries already hold them), go to the null
        block. Then each slot's full prompt blocks enter the trie."""
        slots_np = np.asarray(slots, np.int64)
        Sb = kv["k"].shape[2]
        pos = np.arange(Sb)
        phys = self._tables[slots_np][:, pos // self.block_size].copy()  # (B, Sb)
        for i, s in enumerate(slots_np):
            meta = self._slot_meta.get(int(s))
            if meta and meta["shared_tokens"]:
                phys[i, :min(meta["shared_tokens"], Sb)] = 0
        off = np.broadcast_to(pos % self.block_size, phys.shape).copy()
        phys_t = torch.as_tensor(phys, dtype=torch.long, device=self.device)
        off_t = torch.as_tensor(off, dtype=torch.long, device=self.device)
        n_valid_t = torch.as_tensor(np.asarray(n_valid, np.int32), device=self.device)
        valid = torch.arange(Sb, device=self.device)[None, :] < n_valid_t[:, None]
        for name, leaf in _kv_leaves(self.cache).items():
            src = kv[name].to(leaf.dtype)
            keep = valid.reshape(valid.shape + (1,) * (src.ndim - 3))
            leaf[:, phys_t, off_t] = torch.where(
                keep, src, torch.full_like(src, pristine_value(name)))
        self.cache = _set_entries(self.cache, "index",
                                  torch.as_tensor(slots_np, device=self.device), n_valid_t)
        for s in slots_np:
            self._commit_prefix(int(s))

    def _commit_prefix(self, slot: int) -> None:
        """Register the slot's FULL prompt blocks in the trie once its
        prompt K/V is written. Blocks already cached along the chain are
        skipped (the slot shares them); partial-tail and generation blocks
        never enter the trie."""
        meta = self._slot_meta.get(slot)
        if meta is None or meta["committed"]:
            return
        meta["committed"] = True
        tokens, n = meta["tokens"], meta["prompt_len"]
        bs = self.block_size
        node = 0
        for i in range(n // bs):
            blk = tokens[i * bs:(i + 1) * bs]
            h = self._block_hash(blk)
            kid = self._nodes[node]["kids"].get(h)
            if kid is not None:
                if not np.array_equal(self._nodes[kid]["tokens"], blk):
                    break          # hash collision: stop caching this chain
                node = kid
                continue
            b = int(self._tables[slot, i])
            if b == 0 or b in self._block_node:
                break              # never alias a cached block
            nid = self._node_ids
            self._node_ids += 1
            self._nodes[nid] = {"parent": node, "hash": h, "block": b,
                                "tokens": blk.copy(), "kids": {},
                                "children": 0, "tick": self._tick()}
            self._nodes[node]["kids"][h] = nid
            self._nodes[node]["children"] += 1
            self._block_node[b] = nid
            node = nid

    def commit_prefix(self, slot: int) -> None:
        """Public trie registration hook (``write_slots`` calls it for every
        slot it seeds); tests drive it without a prefill."""
        self._commit_prefix(slot)

    def reset(self, slot: int) -> None:
        """Retire a slot: drop its reference on every leased block, then
        scrub and free ONLY the blocks whose refcount reached zero and that
        the trie does not hold (a cached prefix survives bit-intact, now
        evictable), together with the null block; zero its table row and
        park its index at 0."""
        assert 0 <= slot < self.n_slots
        blocks = self._leased.pop(slot, [])
        self._slot_meta.pop(slot, None)
        scrub: List[int] = []
        for b in blocks:
            assert self._ref[b] > 0, f"double-free of block {b}"
            self._ref[b] -= 1
            if self._ref[b] == 0:
                if b in self._block_node:
                    self._nodes[self._block_node[b]]["tick"] = self._tick()
                else:
                    self._free.append(b)
                    scrub.append(b)
        self._tables[slot, :] = 0
        self._scrub_blocks(scrub + [0])
        cache = _set_entries(self.cache, "tables", slot, 0)
        self.cache = _set_entries(cache, "index", slot, 0)

    # ------------------------------------------------------ cross-host shipping

    def _payload_crc(self, header: str, leaves: Dict[str, np.ndarray]) -> int:
        """Checksum over the header and every leaf's raw bytes, in name
        order. Import recomputes it and refuses a mismatch."""
        crc = zlib.crc32(header.encode())
        for name in sorted(leaves):
            crc = zlib.crc32(np.ascontiguousarray(leaves[name]).tobytes(), crc)
        return crc

    def export_blocks(self, slot: int, *, payload_id: str) -> Dict:
        """Serialize ``slot``'s written blocks (every position below its
        index) for another host's pool and move the slot's lease onto the
        export ledger: nothing is decremented, scrubbed or freed, so shared
        prefix blocks stay intact and no exported block is re-leased while
        the ship is in flight. The slot is cleared (table row zeroed, index
        parked) and reusable at once. The blocks are gathered on the device
        and each leaf copied to the host once."""
        if payload_id in self._exported:
            raise ValueError(f"payload id {payload_id!r} already exported")
        blocks = self._leased.pop(slot, None)
        if blocks is None:
            raise KeyError(f"slot {slot} holds no lease to export")
        self._slot_meta.pop(slot, None)
        n_valid = self.slot_index(slot)
        nb = math.ceil(n_valid / self.block_size)
        idx = torch.as_tensor(blocks[:nb], dtype=torch.long, device=self.device)
        leaves = {name: _to_wire(leaf[:, idx]) for name, leaf in _kv_leaves(self.cache).items()}
        header = f"{payload_id}:{n_valid}:{nb}:{self.block_size}"
        payload = {
            "payload_id": payload_id,
            "n_valid": n_valid,
            "n_blocks": nb,
            "layout": {
                "block_size": self.block_size,
                "leaves": {name: {"dtype": _dtype_name(leaf.dtype),
                                  "shape": [int(leaf.shape[0]), nb] + [int(d) for d in
                                                                       leaf.shape[2:]]}
                           for name, leaf in _kv_leaves(self.cache).items()},
            },
            "leaves": leaves,
            "crc": self._payload_crc(header, leaves),
        }
        self._exported[payload_id] = blocks
        self.blocks_exported += nb
        # clear the slot without scrubbing its blocks (the ledger owns them):
        # what reset does with nothing to free, the null block's scrub
        self._tables[slot, :] = 0
        self._scrub_blocks([0])
        cache = _set_entries(self.cache, "tables", slot, 0)
        self.cache = _set_entries(cache, "index", slot, 0)
        return payload

    def release_exported(self, payload_id: str) -> bool:
        """Settle one ledger entry: drop its reference on every block and
        scrub and free the blocks that reach zero and the trie does not hold
        (reset's decision per block). Idempotent: an unknown or released id
        is a no-op returning False."""
        blocks = self._exported.pop(payload_id, None)
        if blocks is None:
            return False
        scrub: List[int] = []
        for b in blocks:
            assert self._ref[b] > 0, f"double-free of exported block {b}"
            self._ref[b] -= 1
            if self._ref[b] == 0:
                if b in self._block_node:
                    self._nodes[self._block_node[b]]["tick"] = self._tick()
                else:
                    scrub.append(b)
        if scrub:
            self._scrub_free(scrub)
        return True

    def import_blocks(self, slot: int, payload: Dict) -> None:
        """Adopt a shipped payload into ``slot``'s freshly leased blocks:
        validate the layout tag, geometry, dtypes, lengths and checksum
        against this pool, then write the shipped bits verbatim and set the
        slot's index to the shipped valid length. Any mismatch raises
        ValueError before a device write (the caller unwinds the lease with
        ``reset``). Imported blocks stay private: never in the trie."""
        blocks = self._leased.get(slot)
        if blocks is None:
            raise KeyError(f"slot {slot} holds no lease to import into")
        layout = payload.get("layout") or {}
        if int(layout.get("block_size", -1)) != self.block_size:
            raise ValueError(f"shipped block_size {layout.get('block_size')} != pool "
                             f"block_size {self.block_size}")
        n_valid = int(payload["n_valid"])
        nb = int(payload["n_blocks"])
        if nb != math.ceil(n_valid / self.block_size):
            raise ValueError(f"shipped payload claims {nb} blocks for n_valid {n_valid} "
                             f"(block_size {self.block_size})")
        if nb > len(blocks):
            raise ValueError(f"shipped payload needs {nb} blocks but the lease holds "
                             f"{len(blocks)}")
        pool = _kv_leaves(self.cache)
        leaves = payload.get("leaves") or {}
        if set(leaves) != set(pool) or set(layout.get("leaves") or {}) != set(pool):
            raise ValueError(f"shipped leaves {sorted(leaves)} != pool leaves "
                             f"{sorted(pool)} (kv dtype/scale layout mismatch)")
        arrays = {}
        for name in sorted(pool):
            arr = np.asarray(leaves[name])
            tag = layout["leaves"][name]
            want = [int(pool[name].shape[0]), nb] + [int(d) for d in pool[name].shape[2:]]
            if (str(arr.dtype) != str(_WIRE_DTYPES.get(tag["dtype"], tag["dtype"]))
                    or list(arr.shape) != [int(d) for d in tag["shape"]]):
                raise ValueError(f"shipped leaf {name!r} does not match its layout tag "
                                 f"(payload truncated or corrupted)")
            if list(arr.shape) != want or tag["dtype"] != _dtype_name(pool[name].dtype):
                raise ValueError(f"shipped leaf {name!r} {tag['dtype']}{list(arr.shape)} "
                                 f"does not fit pool leaf "
                                 f"{_dtype_name(pool[name].dtype)}{want}")
            arrays[name] = arr
        header = f"{payload['payload_id']}:{n_valid}:{nb}:{self.block_size}"
        if self._payload_crc(header, arrays) != int(payload["crc"]):
            raise ValueError(f"shipped payload {payload['payload_id']!r} failed its "
                             f"checksum: refusing to import corrupt blocks")
        idx = torch.as_tensor(blocks[:nb], dtype=torch.long, device=self.device)
        for name, leaf in pool.items():
            leaf[:, idx] = _from_wire(arrays[name], leaf.dtype).to(self.device)
        if nb < self.blocks_per_slot:
            # the reference pads the write to the table width with pristine
            # rows aimed at the null block: the null block ends up scrubbed
            self._scrub_blocks([0])
        self.cache = _set_entries(self.cache, "index", slot, n_valid)
        self.blocks_imported += nb

    # ---------------------------------------------------------- decode bridge

    def decode_cache(self) -> Dict:
        """Native mode: the pool itself (blocks + tables + index), which the
        block-native decode step writes and attends through in place.
        Bridge mode: every slot's blocks gathered into the contiguous view
        the contiguous decode step reads — layout translation lives here,
        the decode math is the contiguous store's."""
        self._sync_tables()
        if self.native:
            return self.cache
        return self.gather_view()

    def swap(self, new_cache: Dict) -> None:
        """Native mode: adopt the pool (same tensors, new index). Bridge
        mode: write the view's one new entry per row, at its pre-step index,
        back into its pool cell; rows whose table is zeroed (idle slots)
        write into the null block. Writing the same view back twice gives
        the same pool."""
        if self.native:
            self.cache = new_cache
            return
        index = self.cache["index"]                  # pre-step write positions
        tables = self.cache["tables"]
        bs = self.block_size
        rows = torch.arange(self.n_slots, device=self.device)
        pos = torch.clamp(index, max=self.max_seq_len - 1).long()
        phys = tables[rows, pos // bs].long()
        off = pos % bs
        for name, leaf in _kv_leaves(self.cache).items():
            leaf[:, phys, off] = new_cache[name][:, rows, pos]
        self.cache = dict(self.cache, index=new_cache["index"])

    def swap_window(self, new_cache: Dict, window: int) -> None:
        """Native mode: adopt the pool. Bridge mode: write the view's W new
        entries per row, at its pre-step index .. index + W - 1, back into
        their pool cells; positions past the row (idle rows whose index ran
        on, a window at the end of a lease) go to the null block, as the
        block-native verify's own writes do."""
        if self.native:
            self.cache = new_cache
            return
        index = self.cache["index"]                  # pre-step write positions
        tables = self.cache["tables"]
        bs = self.block_size
        rows = torch.arange(self.n_slots, device=self.device)[:, None]
        positions = index[:, None] + torch.arange(window, device=self.device)
        in_range = positions < self.max_seq_len
        pos = torch.clamp(positions, max=self.max_seq_len - 1).long()
        phys = torch.where(in_range, tables[rows, pos // bs].long(), 0)
        off = torch.where(in_range, pos % bs, 0)
        for name, leaf in _kv_leaves(self.cache).items():
            leaf[:, phys, off] = new_cache[name][:, rows, pos]
        self.cache = dict(self.cache, index=new_cache["index"])

    def _scrub_positions(self, slots: np.ndarray, positions: np.ndarray) -> None:
        """Through the host table mirror. A rejected position always lies in
        a PRIVATE cell: generation positions start at the prompt length, past
        every shared prefix block, inside the slot's lease; positions past
        the lease name the null block, whose scrub is harmless."""
        bs = self.block_size
        phys = torch.as_tensor(self._tables[slots, positions // bs].astype(np.int64),
                               device=self.device)
        off = torch.as_tensor(positions % bs, device=self.device)
        for name, leaf in _kv_leaves(self.cache).items():
            leaf[:, phys, off] = pristine_value(name)

    def gather_view(self) -> Dict:
        """The pool in contiguous layout {k, v, (scales), index}: every
        slot's blocks in table order. Entries past a lease are null-block
        contents, at positions past the slot's index, where decode gives
        them weight 0 — so the view decodes like the contiguous store."""
        self._sync_tables()
        view = A.gather_block_kv(_kv_leaves(self.cache), self.cache["tables"])
        view["index"] = self.cache["index"]
        return view

    def gather_prefix_rows(self, slots: Sequence[int], length: int) -> Dict:
        """Contiguous K/V rows (L, B, length, ...) of positions 0..length-1
        of ``slots``, through the tables: the suffix prefill's accumulator
        seed. The suffix scan reads only positions its lease matched below
        the start chunk; the rest (null-block contents past a lease) is
        masked or overwritten before it is read."""
        assert length % self.block_size == 0
        tb = self._tables[np.asarray(slots, np.int64)][:, :length // self.block_size]
        return A.gather_block_kv(_kv_leaves(self.cache),
                                 torch.as_tensor(tb, device=self.device))

    # ------------------------------------------------------------------ info

    def debug_block_census(self) -> Dict[str, List[int]]:
        """The block-lifecycle partition: every non-null block is in exactly
        one of ``free``, ``referenced`` (refcount > 0: leased, or held by
        the export ledger until its ack) or ``cached_unreferenced`` (held
        only by the prefix trie)."""
        return {
            "free": sorted(self._free),
            "referenced": [b for b in range(1, self.n_blocks) if self._ref[b] > 0],
            "cached_unreferenced": sorted(
                b for b in self._block_node if self._ref[b] == 0),
        }

    def memory_stats(self) -> Dict:
        # the resident pool is ``bytes``; bridge mode adds a transient
        # n_slots x max_seq_len view per decode step, reported apart so a
        # card is sized for pool + view
        view_bytes = 0 if self.native else sum(
            leaf.element_size() * leaf.shape[0] * self.n_slots * self.max_seq_len
            * int(np.prod(leaf.shape[3:], dtype=np.int64))
            for leaf in _kv_leaves(self.cache).values())
        out = {
            "backend": self.kind,
            "native": self.native,
            "bytes": self.nbytes(),
            "decode_view_bytes": view_bytes,
            "block_size": self.block_size,
            "blocks_total": self.n_blocks - 1,
            "blocks_free": len(self._free),
            "blocks_used": int((self._ref > 0).sum()),
            "table_uploads": self.table_uploads,
            "slots": self.n_slots,
            "blocks_exported": self.blocks_exported,
            "blocks_imported": self.blocks_imported,
            "blocks_export_pending": sum(len(bs) for bs in self._exported.values()),
        }
        if self.prefix_cache:
            out["prefix_cached_blocks"] = self._n_evictable()
            out["prefix_hits"] = self.prefix_hits
            out["prefix_blocks_reused"] = self.prefix_blocks_reused
            out["prefix_tokens_reused"] = self.prefix_tokens_reused
            out["prefix_evictions"] = self.prefix_evictions
            out["cow_forks"] = self.cow_forks
        return out


def make_store(cfg: ArchConfig, n_slots: int, max_seq_len: int,
               backend: str = "auto", *, block_size: int = 16,
               n_blocks: Optional[int] = None, native: bool = False,
               prefix_cache: bool = False, device=None) -> SlotStore:
    """Build the SlotStore backend for a config. ``backend="auto"`` picks
    contiguous for the dense family (recurrent for ssm/hybrid, which are not
    ported). ``native`` and ``prefix_cache`` are paged-only."""
    if backend == "auto":
        backend = "recurrent" if cfg.family in ("ssm", "hybrid") else "contiguous"
    if native and backend != "paged":
        raise ValueError(f"native (block-native decode) requires the paged backend, "
                         f"got {backend!r}")
    if prefix_cache and backend != "paged":
        raise ValueError(f"prefix_cache (shared-prefix radix cache) requires the "
                         f"paged backend, got {backend!r}")
    if backend == "contiguous":
        return ContiguousKVStore(cfg, n_slots, max_seq_len, device=device)
    if backend == "paged":
        return PagedKVStore(cfg, n_slots, max_seq_len, block_size=block_size,
                            n_blocks=n_blocks, native=native,
                            prefix_cache=prefix_cache, device=device)
    if backend == "recurrent":
        raise ValueError("the recurrent state store (ssm/hybrid families) is not "
                         "ported (ROADMAP queue 1 item 11)")
    raise ValueError(f"unknown cache backend {backend!r} "
                     f"(expected auto | contiguous | paged | recurrent)")
