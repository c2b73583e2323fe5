"""Paged KV store for block-native decode: the port of
``repro.serving.store``'s ``PagedKVStore`` in native mode.

A fixed pool of ``block_size``-token blocks plus per-slot block tables:
position ``p`` of slot ``s`` lives in pool cell
``(tables[s, p // block_size], p % block_size)``. A request leases exactly
``ceil((prompt + gen) / block_size)`` blocks at admission, so decode never
runs out of blocks mid-flight and a refused lease is clean admission
backpressure. Block 0 is the reserved null block: never leased, it absorbs
idle-slot writes and backs table entries past a lease. Leases edit a host
mirror of the tables, which is uploaded once when the device next needs it.
The pool is handed to the decode step as it is (native mode: no gather
view) and written in place by it, by admission and by retire.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import serve as SV

def pristine_value(name: str) -> float:
    """A cache leaf's empty-state fill value, shared by admission's pad scrub
    and retire's block scrub (int8-KV dequant scales park at 1e-12 so a
    pristine entry dequantizes to exactly 0; the recurrent families' non-zero
    fills come with those families)."""
    return 1e-12 if name.endswith("_scale") else 0.0


_POOL_LEAVES = ("k", "v")


class PagedKVStore:
    """Block-paged K/V for the dense family, native mode. Pool leaves k/v
    (L, NB, bs, KV, hd); tables (B, MB) int32; index (B,) int32."""

    kind = "paged"

    def __init__(self, cfg: ArchConfig, n_slots: int, max_seq_len: int, *,
                 block_size: int = 16, n_blocks=None, device=None):
        if cfg.family != "dense":
            raise ValueError(f"PagedKVStore supports dense-family caches, not {cfg.family}")
        if max_seq_len % block_size:
            raise ValueError(
                f"block_size {block_size} must divide max_seq_len {max_seq_len}")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq_len = max_seq_len
        self.block_size = block_size
        self.blocks_per_slot = max_seq_len // block_size
        full = n_slots * self.blocks_per_slot + 1          # +1: null block
        self.n_blocks = full if n_blocks is None else n_blocks
        if self.n_blocks < 2:
            raise ValueError(f"n_blocks must be >= 2, got {self.n_blocks}")
        self.cache: Dict[str, torch.Tensor] = SV.init_paged_cache(
            cfg, n_slots, self.n_blocks, block_size, self.blocks_per_slot,
            device=device)
        # block 0 reserved as the null block; free blocks hand out low ids first
        self._free: List[int] = list(range(1, self.n_blocks))[::-1]
        self._leased: Dict[int, List[int]] = {}
        self._ref = np.zeros(self.n_blocks, np.int64)
        self._tables = np.zeros((n_slots, self.blocks_per_slot), np.int32)
        self._tables_dirty = False
        self.table_uploads = 0

    # ----------------------------------------------------------- reservation

    def _blocks_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        return math.ceil((prompt_len + max_new_tokens) / self.block_size)

    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Whether a request of this size could EVER be leased (total pool and
        table width): the engine rejects at submit when False."""
        return (self._blocks_needed(prompt_len, max_new_tokens)
                <= min(self.n_blocks - 1, self.blocks_per_slot))

    def available_now(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Whether a ``lease`` would succeed right now, reserving nothing."""
        need = self._blocks_needed(prompt_len, max_new_tokens)
        return need <= len(self._free) and need <= self.blocks_per_slot

    def lease(self, slot: int, prompt_len: int, max_new_tokens: int) -> bool:
        need = self._blocks_needed(prompt_len, max_new_tokens)
        if need > self.blocks_per_slot or need > len(self._free):
            return False
        blocks = [self._free.pop() for _ in range(need)]
        for b in blocks:
            assert self._ref[b] == 0, f"block {b} leased while referenced"
            self._ref[b] = 1
        self._leased[slot] = blocks
        self._tables[slot, :] = 0
        self._tables[slot, :need] = blocks
        self._tables_dirty = True
        return True

    def _sync_tables(self) -> None:
        if self._tables_dirty:
            self.cache = dict(self.cache, tables=torch.as_tensor(
                self._tables, device=self.cache["tables"].device))
            self.table_uploads += 1
            self._tables_dirty = False

    # ------------------------------------------------------------- lifecycle

    def write_slots(self, slots: Sequence[int], kv: Dict[str, torch.Tensor],
                    n_valid: Sequence[int]) -> None:
        """Scatter one admission bucket's K/V (L, B, Sb, KV, hd) through each
        row's block table, in place; pad positions are written pristine and
        pad positions past a row's lease land in the null block."""
        slots_np = np.asarray(slots, np.int64)
        Sb = kv["k"].shape[2]
        pos = np.arange(Sb)
        phys = self._tables[slots_np][:, pos // self.block_size]      # (B, Sb)
        off = np.tile(pos % self.block_size, (len(slots_np), 1))
        dev = self.cache["k"].device
        phys_t = torch.as_tensor(phys, dtype=torch.long, device=dev)
        off_t = torch.as_tensor(off, dtype=torch.long, device=dev)
        n_valid_t = torch.as_tensor(np.asarray(n_valid, np.int32), device=dev)
        valid = torch.arange(Sb, device=dev)[None, :] < n_valid_t[:, None]
        for name in _POOL_LEAVES:
            leaf = self.cache[name]
            src = kv[name].to(leaf.dtype)
            src = torch.where(valid[None, :, :, None, None], src,
                              torch.full_like(src, pristine_value(name)))
            leaf[:, phys_t, off_t] = src
        index = self.cache["index"].clone()
        index[torch.as_tensor(slots_np, device=dev)] = n_valid_t
        self.cache = dict(self.cache, index=index)

    def reset(self, slot: int) -> None:
        """Retire a slot: scrub its blocks to pristine, free them, zero its
        table row and park its index at 0, so the next tenant can never see
        a prior one's entries."""
        assert 0 <= slot < self.n_slots
        blocks = self._leased.pop(slot, [])
        for b in blocks:
            assert self._ref[b] == 1, f"double-free of block {b}"
            self._ref[b] = 0
            self._free.append(b)
        self._tables[slot, :] = 0
        dev = self.cache["k"].device
        if blocks:
            idx = torch.as_tensor(blocks, dtype=torch.long, device=dev)
            for name in _POOL_LEAVES:
                self.cache[name][:, idx] = pristine_value(name)
        tables = self.cache["tables"].clone()
        tables[slot] = 0
        index = self.cache["index"].clone()
        index[slot] = 0
        self.cache = dict(self.cache, tables=tables, index=index)

    # ---------------------------------------------------------- decode bridge

    def decode_cache(self) -> Dict[str, torch.Tensor]:
        """The pool itself (blocks + tables + index): the decode step writes
        and attends through the tables in place."""
        self._sync_tables()
        return self.cache

    def swap(self, new_cache: Dict[str, torch.Tensor]) -> None:
        """Adopt the cache returned by a decode step (same pool tensors, new
        index)."""
        self.cache = new_cache

    # ------------------------------------------------------------------ info

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.cache.values())

    def debug_block_census(self) -> Dict[str, List[int]]:
        """The block-lifecycle partition: every non-null block is in exactly
        one of ``free``, ``referenced`` or ``cached_unreferenced`` (empty
        until the prefix cache is ported)."""
        return {
            "free": sorted(self._free),
            "referenced": [b for b in range(1, self.n_blocks) if self._ref[b] > 0],
            "cached_unreferenced": [],
        }

    def memory_stats(self) -> Dict:
        return {
            "backend": self.kind,
            "native": True,
            "bytes": self.nbytes(),
            "decode_view_bytes": 0,
            "block_size": self.block_size,
            "blocks_total": self.n_blocks - 1,
            "blocks_free": len(self._free),
            "blocks_used": int((self._ref > 0).sum()),
            "table_uploads": self.table_uploads,
            "slots": self.n_slots,
        }
