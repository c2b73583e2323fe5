"""Deprecated shim: ``KVSlotManager`` is the contiguous SlotStore.

The slot-granular cache layer lives in ``repro_torch/serving/store.py``
(``make_store(cfg, n_slots, max_seq_len, backend=...)``). ``KVSlotManager``
is ``ContiguousKVStore`` under its old name, kept for old imports; it warns
once per instantiation.
"""

from __future__ import annotations

import warnings

from repro_torch.serving.store import ContiguousKVStore
from repro_torch.serving.store import pristine_value  # noqa: F401  (old import site)


class KVSlotManager(ContiguousKVStore):
    """Deprecated alias of :class:`repro_torch.serving.store.ContiguousKVStore`."""

    def __init__(self, cfg, n_slots: int, max_seq_len: int, device=None):
        warnings.warn(
            "KVSlotManager is deprecated: use repro_torch.serving.store.make_store("
            "cfg, n_slots, max_seq_len, backend='contiguous') or "
            "ContiguousKVStore directly",
            DeprecationWarning, stacklevel=2)
        super().__init__(cfg, n_slots, max_seq_len, device=device)
