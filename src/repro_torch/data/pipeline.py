"""Token data pipeline: the port of ``repro.data.pipeline``, numpy as in
the reference, so a batch is bitwise the reference's.

  * each data-parallel host reads only its shard (``shard_id/num_shards``);
  * the iterator is a pure function of (seed, step), so a restart from
    step N sees exactly the batches a failed run would have seen
    (``state()``/``restore()`` are the step counter);
  * batches are numpy arrays on the host; the trainer moves each to its
    device.

Two sources:
  * SyntheticLM      — seeded token streams (tests, examples, the chip smoke)
  * TokenFileDataset — memory-mapped uint16/uint32 token files (real corpora)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    """Deterministic synthetic LM batches: batch of (tokens, labels)."""

    vocab: int
    seq_len: int
    global_batch: int
    shard_id: int = 0
    num_shards: int = 1
    seed: int = 0
    step: int = 0

    def __post_init__(self):
        assert self.global_batch % self.num_shards == 0
        self.local_batch = self.global_batch // self.num_shards

    def _batch_at(self, step: int) -> Dict[str, np.ndarray]:
        # an independent stream per (seed, step, shard)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard_id]))
        tokens = rng.integers(
            0, self.vocab, (self.local_batch, self.seq_len), dtype=np.int32)
        # labels are the same stream (the loss shifts them by one)
        return {"tokens": tokens, "labels": tokens}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self._batch_at(self.step)
        self.step += 1
        return b

    # ---- checkpoint interface ----
    def state(self) -> Dict:
        return {"step": self.step, "seed": self.seed,
                "shard_id": self.shard_id, "num_shards": self.num_shards}

    def restore(self, state: Dict) -> None:
        assert state["seed"] == self.seed, "seed mismatch on restore"
        self.step = int(state["step"])


@dataclasses.dataclass
class TokenFileDataset:
    """Memory-mapped token file, sliced into (batch, seq) windows.

    File layout: flat little-endian token ids (uint16 when vocab < 65536).
    The windows of shard s at step t are a pure function of (s, t), so a
    restart reads what the failed run would have read.
    """

    path: str
    vocab: int
    seq_len: int
    global_batch: int
    shard_id: int = 0
    num_shards: int = 1
    step: int = 0
    dtype: str = "uint16"

    def __post_init__(self):
        assert self.global_batch % self.num_shards == 0
        self.local_batch = self.global_batch // self.num_shards
        self._mm = np.memmap(self.path, dtype=self.dtype, mode="r")
        self.n_windows = len(self._mm) // self.seq_len

    def _batch_at(self, step: int) -> Dict[str, np.ndarray]:
        idx = (step * self.global_batch
               + self.shard_id * self.local_batch
               + np.arange(self.local_batch)) % max(1, self.n_windows - 1)
        tokens = np.stack([
            self._mm[i * self.seq_len:(i + 1) * self.seq_len] for i in idx
        ]).astype(np.int32)
        return {"tokens": tokens, "labels": tokens}

    def __iter__(self):
        return self

    def __next__(self):
        b = self._batch_at(self.step)
        self.step += 1
        return b

    def state(self) -> Dict:
        return {"step": self.step, "path": str(self.path)}

    def restore(self, state: Dict) -> None:
        self.step = int(state["step"])


def make_dataset(cfg, seq_len: int, global_batch: int, *,
                 path: Optional[str] = None, shard_id: int = 0,
                 num_shards: int = 1, seed: int = 0):
    """The token file at ``path``, or the synthetic stream, in batches of
    ``global_batch`` rows of ``seq_len`` tokens (the reference's
    ``make_dataset`` reads these two from its ``ShapeCfg``)."""
    if path:
        return TokenFileDataset(path=path, vocab=cfg.vocab, seq_len=seq_len,
                                global_batch=global_batch,
                                shard_id=shard_id, num_shards=num_shards)
    return SyntheticLM(vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
                       shard_id=shard_id, num_shards=num_shards, seed=seed)
