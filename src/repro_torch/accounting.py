"""Cost accounting of a step as it runs: the counterpart of XLA's
``cost_analysis()`` and ``memory_analysis()`` for the port's eager steps.

``with Accounting() as acc: step(...)`` counts what the step *does*, on
the meta, CPU or CUDA device alike:

  * ``flops`` — contraction FLOPs: ``torch.utils.flop_counter``'s formulas
    (mm, bmm, addmm, baddbmm, convolution, SDPA) over the aten ops the step
    dispatches, plus one record per hand-kernel call (:func:`kernel`) from
    the kernel's shapes. The kernels launch through ctypes, where no
    dispatch sees them; the aten ops a wrapper runs inside itself (its plain
    version on the CPU, its output allocation) are not counted. So the same
    step counts the same integer on every device. Elementwise and
    transcendental work is not counted, unlike XLA's ``flops``.
  * ``bytes_accessed`` — the eager program's traffic, reckoned and not
    measured: for every aten op that is not a view, the bytes of its tensor
    inputs and outputs (each distinct storage once), plus each kernel's
    operand and result bytes. XLA's count is of a fused program and is
    smaller.
  * ``peak_bytes`` — the most bytes of storages created under the context
    alive at once. Each storage made by an op is counted when it first
    appears and released by a weakref finalizer when it dies, so views
    share their base's bytes, and autograd's saved tensors and in-place
    updates count for as long as they live. Storages that existed before
    the context (the step's arguments) are not counted.

Collectives are not counted: one device runs no collective, so a record
says so instead of reporting zero bytes.
"""

from __future__ import annotations

import collections
import contextlib
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVES_NOTE = "none: one device"
BYTES_NOTE = ("reckoned: bytes of every non-view aten op's inputs and outputs plus "
              "each hand kernel's operands and result, as eager issues them; not "
              "XLA's fused count, not measured")

# ops that move no data: allocation without initialization, aliasing
_NO_TRAFFIC = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided", "_unsafe_view", "lift_fresh", "set_",
                         "resize_"))

_STACK: List["Accounting"] = []


def current() -> Optional["Accounting"]:
    """The innermost active accounting context, or None."""
    return _STACK[-1] if _STACK else None


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@contextlib.contextmanager
def kernel(name: str, flops: int, nbytes: int):
    """Wrap a hand-kernel call: with an accounting context active, record
    one call of ``name`` doing ``flops`` contraction FLOPs over ``nbytes``
    of operands and result, and count none of the aten ops issued inside
    (storages made inside still count toward the peak)."""
    acc = current()
    if acc is None:
        yield
        return
    acc.record_kernel(name, flops, nbytes)
    acc._suspended += 1
    try:
        yield
    finally:
        acc._suspended -= 1


class Accounting(TorchDispatchMode):
    """See the module docstring. Counters: ``flops``, ``flops_by_op``,
    ``flops_by_dtype`` (the aten contractions' by their first operand's
    dtype), ``bytes_accessed``, ``kernels`` (name -> calls, flops, bytes),
    ``peak_bytes`` and ``live_bytes``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_by_op: Dict[str, int] = collections.Counter()
        self.flops_by_dtype: Dict[str, int] = collections.Counter()   # aten ops only
        self.bytes_accessed = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._known: Dict[int, int] = {}      # id(storage) -> counted bytes (0: before)
        self._suspended = 0

    def __enter__(self):
        _STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _STACK.remove(self)
        return super().__exit__(*exc)

    def record_kernel(self, name: str, flops: int, nbytes: int) -> None:
        rec = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        rec["calls"] += 1
        rec["flops"] += int(flops)
        rec["bytes"] += int(nbytes)
        self.flops += int(flops)
        self.flops_by_op[name] += int(flops)
        self.bytes_accessed += int(nbytes)

    def kernel_calls(self, name: str) -> int:
        return self.kernels.get(name, {}).get("calls", 0)

    # ---- storage tracking --------------------------------------------
    def _release(self, key: int) -> None:
        self.live_bytes -= self._known.pop(key, 0)

    def _note(self, st, created: bool) -> None:
        key = id(st)
        if key in self._known:
            return
        n = st.nbytes() if created else 0
        self._known[key] = n
        weakref.finalize(st, self._release, key)
        if n:
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        in_st = [t.untyped_storage() for t in ins]
        for st in in_st:
            self._note(st, created=False)
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        out_st = [t.untyped_storage() for t in outs]
        for st in out_st:
            self._note(st, created=True)
        if not self._suspended:
            packet = func._overloadpacket
            if packet in flop_registry:
                f = int(flop_registry[packet](*args, **kwargs, out_val=out))
                self.flops += f
                self.flops_by_op[packet.__name__] += f
                self.flops_by_dtype[str(ins[0].dtype).replace("torch.", "")] += f
            if not func.is_view and packet.__name__ not in _NO_TRAFFIC:
                seen = {(id(st), t.storage_offset(), t.shape): tensor_bytes(t)
                        for t, st in zip(ins + outs, in_st + out_st)}
                self.bytes_accessed += sum(seen.values())
        return out
