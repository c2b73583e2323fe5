"""The block-native decode step replayed as one CUDA graph.

Issued from Python, a paged decode step of a full-depth model launches
about 1,200 kernels (norms, projections with their activation
quantization, RoPE, the K/V write, the paged-attention kernel, the MLP,
the head and the sampler), and on the card the host's issue of them sets
the step's pace: the device finishes a fraction of a millisecond after the
host stops issuing. The step has one shape for the life of an engine (the
scheduler's decode batch is always ``(n_slots, 1)``, idle slots masked),
its pool and weights never move, the paged-attention kernel reads its
horizons on the device and qgemm plans from shapes alone, so the whole
step is captured once and replayed: the same kernels, in the same order,
at the same shapes and addresses, from one launch.

:class:`GraphedDecodeStep` wraps the eager step. Each call copies the live
inputs (tokens, the cache's index and tables, the active mask, the stacked
sampling tensors) into the graph's static buffers, replays, and returns
fresh copies of what the step made (tokens, the advanced index, the
logprob info): the input index is never written, and the store never
adopts a graph's buffer, so an OPQ backup re-issue of a replayed step
rewrites the same pool cells with the same values, as the eager step's
does. A graph is captured the first time the step runs on the card with a
given signature (shapes, dtypes, whether any row samples), after one eager
warm-up of the body on a side stream, into the graph's own memory pool;
it is captured again only where the pool or the weights it writes and
reads have moved (their storage addresses). Set-up is not work: the
warm-up's and the capture's kernel launches are taken back out of the
wrappers' counters, and each replay adds the launches recorded at capture,
so the counters read as they would under eager issue.

Whether the graph engages follows from what the step can observe
(:func:`engages`): CUDA tensors, and a family whose decode body reads
nothing back to the host. MoE decodes eagerly because its family is not
in GRAPH_FAMILIES, though on the card its body no longer reads the host
(the routed experts' kernel route counts their queues on the device; see
``moe.expert_outputs``). CPU and meta tensors always take the eager step. A
capture that fails raises.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.core.tensorizer import QTensor
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.qgemm import qgemm

# families whose paged decode body makes no host read
GRAPH_FAMILIES = ("dense", "vlm")
# the kernel wrappers the decode body reaches, with their launch counters
COUNTERS = (qgemm, paged_decode_attention)
# the cache leaves a step reads as inputs; every other leaf is the pool,
# which the body writes in place at the addresses it was captured with
INPUT_LEAVES = ("index", "tables")


def engages(cfg: ArchConfig, device) -> bool:
    """Whether a decode step of ``cfg`` on ``device`` replays a graph."""
    return torch.device(device).type == "cuda" and cfg.family in GRAPH_FAMILIES


def _inputs(cache: Dict, tokens: torch.Tensor, sampling: Optional[Dict],
            active: Optional[torch.Tensor]) -> List[torch.Tensor]:
    """The step's per-call input tensors, in one fixed order."""
    out = [tokens] + [cache[n] for n in INPUT_LEAVES]
    if active is not None:
        out.append(active)
    if sampling is not None:
        out += [sampling[k] for k in sorted(sampling) if isinstance(sampling[k], torch.Tensor)]
    return out


def _signature(cache: Dict, tokens: torch.Tensor, sampling: Optional[Dict],
               active: Optional[torch.Tensor]) -> Tuple:
    """What one graph is captured for: every input's shape and dtype, the
    pool's, which optional inputs are given and whether any row samples
    (the sampler's host-side switch)."""
    leaves = [(n, tuple(t.shape), t.dtype) for n, t in sorted(cache.items())]
    ins = [(tuple(t.shape), t.dtype) for t in _inputs(cache, tokens, sampling, active)]
    flags = (active is None, None if sampling is None else bool(sampling["sampled"]))
    return tuple(leaves), tuple(ins), flags


def _addresses(params: Dict, cache: Dict) -> Tuple[int, ...]:
    """The storage addresses a graph is bound to: every weight and every
    pool leaf."""
    ptrs = []
    for leaf in T.leaves(params):
        if isinstance(leaf, QTensor):
            ptrs += [leaf.q.data_ptr(), leaf.scale.data_ptr()]
        elif isinstance(leaf, torch.Tensor):
            ptrs.append(leaf.data_ptr())
    ptrs += [t.data_ptr() for n, t in sorted(cache.items()) if n not in INPUT_LEAVES]
    return tuple(ptrs)


class _Graph:
    """One captured step: its static inputs, its outputs and the launches
    one replay stands for."""

    def __init__(self, graph: torch.cuda.CUDAGraph, static: List[torch.Tensor],
                 cache: Dict, out: Tuple, where: Tuple[int, ...], launches: Tuple[int, ...]):
        self.graph, self.static, self.cache, self.out = graph, static, cache, out
        self.where, self.launches = where, launches

    def replay(self, cache: Dict, tokens, sampling, active) -> Tuple:
        """Load the live inputs, replay, and return the step's result:
        fresh copies of what the step made, the caller's own tensors for
        the leaves it passed through."""
        for dst, src in zip(self.static, _inputs(cache, tokens, sampling, active)):
            dst.copy_(src)
        self.graph.replay()
        for counter, n in zip(COUNTERS, self.launches):
            counter.launches += n
        tok, cache_out, *rest = self.out
        new_cache = {n: cache[n] if t is self.cache.get(n) else t.clone()
                     for n, t in cache_out.items()}
        return (tok.clone(), new_cache, *({k: v.clone() for k, v in lp.items()} for lp in rest))


class GraphedDecodeStep:
    """The paged decode step ``body(params, cache, tokens, sampling=None,
    active=None)``, replayed as a CUDA graph where :func:`engages` allows
    (module doc). ``captures`` and ``replays`` count this step's captures
    and replays; one engine drives one step, one call at a time."""

    def __init__(self, cfg: ArchConfig, body: Callable):
        self.cfg, self.body = cfg, body
        self.captures = 0
        self.replays = 0
        self._graphs: Dict[Tuple, _Graph] = {}

    def __call__(self, params: Dict, cache: Dict, tokens: torch.Tensor,
                 sampling: Optional[Dict] = None, active: Optional[torch.Tensor] = None):
        if not engages(self.cfg, tokens.device):
            return self.body(params, cache, tokens, sampling, active)
        t0 = tracing.now_ns()
        sig = _signature(cache, tokens, sampling, active)
        where = _addresses(params, cache)
        g = self._graphs.get(sig)
        capture = g is None or g.where != where
        if capture:
            self._graphs.pop(sig, None)
            g = self._graphs[sig] = self._capture(params, cache, tokens, sampling, active, where)
        out = g.replay(cache, tokens, sampling, active)
        self.replays += 1
        tracing.record("fwd.graph", t0, tracing.now_ns(), captured_launches=sum(g.launches),
                       capture=int(capture))
        return out

    def _capture(self, params: Dict, cache: Dict, tokens: torch.Tensor,
                 sampling: Optional[Dict], active: Optional[torch.Tensor],
                 where: Tuple[int, ...]) -> _Graph:
        static = [t.clone() for t in _inputs(cache, tokens, sampling, active)]
        it = iter(static)
        s_tokens = next(it)
        s_cache = dict(cache, **{n: next(it) for n in INPUT_LEAVES})
        s_active = None if active is None else next(it)
        s_sampling = None if sampling is None else dict(
            sampling, **{k: next(it) for k in sorted(sampling)
                         if isinstance(sampling[k], torch.Tensor)})
        args = (params, s_cache, s_tokens, s_sampling, s_active)
        before = [c.launches for c in COUNTERS]
        with torch.cuda.device(tokens.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.body(*args)
            torch.cuda.current_stream().wait_stream(side)
            warm = [c.launches for c in COUNTERS]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                out = self.body(*args)
        launches = tuple(c.launches - w for c, w in zip(COUNTERS, warm))
        for c, n in zip(COUNTERS, before):
            c.launches = n
        self.captures += 1
        return _Graph(graph, static, s_cache, out, where, launches)
