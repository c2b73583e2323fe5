"""The port's optimizer against the JAX package's, on identical inputs:
``cosine_schedule`` at steps 0-200 and 9990-10010 (the lr at step 0 is
0), ``clip_by_global_norm`` (bf16 and f32 leaves, clipping and not) and
``adamw_update`` (1-D, 2-D and stacked leaves, fresh and warm moments),
each within rtol 1e-6, and the clip's scale bitwise at f32 given the norm (f32 math in the same order; ``b ** t`` and the
cosine may differ by an ulp); ``compress_grads`` codes, scales and error
feedback over three steps, bitwise. Also the reference's quirk kept:
stacked (L, D) norm scales take weight decay (``ndim >= 2``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro.optim import compress as JC
from repro.optim import schedule as JS
from repro_torch import tree as T
from repro_torch.optim import adamw as TA
from repro_torch.optim import compress as TC
from repro_torch.optim import schedule as TS

STEPS = np.array(list(range(0, 201)) + list(range(9990, 10011)), np.int32)
RTOL = 1e-6


@pytest.mark.parametrize("kw", [{"peak": 3e-4}, {"peak": 1.0},
                                {"peak": 2e-3, "warmup": 10, "total": 150,
                                 "floor_ratio": 0.0}])
def test_cosine_schedule_matches_jax(kw):
    """With floor_ratio 0 the lr falls to 0 at ``total``, where ``1 +
    cos(pi * prog)`` cancels: an ulp of the cosine is an ulp of the peak,
    so there the difference is held to one ulp of the peak instead."""
    ref = np.asarray(JS.cosine_schedule(jnp.asarray(STEPS), **kw))
    got = TS.cosine_schedule(torch.from_numpy(STEPS), **kw)
    assert got.dtype == torch.float32
    atol = kw["peak"] * 2.0 ** -23 if kw.get("floor_ratio", 0.1) == 0 else 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=atol)
    assert float(TS.cosine_schedule(0, **kw)) == 0.0
    for s in (1, 57, 9999):
        np.testing.assert_allclose(float(TS.cosine_schedule(s, **kw)),
                                   float(JS.cosine_schedule(jnp.asarray(s, jnp.int32), **kw)),
                                   rtol=RTOL)


def _tree(rng, scale=1.0, bf16=True):
    """A small params-like tree: stacked (L, D) scales, 2-D and 3-D
    weights, a 1-D vector, in bf16 and f32."""
    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"embed": a(11, 8), "final_ln": {"scale": a(8)},
            "layers": {"ln1": {"scale": a(3, 8)}, "w": a(3, 8, 5)},
            "bias": a(5)}


def _as(tree, lib, dtype):
    if lib == "jax":
        return T.tree_map(lambda x: jnp.asarray(x).astype(dtype), tree)
    return T.tree_map(lambda x: torch.tensor(x).to(getattr(torch, dtype)), tree)


def _np(tree):
    return [np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)
            for x in T.leaves(tree)]


@pytest.mark.parametrize("scale", [10.0, 1e-3])      # clipping, and not
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_clip_by_global_norm_matches_jax(scale, dtype):
    g = _tree(np.random.default_rng(1), scale)
    ref, ref_gn = JA.clip_by_global_norm(_as(g, "jax", dtype), 1.0)
    got, gn = TA.clip_by_global_norm(_as(g, "torch", dtype), 1.0)
    assert all(t.dtype == torch.float32 for t in T.leaves(got))
    np.testing.assert_allclose(float(gn), float(ref_gn), rtol=RTOL)
    assert (float(gn) > 1.0) == (scale == 10.0)
    for a, b in zip(_np(got), _np(ref)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)


@pytest.mark.parametrize("max_norm", [1.0, 0.7, 3.3])
def test_clip_scale_is_the_references_division_bitwise(max_norm):
    """At f32 the clipped leaves are bitwise the reference's ``g * min(1,
    max_norm / max(gn, 1e-9))`` of the same norm: one rounded division.
    (A Python scalar over a tensor is a reciprocal then a product, two
    roundings, which differs at max_norm 0.7 and 3.3 on these trees.)"""
    for seed in range(8):
        g = _tree(np.random.default_rng(seed), 10.0)
        got, gn = TA.clip_by_global_norm(_as(g, "torch", "float32"), max_norm)
        assert float(gn) > max_norm
        scale = jnp.minimum(1.0, max_norm / jnp.maximum(jnp.asarray(gn.numpy()), 1e-9))
        for a, x in zip(_np(got), T.leaves(g)):
            np.testing.assert_array_equal(a, np.asarray(jnp.asarray(x) * scale))


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("warm", [False, True])
def test_adamw_update_matches_jax_in_place(warm, pdtype):
    """bf16 params take the f32 update rounded once to bf16, as the
    reference's ``p_new.astype(p.dtype)``: held to one bf16 ulp (an ulp
    of the f32 result can flip that rounding)."""
    rng = np.random.default_rng(2)
    p, g = _tree(rng), _tree(rng, 0.3)
    m = _tree(rng, 0.1) if warm else T.tree_map(np.zeros_like, p)
    v = (T.tree_map(lambda x: np.abs(x) * 1e-2, _tree(rng)) if warm
         else T.tree_map(np.zeros_like, p))
    step = 41 if warm else 0
    jstate = JA.AdamWState(jnp.asarray(step, jnp.int32), _as(m, "jax", "float32"),
                           _as(v, "jax", "float32"))
    ref_p, ref_s = JA.adamw_update(_as(p, "jax", pdtype), _as(g, "jax", "float32"),
                                   jstate, jnp.asarray(3e-4, jnp.float32))
    tp = _as(p, "torch", pdtype)
    tstate = TA.AdamWState(torch.tensor(step, dtype=torch.int32),
                           _as(m, "torch", "float32"), _as(v, "torch", "float32"))
    before = T.leaves(tp)
    got_p, got_s = TA.adamw_update(tp, _as(g, "torch", "float32"), tstate,
                                   torch.tensor(3e-4))
    assert all(a is b for a, b in zip(T.leaves(got_p), before))       # in place
    assert got_s.step.dtype == torch.int32 and int(got_s.step) == int(ref_s.step)
    assert all(t.dtype == getattr(torch, pdtype) for t in T.leaves(got_p))
    for a, b in zip(_np(got_p), _np(ref_p)):
        np.testing.assert_allclose(a, b, rtol=RTOL if pdtype == "float32" else 2 ** -8,
                                   atol=1e-12)
    for got, ref in ((got_s.mu, ref_s.mu), (got_s.nu, ref_s.nu)):
        for a, b in zip(_np(got), _np(ref)):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-12)


def test_stacked_norm_scales_take_weight_decay_as_in_the_reference():
    """With zero grads and moments only the decay moves a leaf: every
    leaf with ndim >= 2 (the stacked (L, D) ``ln1.scale`` too) shrinks by
    lr * wd, the 1-D ones stay, in both packages."""
    p = _tree(np.random.default_rng(3))
    zeros = T.tree_map(np.zeros_like, p)
    ref_p, _ = JA.adamw_update(_as(p, "jax", "float32"), _as(zeros, "jax", "float32"),
                               JA.adamw_init(_as(p, "jax", "float32")), 0.5)
    tp = _as(p, "torch", "float32")
    got_p, _ = TA.adamw_update(tp, _as(zeros, "torch", "float32"), TA.adamw_init(tp), 0.5)
    names = [("bias", 1), ("embed", 2), ("final_ln.scale", 1), ("layers.ln1.scale", 2),
             ("layers.w", 3)]
    for (name, ndim), a, b, orig in zip(names, _np(got_p), _np(ref_p), T.leaves(p)):
        assert orig.ndim == ndim, name
        np.testing.assert_allclose(a, b, rtol=RTOL)
        np.testing.assert_allclose(a, orig * (1 - 0.5 * 0.1) if ndim >= 2 else orig,
                                   rtol=1e-6)


def test_adamw_init_matches_jax():
    p = _tree(np.random.default_rng(4))
    ref = JA.adamw_init(_as(p, "jax", "float32"))
    got = TA.adamw_init(_as(p, "torch", "float32"))
    assert got.step.dtype == torch.int32 and int(got.step) == int(ref.step) == 0
    assert all(t.dtype == torch.float32 and not t.any() for t in T.leaves(got.mu) +
               T.leaves(got.nu))
    assert [t.shape for t in _np(got.mu)] == [t.shape for t in _np(ref.mu)]


def test_compress_grads_bitwise_over_steps():
    rng = np.random.default_rng(5)
    jef = tef = None
    for _ in range(3):
        g = _tree(rng, 0.7)
        jq, jef = JC.compress_grads(_as(g, "jax", "float32"), jef)
        tq, tef = TC.compress_grads(_as(g, "torch", "float32"), tef)
        for a, b in zip(T.leaves(tq), T.leaves(jq)):
            np.testing.assert_array_equal(a.q.numpy(), np.asarray(b.q))
            np.testing.assert_array_equal(a.scale.numpy(), np.asarray(b.scale))
        for a, b in zip(_np(tef), _np(jef)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(_np(TC.decompress_grads(tq)), _np(JC.decompress_grads(jq))):
            np.testing.assert_array_equal(a, b)
    assert all(float(t.abs().max()) > 0 for t in T.leaves(tef))
