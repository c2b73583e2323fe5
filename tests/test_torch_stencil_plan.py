"""The 3x3 stencil's launch plan and strip walk, on the CPU.

``repro_torch.kernels.stencil3x3.plan`` picks, from the shape, the base
pointer's alignment and the SM count, the columns per lane (4 or 1) and the
strip height of the CUDA kernel, whose warps per block and rows in flight
are constants of its source. It is tested here without a card, as qgemm's
and paged attention's plans are.

The kernel itself runs only on a card. What it computes is emulated here in
torch, in its order: each block's warps walk down their strip with a 3-row
window, each input row completed by its neighbour columns taken from the
adjacent lanes (a shuffle, or shared memory between warps) and, at the
block's two outer lanes, from the columns beside the block; rows above and
below the field, columns outside it and rows past the strip's halo are
zeros. The
emulation lives in this file only; the cuda-marked test in
``test_torch_gptpu_kernels.py`` and ``chip_smoke.py`` hold the kernel
against the plain version on the card.

Tolerances: the emulation against ``ref.stencil3x3_ref`` (the JAX oracle:
the same nine multiply-adds from zero, in order, eager ops) BITWISE; against
the Pallas kernel in interpret mode BITWISE on int8 codes (every product
and partial sum is exact) and within 1e-4 on random fields (XLA's CPU code
fuses some of the nine terms into fused multiply-adds, one rounding fewer,
so the last bits differ: the JAX contract's tolerance, as in
``test_torch_gptpu_kernels.py``).
"""

import inspect
import re

import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import stencil3x3 as ts

SMS = 132                      # the H100's SMs
SOURCE = ts.__file__.replace("stencil3x3.py", "csrc/stencil3x3.cu")


def _define(name):
    """The value of ``#define name`` in the kernel's source."""
    with open(SOURCE) as f:
        return int(re.search(rf"#define {name} (\d+)", f.read()).group(1))


def _blocks(H, W, p, warps=ts.WARPS):
    """(first row, last row + 1, first column) of each block of a grid of
    blocks of ``warps`` warps."""
    span = warps * p.band
    wide = -(-W // span)
    for blk in range(wide * -(-H // p.rows)):
        r0 = blk // wide * p.rows
        if r0 < H:
            yield r0, min(H, r0 + p.rows), blk % wide * span


def _cover(H, W, p):
    """How many times the plan's lanes write each cell."""
    count = np.zeros((H, W), np.int64)
    for r0, r1, b0 in _blocks(H, W, p):
        for lane in range(32 * ts.WARPS):
            c0 = b0 + lane * p.width
            count[r0:r1, c0:min(W, c0 + p.width)] += 1
    return count


# ------------------------------------------------------------------ plan

@pytest.mark.parametrize("H,W", [(1, 1), (1, 256), (77, 1), (37, 129), (64, 130),
                                 (50, 131), (257, 129), (1023, 1024), (1024, 1024),
                                 (1025, 1024), (300, 4097)])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_covers_every_cell_once(H, W, aligned):
    p = ts.plan(H, W, aligned, SMS)
    assert (_cover(H, W, p) == 1).all()
    assert p.band == 32 * p.width and p.rows >= 1


@pytest.mark.parametrize("W", [1, 2, 3, 4, 5, 8, 129, 130, 131, 132, 1024, 4095])
def test_plan_width_four_only_on_aligned_rows(W):
    assert ts.plan(64, W, True, SMS).width == (4 if W % 4 == 0 else 1)
    assert ts.plan(64, W, False, SMS).width == 1


@pytest.mark.parametrize("n", [1024, 4096])
def test_plan_fills_the_card(n):
    """At least two blocks per SM, and several rows in flight per lane: the
    first two rows of the window and the kernel's ``DEPTH`` more are loaded
    at once. The plan's warps per block are the kernel's."""
    p = ts.plan(n, n, True, SMS)
    assert p.blocks(n, n) >= 2 * SMS
    assert p.width == 4 and _define("STENCIL_DEPTH") + 2 >= 4 and p.rows >= 2
    assert ts.WARPS == _define("STENCIL_WARPS")


def test_plan_reads_shapes_only():
    assert list(inspect.signature(ts.plan.__wrapped__).parameters) == [
        "H", "W", "aligned", "sms"]
    assert ts.plan(1024, 1024, True, SMS) == ts.plan(1024, 1024, True, SMS)
    assert ts.plan(4096, 4096, True, SMS).rows >= ts.plan(1024, 1024, True, SMS).rows


# ------------------------------------------------------- the strip walk

def emulate(x: torch.Tensor, w: torch.Tensor, p: ts.Plan, warps: int) -> torch.Tensor:
    """The CUDA kernel's arithmetic in blocks of ``warps`` warps, block by
    block, the block's lanes as a vector (its warps' lanes side by side)."""
    H, W = x.shape
    V = p.width
    out = torch.full((H, W), float("nan"))
    lanes = torch.arange(32 * warps)
    last = lanes[-1]
    for r0, r1, b0 in _blocks(H, W, p, warps):
        cols = (b0 + lanes * V)[:, None] + torch.arange(V)          # (lanes, V)
        live = cols[:, 0] < W

        def load(r):
            raw, left, right = torch.zeros(len(lanes), V), 0.0, 0.0
            if r0 - 1 <= r <= r1 and 0 <= r < H:
                raw[live] = x[r, cols[live]]
                if b0 - 1 >= 0:                                   # the block's outer lanes
                    left = x[r, b0 - 1]
                if b0 + len(lanes) * V < W:
                    right = x[r, b0 + len(lanes) * V]
            # shuffles within a warp, shared memory across warps: the same values
            lcol = torch.roll(raw[:, V - 1], 1)
            rcol = torch.roll(raw[:, 0], -1)
            lcol[0], rcol[last] = left, right
            return torch.cat([lcol[:, None], raw, rcol[:, None]], 1)   # (lanes, V + 2)

        a, b = load(r0 - 1), load(r0)
        for r in range(r0, r1):
            c = load(r + 1)
            acc = torch.zeros(len(lanes), V)
            for pi, row in enumerate((a, b, c)):
                for q in range(3):
                    acc = acc + w[pi, q] * row[:, q:q + V]
            out[r, cols[live]] = acc[live]
            a, b = b, c
    return out


RAGGED = [(1, 1), (2, 5), (7, 3), (33, 31), (64, 130), (50, 131), (9, 257), (100, 301)]


def _plans(H, W):
    """(plan, warps per block): the plan's own choice for each alignment in
    the kernel's blocks, and strips of 1 and 3 rows in blocks of 3 and 1
    warps (the kernel built with other warps per block, as a sweep builds
    it)."""
    yield ts.plan(H, W, True, SMS), ts.WARPS
    yield ts.plan(H, W, False, SMS), ts.WARPS
    p = ts.plan(H, W, True, SMS)
    for rows, warps in ((1, 3), (3, 1)):
        yield p._replace(rows=rows), warps


@pytest.mark.parametrize("H,W", RAGGED)
def test_strip_walk_matches_jax(H, W):
    rng = np.random.default_rng(H * 1000 + W)
    x = rng.normal(size=(H, W)).astype(np.float32)
    w = rng.normal(size=(3, 3)).astype(np.float32)
    expect = np.asarray(ref.stencil3x3_ref(x, w))
    pallas = np.asarray(ops.stencil(x, w, bm=8, interpret=True))
    for p, warps in _plans(H, W):
        out = emulate(torch.from_numpy(x), torch.from_numpy(w), p, warps).numpy()
        np.testing.assert_array_equal(out, expect)
        np.testing.assert_allclose(out, pallas, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("H,W", RAGGED)
def test_strip_walk_on_codes_matches_pallas_bitwise(H, W):
    rng = np.random.default_rng(H + W)
    x = rng.integers(-127, 128, (H, W)).astype(np.float32)
    w = rng.integers(-127, 128, (3, 3)).astype(np.float32)
    pallas = np.asarray(ops.stencil(x, w, bm=8, interpret=True))
    for p, warps in _plans(H, W):
        out = emulate(torch.from_numpy(x), torch.from_numpy(w), p, warps).numpy()
        np.testing.assert_array_equal(out, pallas)
