#!/usr/bin/env python3
"""Which f32 attention contractions keep a query row's bits on the card
when the number of query rows in the call, or the key length past masked
keys, changes. The prefill routes of the PyTorch port rely on it: a chunk of
W query rows (chunked or suffix prefill) must give the rows a single-shot
prefill gives. So does speculative decode: the verify window's W = 2..5
query rows per slot must give the bits of W one-row decode steps.

    python3 scripts/torch_row_invariance.py

Prints one JSON line per case and, last, the card. For each batch B, key
length S and row count W, rows r0..r0+W of the scores, of the softmax and
of the value contraction computed alone are compared bitwise with the same
rows of the call over all S rows: the value contraction plain
(``einsum``), in key tiles of 64, and in QUERY_TILE-row tiles (the last one
zero-padded: models/attention.py ``_attend(query_tiles=True)``). ``pad``
cases pad the keys to 2048 with masked ones. ``verify`` cases take the
serving shapes (B = 8 slots, S = 160 positions, D = 2048): a W-row call of
the scores, the per-query-horizon softmax and the value contraction, and
the RMSNorm's row mean over D, each against W one-row calls, bitwise.
Needs a CUDA card.
"""

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

H, HD, NEG = 32, 64, -1e30


def main() -> int:
    import torch
    from repro_torch.models.attention import QUERY_TILE
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.manual_seed(0)
    dev = "cuda"

    def scores(q, k):
        return torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.125

    def weights(q, k, r0):
        s = scores(q, k)
        qpos = r0 + torch.arange(q.shape[1], device=dev)[:, None]
        keep = torch.arange(k.shape[1], device=dev)[None, :] <= qpos
        return torch.softmax(torch.where(keep, s, torch.full_like(s, NEG)), -1)

    def plain(w, v):
        return torch.einsum("bhqk,bkhd->bqhd", w, v)

    def key_tiles(w, v, kt=64):
        parts = [plain(w[..., j:j + kt], v[:, j:j + kt]) for j in range(0, w.shape[-1], kt)]
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def query_tiles(w, v):
        sq = w.shape[2]
        pad = -sq % QUERY_TILE
        w = torch.cat([w, w.new_zeros(w.shape[:2] + (pad, w.shape[3]))], 2)
        return torch.cat([plain(w[:, :, i:i + QUERY_TILE], v)
                          for i in range(0, sq + pad, QUERY_TILE)], 1)[:, :sq]

    forms = {"plain": plain, "key_tiles_64": key_tiles, "query_tiles": query_tiles}
    for B in (1, 2):
        for S in (128, 1536, 2048):
            q, k, v = (torch.randn(B, S, H, HD, device=dev) for _ in range(3))
            wf = weights(q, k, 0)
            full = {n: f(wf, v) for n, f in forms.items()}
            sf = scores(q, k)
            for W in (16, 256):
                for r0 in sorted({0, (S // 2 // W) * W, S - W}):
                    if W >= S:
                        continue
                    ws = weights(q[:, r0:r0 + W], k, r0)
                    row = {"B": B, "S": S, "W": W, "r0": r0,
                           "scores": torch.equal(scores(q[:, r0:r0 + W], k), sf[:, :, r0:r0 + W]),
                           "softmax": torch.equal(ws, wf[:, :, r0:r0 + W])}
                    row.update({n: torch.equal(f(ws, v), full[n][:, r0:r0 + W])
                                for n, f in forms.items()})
                    print(json.dumps(row), flush=True)
            if S < 2048:
                extra = [torch.randn(B, 2048 - S, H, HD, device=dev) for _ in range(3)]
                qp, kp, vp = (torch.cat([a, e], 1) for a, e in zip((q, k, v), extra))
                wp = weights(qp, kp, 0)
                row = {"B": B, "S": S, "pad": 2048,
                       "scores": torch.equal(scores(qp, kp)[:, :, :S, :S], sf),
                       "softmax": torch.equal(wp[:, :, :S, :S], wf)}
                row.update({n: torch.equal(f(wp, vp)[:, :S], full[n]) for n, f in forms.items()})
                print(json.dumps(row), flush=True)
    verify_rows(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(json.dumps({"card": smi.stdout.strip(), "torch": torch.__version__,
                      "allow_tf32": torch.backends.cuda.matmul.allow_tf32}), flush=True)
    return 0


def verify_rows(dev, B=8, S=160, D=2048):
    """The verify window's contractions and row norms at W rows against W
    one-row calls (each query j with horizon index + j), bitwise."""
    import torch
    k, v = (torch.randn(B, S, H, HD, device=dev) for _ in range(2))
    index = torch.randint(0, S - 5, (B,), device=dev)
    kpos = torch.arange(S, device=dev)[None, None, None, :]
    for W in (2, 3, 4, 5):
        q = torch.randn(B, W, H, HD, device=dev)
        x = torch.randn(B, W, D, device=dev)
        pos = index[:, None] + torch.arange(W, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.125
        w = torch.softmax(torch.where(kpos <= pos[:, None, :, None], s,
                                      torch.full_like(s, NEG)), -1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v)
        ms = torch.mean(x * x, dim=-1, keepdim=True)
        same = {"scores": True, "softmax": True, "value": True, "value_given_softmax": True,
                "rms_mean": True}
        for j in range(W):
            qj = q[:, j:j + 1].contiguous()
            sj = torch.einsum("bqhd,bkhd->bhqk", qj, k) * 0.125
            wj = torch.softmax(torch.where(kpos <= pos[:, j, None, None, None], sj,
                                           torch.full_like(sj, NEG)), -1)
            same["scores"] &= torch.equal(sj, s[:, :, j:j + 1])
            same["softmax"] &= torch.equal(wj, w[:, :, j:j + 1])
            same["value"] &= torch.equal(torch.einsum("bhqk,bkhd->bqhd", wj, v), o[:, j:j + 1])
            same["value_given_softmax"] &= torch.equal(
                torch.einsum("bhqk,bkhd->bqhd", w[:, :, j:j + 1].contiguous(), v), o[:, j:j + 1])
            xj = x[:, j:j + 1].contiguous()
            same["rms_mean"] &= torch.equal(torch.mean(xj * xj, dim=-1, keepdim=True),
                                            ms[:, j:j + 1])
        print(json.dumps({"verify": True, "B": B, "S": S, "W": W, "D": D, **same}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
