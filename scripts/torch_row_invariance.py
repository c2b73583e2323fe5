#!/usr/bin/env python3
"""Which f32 attention contractions keep a query row's bits on the card
when the number of query rows in the call, or the key length past masked
keys, changes. The PyTorch port's serving routes rely on it: a prefill
query must give the bits of the decode step at its position (the port runs
each as a one-query decode contraction), and the verify window's W = 2..5
query rows per slot must give the bits of W one-row decode steps.

    python3 scripts/torch_row_invariance.py

Prints one JSON line per case and, last, the card. For each batch B, key
length S and row count W, rows r0..r0+W of the scores, of the softmax and
of the value contraction computed alone are compared bitwise with the same
rows of the call over all S rows: the value contraction plain
(``einsum``), in key tiles of 64, and in QUERY_TILE-row tiles (the last one
zero-padded). ``pad`` cases pad the keys to 2048 with masked ones.
``verify`` cases take the serving shapes (B = 8 slots, S = 160 positions,
D = 2048): a W-row call of the scores, the per-query-horizon softmax and
the value contraction, and the RMSNorm's row mean over D, each against W
one-row calls, bitwise. ``decode_rows`` cases hold the one-query
contraction the port's plain prefill and decode share (models/attention.py
``_attend``: each KV head's H/KV query heads in one product) over 64 rows
against the same rows in calls of 1, 8 and 13 rows, at 160 and 2048 keys,
and the same for the head-expanded form it replaced. (The port runs
every call of the contraction with exactly ``ATTEND_ROWS`` rows, padded,
so it does not need either to hold.) ``norm_rows`` cases hold the
RMSNorm's fused ``F.rms_norm`` (models/layers.py ``apply_norm``) and a
plain ``torch.sum`` of squares over D = 2048 in a call of 1024 rows
against the same rows in calls of 1, 8, 13 and 128. Needs a CUDA card.
"""

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

H, HD, NEG = 32, 64, -1e30
QUERY_TILE = 256


def main() -> int:
    import torch
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
    decode_rows(dev)
    norm_rows(dev)
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


def decode_rows(dev, n=64, KV=4):
    """The one-query contraction of a prefill query against its decode row
    (K/V zero-padded to the row's length, horizon per query) in a call of n
    rows against calls of 1, 8 (decode's batch) and 13 rows (a ragged
    call), bitwise: the port's grouped ``_attend`` and the head-expanded
    form it replaced."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.attention import _attend, _layout
    cfg = get_config("tinyllama-1.1b")
    rep = H // KV

    def expanded(q, k, v, valid):
        k, v = (t.repeat_interleave(rep, dim=2) for t in (k, v))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (HD ** -0.5)
        w = torch.softmax(torch.where(valid, s, torch.full_like(s, NEG)), -1)
        return torch.einsum("bhqk,bkhd->bqhd", w, v)

    for S in (160, 2048):
        q = torch.randn(n, 1, H, HD, device=dev)
        k, v = (torch.randn(n, S, KV, HD, device=dev).to(torch.bfloat16).float()
                for _ in range(2))
        horizon = torch.randint(0, S, (n,), device=dev)
        valid = torch.arange(S, device=dev)[None, None, None, :] <= horizon[:, None, None, None]
        forms = {
            "grouped": lambda a, b: _attend(q[a:b], *_layout(k[a:b], v[a:b]), valid[a:b],
                                            cfg, torch.float32),
            "expanded": lambda a, b: expanded(q[a:b], k[a:b], v[a:b], valid[a:b]),
        }
        for name, f in forms.items():
            full = f(0, n)
            same = {f"rows_{m}": all(torch.equal(f(a, a + m), full[a:a + m])
                                     for a in range(0, n - m + 1, max(m, 8)))
                    for m in (1, 8, 13)}
            print(json.dumps({"decode_rows": name, "S": S, "n": n, **same}), flush=True)


def norm_rows(dev, n=1024, D=2048):
    """RMSNorm rows in calls of 1, 8, 13 and 128 rows against a call of n
    rows, bitwise: the fused ``F.rms_norm`` and a ``torch.sum`` of squares."""
    import torch
    import torch.nn.functional as F
    x = torch.randn(n, D, device=dev)
    w = torch.randn(D, device=dev)
    forms = {"rms_norm": lambda t: F.rms_norm(t, (D,), w, 1e-6),
             "sum_of_squares": lambda t: torch.sum(t * t, dim=-1, keepdim=True)}
    for name, f in forms.items():
        full = f(x)
        same = {f"rows_{m}": all(torch.equal(f(x[a:a + m]), full[a:a + m])
                                 for a in (0, 40, 500, n - m))
                for m in (1, 8, 13, 128)}
        print(json.dumps({"norm_rows": name, "D": D, "n": n, **same}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
