"""Training CLI for the port: end to end, resumable, with a crash drill.

    python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 200 --batch 8 --seq 128 --ckpt-dir build/ckpt

The reference's ``repro.launch.train`` flag for flag, plus ``--device``
(``cuda`` by default; a CUDA device where none is present raises, and
``--device cpu`` runs on the CPU, with ``--smoke`` there). Its log lines are
the reference's:

  * the train step (models/steps.py ``make_train_step``) updates the params
    and the AdamW moments in place, the counterpart of the reference's
    donated buffers: no second copy of the 12 bytes a parameter;
  * every ``--ckpt-every`` steps the params, the optimizer state and the
    data iterator's state are checkpointed asynchronously (atomic commit,
    crc-checked restore, the reference's on-disk format), and a run
    resumes from the newest complete checkpoint in ``--ckpt-dir``;
  * ``--fail-at-step N`` simulates a crash at step N: it waits for the
    write in flight and exits 42;
  * ``--grad-accum K`` draws K batches per step.

The weights are random, drawn from a ``torch.Generator`` seeded with 0 on
the device (the reference draws from ``PRNGKey(0)``; torch cannot replay
JAX's PRNG). The batches are the reference's, bitwise (data/pipeline.py).

Kept as the reference has them: a resumed run repeats the saved step (the
checkpoint of step s is written after step s's update, with the data
iterator at s + 1, and the loop resumes at s); ``--grad-accum`` takes one
optimizer step per microbatch; ``--quantize`` only sets the config field
(the init never quantizes, so training runs on float weights);
``--model-parallel`` changes nothing on one card, as the reference's smoke
mesh falls back to the data axis on one device. The embeds families
(qwen2-vl-2b, seamless-m4t-medium) are refused: the dataset yields tokens
only, and the reference fails on them too.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, load_checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.data import make_dataset
from repro_torch.models import init_model
from repro_torch.models import steps as ST
from repro_torch.optim import adamw_init

SEED = 0   # the weights' generator seed


def init_params(cfg: ArchConfig, device) -> dict:
    """The CLI's initial weights: f32, from a generator seeded with SEED on
    ``device``, so a run's step 0 starts from exactly these bits."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    return init_model(cfg, gen, device=device)


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--quantize", default="off")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="simulate a crash at this step (fault-tolerance drill)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="the model axis of a pod mesh; one card has none")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, on_step: Optional[Callable] = None) -> int:
    """Run the CLI on ``argv``; returns the exit code. ``on_step(step,
    params, opt_state, metrics)``, when given, is called after each step's
    updates (for callers that inspect the state, as the chip smoke does)."""
    args = _args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.quantize != "off":
        cfg = cfg.replace(quantize=args.quantize)
    if cfg.input_mode != "tokens":
        print(f"[train] {cfg.name} reads precomputed embeddings (family {cfg.family}); "
              f"the token dataset has none, so it cannot train from this CLI (nor "
              f"from the reference's); train it through "
              f"models.steps.make_train_step", file=sys.stderr, flush=True)
        return 2

    params = init_params(cfg, device)
    opt_state = adamw_init(params)
    ds = make_dataset(cfg, args.seq, args.batch)
    start = 0

    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt is not None:
        s = latest_step(args.ckpt_dir)
        if s is not None:
            state = load_checkpoint(args.ckpt_dir, s,
                                    {"params": params, "opt": opt_state,
                                     "data": ds.state()})
            params, opt_state = state["params"], state["opt"]
            ds.restore(state["data"])
            start = s
            print(f"[train] resumed from checkpoint step {s}", flush=True)
            if start >= args.steps:
                print(f"[train] checkpoint already at/past --steps "
                      f"{args.steps}; nothing to do", flush=True)
                return 0

    train_step = ST.make_train_step(cfg)

    t0 = time.time()
    tokens_done = 0
    for step in range(start, args.steps):
        if step == args.fail_at_step:
            print(f"[train] SIMULATED FAILURE at step {step}", flush=True)
            if ckpt:
                ckpt.wait()
            return 42  # crash exit code: a restart resumes from the checkpoint

        loss_acc = 0.0
        for _ in range(args.grad_accum):
            batch = {k: torch.from_numpy(v).to(device) for k, v in next(ds).items()}
            params, opt_state, metrics = train_step(
                params, opt_state, batch, torch.tensor(step, dtype=torch.int32,
                                                       device=device))
            loss_acc += float(metrics["loss"])
        tokens_done += args.batch * args.seq * args.grad_accum
        if on_step is not None:
            on_step(step, params, opt_state, metrics)

        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"[train] step {step:5d} loss {loss_acc / args.grad_accum:.4f} "
                  f"gnorm {float(metrics['gnorm']):.3f} lr {float(metrics['lr']):.2e} "
                  f"tok/s {tokens_done / max(dt, 1e-9):.0f}", flush=True)

        if ckpt is not None and step > start and step % args.ckpt_every == 0:
            ckpt.save(step, {"params": params, "opt": opt_state, "data": ds.state()})

    if ckpt is not None:
        ckpt.save(args.steps, {"params": params, "opt": opt_state, "data": ds.state()})
        ckpt.wait()
    print(f"[train] done: {args.steps} steps, final loss "
          f"{loss_acc / args.grad_accum:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
