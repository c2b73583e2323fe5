"""The port's training CLI (repro_torch.launch.train) on the CPU:

  * the crash drill: ``--fail-at-step 7`` exits 42 after "SIMULATED
    FAILURE", and the rerun prints "resumed from checkpoint step 6" and
    "done: 8 steps";
  * a run that resumes from a checkpoint the REFERENCE's CLI wrote: its
    losses after the resume within 2e-2 of the reference's own resumed run
    from the same checkpoint (bf16 compute; the batches are bitwise the
    same), and its final checkpoint's optimizer step and data state those
    of the reference's;
  * the reference's quirks, pinned on both: a resume repeats the saved
    step (one update more than an uninterrupted run), and ``--grad-accum
    2`` takes one optimizer step per microbatch;
  * the embeds families refused (exit 2), and the card asked for where
    none is present raising.

The reference's CLI runs in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false`` (its code generated at
LLVM optimization level 0, as tests/test_torch_train.py says), its
smoke mesh built with Auto axes (under this jax its default, Explicit
axes, makes the forward's sharding constraint raise: ROADMAP Queue 3).
"""

import contextlib
import io
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import train as TR

BASE = ["--arch", "tinyllama-1.1b", "--smoke", "--batch", "2", "--seq", "16",
        "--log-every", "1"]
LOSS = re.compile(r"\[train\] step +(\d+) loss ([0-9.]+)")


def run_port(argv):
    """(exit code, stdout, per-step losses and optimizer steps)."""
    rows = []

    def hook(step, params, opt_state, metrics):
        rows.append((step, float(metrics["loss"]), int(opt_state.step)))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = TR.main(list(argv) + ["--device", "cpu"], on_step=hook)
    return rc, buf.getvalue(), rows


def _final(ckpt_dir, step):
    """The optimizer step and data state of a checkpoint, read as files."""
    d = Path(ckpt_dir) / f"step_{step:09d}"
    leaves = json.loads((d / "manifest.json").read_text())["leaves"]
    # leaf order: data (num_shards, seed, shard_id, step), opt (step, ...)
    vals = [np.load(d / m["file"]) for m in leaves[:5]]
    return {"data_step": int(vals[3]), "opt_step": int(vals[4])}


# ----------------------------------------------------------- the reference

def _reference_cli(argv):
    import jax
    from jax.sharding import AxisType
    import repro.launch.train as JT
    JT.make_smoke_mesh = lambda n_model=1: jax.make_mesh(
        (1,), ("data",), axis_types=(AxisType.Auto,))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = JT.main(argv)
    return rc, buf.getvalue()


def run_reference(root):
    """In the subprocess: a crash run (checkpoint at step 3, failure at 5),
    a copy of its checkpoints for the port, the reference's resumed run;
    a --grad-accum 2 run."""
    root = Path(root)
    out = {}
    crash = BASE + ["--steps", "6", "--ckpt-every", "3", "--ckpt-dir", str(root / "ref")]
    out["crash"] = _reference_cli(crash + ["--fail-at-step", "5"])
    shutil.copytree(root / "ref", root / "port")
    out["resumed"] = _reference_cli(crash)
    out["accum"] = _reference_cli(BASE + ["--steps", "3", "--grad-accum", "2",
                                          "--ckpt-dir", str(root / "ref_accum")])
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false --xla_backend_optimization_level=0")
    subprocess.run([sys.executable, __file__, str(root)], env=env, check=True, timeout=900)
    with open(root / "ref.pkl", "rb") as f:
        return root, pickle.load(f)


# ----------------------------------------------------------------- tests

def test_crash_drill(tmp_path):
    argv = BASE + ["--steps", "8", "--ckpt-every", "3", "--ckpt-dir", str(tmp_path)]
    rc, out, _ = run_port(argv + ["--fail-at-step", "7"])
    assert rc == 42 and "SIMULATED FAILURE at step 7" in out
    rc, out, rows = run_port(argv)
    assert rc == 0, out
    assert "resumed from checkpoint step 6" in out and "done: 8 steps" in out
    assert [r[0] for r in rows] == [6, 7]
    rc, out, _ = run_port(argv)
    assert rc == 0 and "nothing to do" in out


def test_resume_from_a_reference_checkpoint(reference):
    root, ref = reference
    assert ref["crash"][0] == 42 and "SIMULATED FAILURE at step 5" in ref["crash"][1]
    rc, text = ref["resumed"]
    assert rc == 0 and "resumed from checkpoint step 3" in text
    ref_losses = {int(s): float(v) for s, v in LOSS.findall(text)}
    rc, out, rows = run_port(BASE + ["--steps", "6", "--ckpt-every", "3",
                                     "--ckpt-dir", str(root / "port")])
    assert rc == 0 and "resumed from checkpoint step 3" in out, out
    assert [r[0] for r in rows] == [3, 4, 5] == sorted(ref_losses)
    for step, loss, _ in rows:
        np.testing.assert_allclose(loss, ref_losses[step], rtol=2e-2)
    assert _final(root / "port", 6) == _final(root / "ref", 6)


def test_a_resume_repeats_the_saved_step(reference):
    """The checkpoint of step 3 is written after step 3's update, with the
    data iterator at 4; the resumed loop starts at 3 again, so the resumed
    run takes 7 updates where an uninterrupted 6-step run takes 6."""
    root, _ = reference
    assert _final(root / "ref", 6) == {"data_step": 7, "opt_step": 7}
    rc, _, rows = run_port(BASE + ["--steps", "6", "--ckpt-dir", str(root / "straight"),
                                   "--ckpt-every", "3"])
    assert rc == 0 and rows[-1][2] == 6
    assert _final(root / "straight", 6) == {"data_step": 6, "opt_step": 6}


def test_grad_accum_takes_one_update_per_microbatch(reference):
    root, ref = reference
    assert ref["accum"][0] == 0
    rc, _, rows = run_port(BASE + ["--steps", "3", "--grad-accum", "2",
                                   "--ckpt-dir", str(root / "port_accum")])
    assert rc == 0 and [r[2] for r in rows] == [2, 4, 6]
    assert (_final(root / "port_accum", 3) == _final(root / "ref_accum", 3)
            == {"data_step": 6, "opt_step": 6})


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-medium"])
def test_embeds_families_are_refused(arch, capsys):
    assert TR.main(["--arch", arch, "--smoke", "--device", "cpu"]) == 2
    assert "reads precomputed embeddings" in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_the_card_is_the_default_device():
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TR.main(BASE + ["--steps", "1"])


if __name__ == "__main__":
    result = run_reference(sys.argv[1])
    with open(Path(sys.argv[1]) / "ref.pkl", "wb") as f:
        pickle.dump(result, f)
