"""The port's data pipeline, checkpoint store and fault-tolerance monitor
against the JAX package's, bitwise:

  * ``SyntheticLM`` and ``TokenFileDataset`` (a temporary uint16 token
    file) batches at several steps and shards, ``state()`` and
    ``restore()``, ``make_dataset``;
  * checkpoints in both directions over a training-state tree (params
    with a ``None`` leaf, an ``AdamWState``, the data state): the port
    loads what the reference wrote and the reference what the port
    wrote, every file of the two step directories byte for byte the same;
    ``latest_step`` skipping a torn save, a crc mismatch raising, and
    ``AsyncCheckpointer``'s ``keep_last``, in both packages;
  * ``HeartbeatMonitor`` (a scripted clock) and ``plan_elastic_mesh`` over
    a grid of inputs, errors included.
"""

import itertools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as JCK
from repro import data as JD
from repro import ft as JFT
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeCfg as JShape
from repro.optim import adamw as JA
from repro_torch import checkpoint as TCK
from repro_torch import data as TD
from repro_torch import ft as TFT
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.optim import adamw as TA


def _same_batch(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed,shard,shards", [(0, 0, 1), (7, 1, 4), (123, 3, 4)])
def test_synthetic_lm_bitwise(seed, shard, shards):
    kw = dict(vocab=32000, seq_len=33, global_batch=8, shard_id=shard, num_shards=shards,
              seed=seed)
    ref, got = JD.SyntheticLM(**kw), TD.SyntheticLM(**kw)
    for _ in range(4):
        _same_batch(next(got), next(ref))
    assert got.state() == ref.state()
    state = ref.state()
    r2, g2 = JD.SyntheticLM(**kw), TD.SyntheticLM(**kw)
    r2.restore(state)
    g2.restore(state)
    _same_batch(next(g2), next(r2))
    with pytest.raises(AssertionError, match="seed mismatch"):
        TD.SyntheticLM(**{**kw, "seed": seed + 1}).restore(state)


@pytest.mark.parametrize("shard,shards", [(0, 1), (1, 2)])
def test_token_file_dataset_bitwise(tmp_path, shard, shards):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(3).integers(0, 60000, 5000).astype(np.uint16).tofile(path)
    kw = dict(path=str(path), vocab=60000, seq_len=64, global_batch=4, shard_id=shard,
              num_shards=shards)
    ref, got = JD.TokenFileDataset(**kw), TD.TokenFileDataset(**kw)
    assert got.n_windows == ref.n_windows
    for _ in range(30):                      # past the end: the windows wrap
        _same_batch(next(got), next(ref))
    assert got.state() == ref.state()
    g2 = TD.TokenFileDataset(**kw)
    g2.restore(ref.state())
    _same_batch(next(g2), next(ref))


def test_make_dataset_matches(tmp_path):
    path = tmp_path / "t.bin"
    np.arange(4000, dtype=np.uint16).tofile(path)
    for p in (None, str(path)):
        ref = JD.make_dataset(jget_config("tinyllama-1.1b").smoke(),
                              JShape("s", 16, 4, "train"), path=p, seed=5)
        got = TD.make_dataset(get_config("tinyllama-1.1b").smoke(),
                              16, 4, path=p, seed=5)
        assert type(got).__name__ == type(ref).__name__
        _same_batch(next(got), next(ref))


# ------------------------------------------------------------ checkpoints

def _state_values(seed=0):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    params = {"embed": a(6, 4), "hybrid": {"tail": None, "lora": {"qA": a(2, 4, 3)}},
              "layers": {"ln1": {"scale": a(2, 4)}, "w": a(2, 4, 4)}}
    mu, nu = T.tree_map(lambda x: x * 0.1, params), T.tree_map(np.abs, params)
    return params, mu, nu, {"step": 9, "seed": 0, "shard_id": 0, "num_shards": 1}


def _jax_state(seed=0):
    params, mu, nu, data = _state_values(seed)
    j = lambda t: T.tree_map(jnp.asarray, t)  # noqa: E731
    return {"params": j(params), "opt": JA.AdamWState(jnp.asarray(4, jnp.int32), j(mu), j(nu)),
            "data": data}


def _port_state(seed=0):
    params, mu, nu, data = _state_values(seed)
    t = lambda x: T.tree_map(torch.from_numpy, x)  # noqa: E731
    return {"params": t(params), "opt": TA.AdamWState(torch.tensor(4, dtype=torch.int32),
                                                      t(mu), t(nu)), "data": data}


def _leaves_np(tree):
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in T.leaves(tree)]


def test_checkpoint_files_identical_in_both_packages(tmp_path):
    JCK.save_checkpoint(tmp_path / "ref", 12, _jax_state())
    TCK.save_checkpoint(tmp_path / "port", 12, _port_state())
    a, b = tmp_path / "ref" / "step_000000012", tmp_path / "port" / "step_000000012"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    assert {"_COMPLETE", "manifest.json"} <= set(names) and len(names) == 2 + 17
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n
    manifest = json.loads((b / "manifest.json").read_text())
    assert "CustomNode(namedtuple[AdamWState]" in manifest["treedef"]


def test_port_loads_reference_checkpoint_and_back(tmp_path):
    JCK.save_checkpoint(tmp_path, 3, _jax_state(1))
    like = _port_state(2)
    got = TCK.load_checkpoint(tmp_path, 3, like)
    assert isinstance(got["opt"], TA.AdamWState) and got["params"]["hybrid"]["tail"] is None
    assert isinstance(got["opt"].mu["embed"], torch.Tensor)
    for x, y in zip(_leaves_np(got), _leaves_np(_port_state(1))):
        assert x.dtype == y.dtype or x.dtype == np.int64
        np.testing.assert_array_equal(x, y)
    # and the reference loads what the port wrote
    TCK.save_checkpoint(tmp_path / "p", 5, got)
    back = JCK.load_checkpoint(tmp_path / "p", 5, _jax_state(2))
    for x, y in zip(T.leaves(back), _leaves_np(_port_state(1))):
        np.testing.assert_array_equal(np.asarray(x), y)


def test_latest_step_skips_a_torn_save(tmp_path):
    TCK.save_checkpoint(tmp_path, 5, _port_state())
    torn = tmp_path / "step_000000007"
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    assert TCK.latest_step(tmp_path) == JCK.latest_step(tmp_path) == 5
    assert TCK.latest_step(tmp_path / "missing") is None
    (tmp_path / "empty").mkdir()
    assert TCK.latest_step(tmp_path / "empty") is None


def test_crc_mismatch_raises_in_both(tmp_path):
    TCK.save_checkpoint(tmp_path, 1, _port_state())
    victim = tmp_path / "step_000000001" / "arr_00005.npy"
    arr = np.load(victim)
    np.save(victim, arr + 1)
    with pytest.raises(IOError, match="crc mismatch"):
        TCK.load_checkpoint(tmp_path, 1, _port_state())
    with pytest.raises(IOError, match="crc mismatch"):
        JCK.load_checkpoint(tmp_path, 1, _jax_state())


def test_async_checkpointer_keep_last(tmp_path):
    kept = {}
    for name, mod, state in (("port", TCK, _port_state()), ("ref", JCK, _jax_state())):
        ck = mod.AsyncCheckpointer(tmp_path / name, keep_last=2)
        for s in (1, 2, 3, 4):
            ck.save(s, state)
        ck.wait()
        kept[name] = sorted(p.name for p in (tmp_path / name).iterdir())
    assert kept["port"] == kept["ref"] == ["step_000000003", "step_000000004"]


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    """``save`` copies the tree to host before it returns: an in-place
    update right after it does not reach the file."""
    state = _port_state()
    ck = TCK.AsyncCheckpointer(tmp_path)
    ck.save(1, state)
    before = state["params"]["embed"].clone()
    state["params"]["embed"].add_(1.0)
    ck.wait()
    got = TCK.load_checkpoint(tmp_path, 1, state)
    assert torch.equal(got["params"]["embed"], before)


# ------------------------------------------------------------ ft

SCRIPTS = [
    [("beat", "a", 1.0), ("tick", 30), ("beat", "b", 1.2), ("tick", 40)],
    [("beat", "a", 1.0), ("beat", "b", 1.0), ("beat", "c", 9.0), ("tick", 5),
     ("beat", "c", 12.0), ("beat", "a", None)],
    [("tick", 61), ("beat", "b", 0.5)],
    [("beat", "a", 2.0), ("beat", "a", 4.0), ("beat", "b", 0.1), ("beat", "c", 0.1),
     ("tick", 59.5)],
]


@pytest.mark.parametrize("script", SCRIPTS)
@pytest.mark.parametrize("factor", [1.5, 3.0])
def test_heartbeat_monitor_matches(script, factor):
    outs = []
    for mod in (JFT.monitor, TFT.monitor):
        now = [100.0]
        mon = mod.HeartbeatMonitor(["a", "b", "c"], timeout_s=60.0, straggler_factor=factor,
                                   clock=lambda: now[0])
        trace = []
        for ev in script:
            if ev[0] == "tick":
                now[0] += ev[1]
            else:
                mon.beat(ev[1], ev[2])
            trace.append((mon.dead_hosts(), mon.stragglers(), mon.healthy_hosts(),
                          {h: (s.last_beat, s.step_ema_s, s.beats)
                           for h, s in mon.hosts.items()}))
        outs.append(trace)
    assert outs[0] == outs[1]


def _plan(mod, *args, **kw):
    try:
        return mod.plan_elastic_mesh(*args, **kw)
    except RuntimeError as e:
        return ("RuntimeError", str(e))


def test_plan_elastic_mesh_matches_over_a_grid():
    n = 0
    for hosts, cph, mp, old_dp, gb in itertools.product(
            (0, 1, 3, 8), (1, 4), (1, 2, 4, 8), (1, 4, 16), (8, 12, 256)):
        ref = _plan(JFT, hosts, cph, mp, old_data_parallel=old_dp, global_batch=gb)
        got = _plan(TFT, hosts, cph, mp, old_data_parallel=old_dp, global_batch=gb)
        assert got == ref, (hosts, cph, mp, old_dp, gb)
        n += isinstance(ref, dict)
    assert n > 50
