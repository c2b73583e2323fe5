"""The port's mesh description, sharding rules and dry-run specs against
the JAX package's, and the CLIs' ``--model-parallel``.

* Axis helpers and ``batch_spec`` equal the reference's on the smoke mesh
  ("data",) (1), the pod mesh (16, 16) and the multi-pod mesh (2, 16, 16);
  the reference side runs on a ``jax.sharding.AbstractMesh`` (no devices).
* ``make_production_mesh`` lays out the reference's meshes;
  ``make_smoke_mesh(2)`` on one device falls back to the 1-wide ("data",)
  mesh, as the reference's does on one CPU device.
* For every arch at full width, with ``quantize`` off and serve, every
  leaf of ``param_sds``, ``opt_sds``, ``batch_specs`` and ``cache_specs``
  (each shape) has the reference's shape and dtype, and its per-device
  shard shape under both pod meshes is the reference's
  ``sharding.shard_shape``.
* ``--model-parallel 2`` is accepted by the serve CLI (in-process and with
  a worker process, whose spec carries it) and the train CLI, and changes
  no token or loss: one card's mesh is the 1-wide data mesh either way.
"""

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, SHAPES as JSHAPES, get_config as jget
from repro.distributed import sharding as jshd
from repro.launch import mesh as jmesh
from repro.models import steps as JST
from repro_torch.configs import SHAPES, get_config as tget
from repro_torch.core import tensorizer as tz
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as TSERVE
from repro_torch.launch import train as TTRAIN
from repro_torch.models import steps as TST
from repro_torch.serving.transport import build_model_spec

import _torch_parity as P

MESHES = [((1,), ("data",)), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


@pytest.fixture
def restore_reference_mesh():
    prev = jshd.current_mesh()
    yield
    jshd.set_mesh(prev)


@pytest.mark.parametrize("sizes,names", MESHES, ids=lambda v: str(v))
def test_axis_helpers_match_the_reference(restore_reference_mesh, sizes, names):
    jshd.set_mesh(AbstractMesh(sizes, names))
    with tshd.use_mesh(tshd.Mesh(sizes, names)):
        for fn in ("axis_names", "batch_axes", "model_axis", "seq_axis",
                   "data_parallel_size", "model_parallel_size"):
            assert getattr(tshd, fn)() == getattr(jshd, fn)(), fn
        for trailing in ((), (None,), ("model", None), (None, "model", None)):
            assert tshd.batch_spec(*trailing) == tuple(jshd.batch_spec(*trailing))
        one = lambda e: e[0] if isinstance(e, tuple) and len(e) == 1 else e  # noqa: E731
        for spec in ((("pod", "data"), "model", None), ("model", ("pod",), "data")):
            # PartitionSpec writes a one-axis tuple as the axis
            assert (tuple(map(one, tshd.scrub(spec)))
                    == tuple(JST._scrub(jax.sharding.PartitionSpec(*spec))))


def test_mesh_context_and_placement():
    with tshd.use_mesh(tshd.Mesh((16, 16), ("data", "model"))) as m:
        assert tshd.current_mesh() is m and m.size == 256 and m.shape == {"data": 16,
                                                                           "model": 16}
        x = torch.arange(6.0).reshape(2, 3)
        assert tshd.with_sharding(x, ("data", "model")) is x
        with pytest.raises(ValueError, match="layout description"):
            tshd.shard(x, ("data", None))
        with tshd.use_mesh(tmesh.make_smoke_mesh(1, "cpu")):
            y = tshd.shard(x, ("data", None))
            assert torch.equal(y, x) and y.device.type == "cpu"
        assert tshd.current_mesh() is m
    with pytest.raises(RuntimeError, match="no mesh set"):
        tshd.current_mesh()


def test_meshes_are_the_references(monkeypatch, restore_reference_mesh):
    monkeypatch.setattr(jmesh.jax, "make_mesh", lambda shape, axes: (tuple(shape), tuple(axes)))
    for mp in (False, True):
        m = tmesh.make_production_mesh(multi_pod=mp)
        assert (m.axis_sizes, m.axis_names) == jmesh.make_production_mesh(multi_pod=mp)
        assert m.device is None
    monkeypatch.undo()
    for n_model in (1, 2):
        ref = jmesh.make_smoke_mesh(n_model)           # one CPU device: ("data",)
        got = tmesh.make_smoke_mesh(n_model, "cpu")
        assert got.axis_names == tuple(ref.axis_names) == ("data",)
        assert got.axis_sizes == tuple(ref.devices.shape) == (1,)
        assert got.device == torch.device("cpu")


# ------------------------------------------------------------- specs

def _leaf_info(shape, dtype, shard):
    return tuple(shape), str(dtype).replace("torch.", ""), tuple(shard)


def _ref_leaves(tree, path=""):
    """path -> (shape, dtype, shard shape) of a reference spec tree."""
    from repro.core import tensorizer as jtz
    out = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_ref_leaves(v, f"{path}/{k}"))
    elif isinstance(tree, jtz.QTensor):
        out.update(_ref_leaves(tree.q, path + ".q"))
        out.update(_ref_leaves(tree.scale, path + ".scale"))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            out.update(_ref_leaves(getattr(tree, k), f"{path}/{k}"))
    else:
        out[path] = _leaf_info(tree.shape, tree.dtype, tree.sharding.shard_shape(tree.shape))
    return out


def _port_leaves(tree, spec, path=""):
    out = {}
    if tree is None:
        assert spec is None
        return out
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_leaves(v, spec[k], f"{path}/{k}"))
    elif isinstance(tree, tz.QTensor):
        out.update(_port_leaves(tree.q, spec.q, path + ".q"))
        out.update(_port_leaves(tree.scale, spec.scale, path + ".scale"))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            out.update(_port_leaves(getattr(tree, k), getattr(spec, k), f"{path}/{k}"))
    else:
        assert tree.device.type == "meta"
        out[path] = _leaf_info(tree.shape, tree.dtype, TST.shard_shape(tree.shape, spec))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dry_run_specs_are_the_references(restore_reference_mesh, arch):
    for sizes, names in MESHES[1:]:
        jshd.set_mesh(AbstractMesh(sizes, names))
        with tshd.use_mesh(tshd.Mesh(sizes, names)):
            for quantize in ("off", "serve"):
                jc = jget(arch).replace(quantize=quantize)
                tc = P.jax_block(tget(arch)).replace(quantize=quantize)
                ref_p = JST.param_sds(jc)
                params, pspecs = TST.param_sds(tc)
                got = _port_leaves(params, pspecs)
                assert got == _ref_leaves(ref_p), (arch, quantize, names)
                if quantize == "off":
                    opt, ospecs = TST.opt_sds(tc, params, pspecs)
                    assert _port_leaves(opt, ospecs) == _ref_leaves(JST.opt_sds(jc, ref_p))
                    z1 = tc.replace(zero1=True)
                    opt, ospecs = TST.opt_sds(z1, params, pspecs)
                    assert (_port_leaves(opt, ospecs)
                            == _ref_leaves(JST.opt_sds(jc.replace(zero1=True), ref_p)))
            for ts, js in zip(SHAPES, JSHAPES):
                tc, jc = tget(arch), jget(arch)
                assert (_port_leaves(*TST.batch_specs(tc, ts))
                        == _ref_leaves(JST.batch_specs(jc, js))), ts.name
                if ts.kind == "decode":
                    assert (_port_leaves(*TST.cache_specs(tc, ts))
                            == _ref_leaves(JST.cache_specs(jc, js))), ts.name


# ------------------------------------------------------------- the CLIs

SERVE = ["--smoke", "--device", "cpu", "--quantize", "serve", "--requests", "3",
         "--prompt-len", "8", "--gen", "6", "--slots", "2", "--stagger-steps", "2"]


def test_serve_cli_and_worker_spec_take_model_parallel():
    one, _ = TSERVE.run(SERVE + ["--model-parallel", "1"])
    two, _ = TSERVE.run(SERVE + ["--model-parallel", "2"])
    assert [r.tokens for r in two] == [r.tokens for r in one]
    assert all(len(r.tokens) == 6 for r in one)
    spec = build_model_spec("tinyllama-1.1b", smoke=True, quantize="serve",
                            model_parallel=2, device="cpu")
    assert spec["model_parallel"] == 2
    assert build_model_spec("tinyllama-1.1b")["model_parallel"] == 1
    procs, _ = TSERVE.run(SERVE + ["--hosts", "1", "--host-procs", "--model-parallel", "2"])
    assert sorted(r.tokens for r in procs) == sorted(r.tokens for r in one)


def test_train_cli_takes_model_parallel(tmp_path):
    def losses(n_model):
        out = []
        rc = TTRAIN.main(["--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
                          "--seq", "16", "--model-parallel", str(n_model)],
                         on_step=lambda step, p, o, m: out.append(float(m["loss"])))
        assert rc == 0
        return out
    assert losses(2) == losses(1)
