"""The port's launch tooling against the reference's, on abstract shapes
only (nothing is compiled, nothing allocated):

* ``workloads.input_specs`` / ``param_specs`` / ``opt_specs`` /
  ``cache_specs``: every leaf's shape, dtype and logical axes equal the
  reference's (``jax.eval_shape``), for every config × the five shapes;
* ``sharding.spec_for`` equals ``repro.launch.sharding.spec_for`` for
  every leaf of those trees on duck-typed 1×1, 16×16 and 2×16×16 meshes
  (the reference's function reads only ``mesh.shape``), and with the
  hill-climb's rule overrides;
* ``dryrun.bytes_per_device`` equals the reference's arithmetic
  (``_bytes_per_device``, restated here through the reference's
  ``spec_for``: ``repro.launch.dryrun`` sets ``XLA_FLAGS`` on import, so
  it is never imported) for every config × shape × mesh;
* the meshes, ``residual_spec`` / ``batch_spec`` and the skip reasons.
"""

import functools
import json

import jax
import numpy as np
import pytest

from repro.configs import REGISTRY as JREGISTRY
from repro.launch import sharding as jsh
from repro.launch import workloads as JW
from repro_torch.configs import REGISTRY
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as sh
from repro_torch.launch import workloads as W


class DuckMesh:
    """What the reference's sharding functions read of a mesh."""

    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = {"1x1": {"data": 1, "model": 1},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
NAMES = sorted(REGISTRY)


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _flat(tree, pre=""):
    """{path: leaf} of a nested dict / list / tuple tree whose leaves are
    arrays, meta tensors or axes tuples."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
        return out
    if isinstance(tree, (list, tuple)) and not _is_axes(tree):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{pre}/{i}"))
        return out
    return {pre: tree}


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    return JW.param_specs(JREGISTRY[name])


@functools.lru_cache(maxsize=None)
def _port_params(name):
    return W.param_specs(REGISTRY[name])


@functools.lru_cache(maxsize=None)
def _ref_opt(name):
    st, ax = JW.opt_specs(JREGISTRY[name])
    return (st.step, st.mu, st.nu), (ax.step, ax.mu, ax.nu)


@functools.lru_cache(maxsize=None)
def _port_opt(name):
    st, ax = W.opt_specs(REGISTRY[name])
    return (st.step, st.mu, st.nu), (ax.step, ax.mu, ax.nu)


XLSTM_KEYS = {"mlstm": ("C", "n", "m"), "slstm": ("c", "n", "h", "m")}


def _ref_cache_layers(cfg, tree):
    """The reference's per-stage cache tree (values or axes) as one entry a
    layer, the stacked leading axis taken off, xLSTM tuples as the port's
    dicts."""
    out = []
    for si, (unit, repeats) in enumerate(cfg.scan_stages):
        for _ in range(repeats):
            for ui, kind in enumerate(unit):
                entry = tree[si][ui]
                if repeats > 1:
                    entry = jax.tree.map(
                        lambda a: a[1:] if _is_axes(a) else
                        jax.ShapeDtypeStruct(a.shape[1:], a.dtype),
                        entry, is_leaf=_is_axes)
                if kind in XLSTM_KEYS:
                    entry = dict(zip(XLSTM_KEYS[kind], entry))
                out.append(entry)
    return out


@functools.lru_cache(maxsize=None)
def _trees(name, shape_name, mesh):
    """[(label, ref values, ref axes, port values, port axes)] of the
    workload's state trees and its inputs, flattened to matching paths."""
    jcfg, cfg = JREGISTRY[name], REGISTRY[name]
    shape, jshape = W.SHAPES[shape_name], JW.SHAPES[shape_name]
    out = [("params", *_ref_params(name), *_port_params(name))]
    if shape.kind == "train":
        out.append(("opt", *_ref_opt(name), *_port_opt(name)))
    if shape.kind in ("decode", "verify"):
        jc, jca = JW.cache_specs(jcfg, jshape, DuckMesh(MESHES[mesh]))
        c, ca = W.cache_specs(cfg, shape, tmesh.MeshShape(
            MESHES[mesh].values(), MESHES[mesh]))
        out.append(("cache", (_ref_cache_layers(jcfg, jc.stages),
                              jc.lengths),
                    (_ref_cache_layers(jcfg, jca.stages), jca.lengths),
                    (c.layers, c.lengths), (ca.layers, ca.lengths)))
    ji, jia = JW.input_specs(jcfg, jshape)
    ti, tia = W.input_specs(cfg, shape)
    assert list(ji) == list(ti) and list(jia) == list(tia)
    out.append(("inputs", ji, jia, ti, tia))
    return [(label, _flat(a), _flat(b), _flat(c), _flat(d))
            for label, a, b, c, d in out]


@pytest.mark.parametrize("name", NAMES)
def test_specs_equal_the_reference(name):
    """Shapes, dtypes and logical axes of every leaf, all five shapes."""
    for shape_name in W.SHAPES:
        for label, jv, ja, tv, ta in _trees(name, shape_name, "16x16"):
            assert set(jv) == set(tv) == set(ja) == set(ta), (label, set(jv)
                                                             ^ set(tv))
            for k in jv:
                where = (name, shape_name, label, k)
                assert tuple(jv[k].shape) == tuple(tv[k].shape), where
                assert str(jv[k].dtype) == _dtype(tv[k]), where
                assert tuple(ja[k]) == tuple(ta[k]), where
                assert tv[k].is_meta, where


def _ref_bytes(values, axes, mesh):
    """The reference's ``_bytes_per_device`` arithmetic, through its own
    ``spec_for`` on a duck mesh."""
    total = 0.0
    for k, s in values.items():
        n = int(np.prod(s.shape)) if s.shape else 1
        for ax in jsh.spec_for(s.shape, axes[k], mesh):
            if ax is None:
                continue
            f = 1
            for a in (ax,) if isinstance(ax, str) else ax:
                f *= mesh.shape[a]
            n //= f
        total += n * np.dtype(s.dtype).itemsize
    return total


@pytest.mark.parametrize("name", NAMES)
def test_spec_for_and_bytes_per_device_equal_the_reference(name):
    """spec_for case by case over every leaf, and each device's bytes of
    the parameters, optimizer state and cache, on all three meshes."""
    no_embed = dict(sh.DEFAULT_RULES, embed=None)
    for shape_name in W.SHAPES:
        for mesh in MESHES:
            duck = DuckMesh(MESHES[mesh])
            m = tmesh.MeshShape(MESHES[mesh].values(), MESHES[mesh])
            want = got = 0.0
            for label, jv, ja, tv, ta in _trees(name, shape_name, mesh):
                for k in jv:
                    for rules in (None, no_embed):
                        assert tuple(sh.spec_for(tv[k].shape, ta[k], m, rules)) \
                            == tuple(jsh.spec_for(jv[k].shape, ja[k], duck,
                                                  rules)), (name, mesh, k)
                if label != "inputs":
                    want += _ref_bytes(jv, ja, duck)
            got = D.state_bytes(REGISTRY[name], W.SHAPES[shape_name], m)
            assert got == want, (name, shape_name, mesh, got, want)


def test_meshes_and_activation_specs():
    local, prod, multi = (tmesh.make_local_mesh(),
                          tmesh.make_production_mesh(),
                          tmesh.make_production_mesh(multi_pod=True))
    assert (local.name, local.size) == ("1x1", 1)
    assert (prod.name, prod.size, prod.shape["model"]) == ("16x16", 256, 16)
    assert (multi.name, multi.size) == ("2x16x16", 512)
    assert multi.axis_names == ("pod", "data", "model")
    assert prod.size // tmesh.GPUS_PER_NODE == 32
    for mesh in (local, prod, multi):
        duck = DuckMesh(mesh.shape)
        for seq in (4096, 4095, 1):
            assert tuple(sh.residual_spec(mesh, seq)) == tuple(
                jsh.residual_spec(duck, seq))
        assert tuple(sh.batch_spec(mesh, extra_dims=2)) == tuple(
            jsh.batch_spec(duck, extra_dims=2))
    x = object()
    with sh.use_activation_spec(sh.P("data", None), moe_cap="data"):
        assert sh.activation_spec() == sh.P("data", None)
        assert sh.moe_cap_axis() == "data"
        assert sh.constrain(x) is x and sh.constrain_moe(x) is x
    assert sh.activation_spec() is None and sh.moe_cap_axis() is None


def test_skip_reasons_and_shapes_equal_the_reference():
    assert {k: tuple(vars(v).values()) for k, v in W.SHAPES.items()} == {
        k: tuple(vars(v).values()) for k, v in JW.SHAPES.items()}
    assert (W.VERIFY_K, W.S_ENC, W.SLOT_MULTIPLE) == (
        JW.VERIFY_K, JW.S_ENC, JW.SLOT_MULTIPLE)
    for name in NAMES:
        for s in W.SHAPES:
            assert W.skip_reason(REGISTRY[name], W.SHAPES[s]) == \
                JW.skip_reason(JREGISTRY[name], JW.SHAPES[s]), (name, s)


def test_dryrun_direct_flag_counts_without_extrapolating(monkeypatch,
                                                         capsys):
    """``--direct`` counts the step op by op at its full depth: the record
    equals ``count_direct`` of the published config."""
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", "xlstm-125m",
                                     "--shape", "decode_32k", "--direct"])
    D.main()
    rec = json.loads(capsys.readouterr().out.splitlines()[0])
    assert rec["status"] == "ok"
    direct, launches = D.count_direct(REGISTRY["xlstm-125m"],
                                      W.SHAPES["decode_32k"])
    assert (rec["total_flops"], rec["total_bytes"], rec["temp_bytes"]) == \
        tuple(float(v) for v in direct)
    assert rec["kernel_launches"] == launches
