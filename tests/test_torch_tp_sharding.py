"""The port's placement of a GPT-2 train state on meshes with ``tensor``
and ``expert`` axes (``tpuflow_torch/parallel/sharding.py``,
``tpuflow_torch/dist/mesh.py``) against the JAX package's.

- The rule: every leaf of the abstract train state (params and the
  optimizer's leaves, AdamW and Adafactor, dense and MoE, at the
  ``test``, ``gpt2`` and ``medium`` presets) has the spec that
  ``tpuflow.parallel.make_shardings(..., tensor_rules=gpt2_tensor_rules)``
  gives on a JAX mesh of the same shape (fsdp 2 x tensor 2, data 2 x
  tensor 2, fsdp 2 x expert 2, tensor 4), each case guarded by
  ``has_sharded_leaf(axis=...)`` so that it cannot pass with the model
  axes left out.
- The regions: on fsdp 2 x tensor 2 each process's ``ShardPlan`` block of
  every param leaf is the one JAX's sharding gives the device at the same
  coordinate, and the processes that write a leaf (coordinate 0 of the
  axes it is replicated over) write each region once.
- The mesh: four spawned processes sit at the JAX device order's
  coordinates, and ``shard_batch`` hands each the rows JAX's batch
  sharding ``P(("data", "fsdp"))`` gives its device (tensor and expert
  peers the same rows).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_gang_flows import spawn_world
from torch_parity import one_torch_thread  # noqa: F401
from tpuflow import dist as jdist
from tpuflow.ckpt.raw import _path_names
from tpuflow.models.gpt2 import GPT2 as JGPT2
from tpuflow.parallel import gpt2_tensor_rules as jax_rules
from tpuflow.parallel import make_shardings as jax_make_shardings
from tpuflow.train import TrainState as JTrainState
from tpuflow.train import gpt as jgpt
from tpuflow_torch.ckpt.raw import flatten
from tpuflow_torch.ckpt.tree import JaxLeaves, checkpoint_tree
from tpuflow_torch.models.gpt2 import GPT2
from tpuflow_torch.parallel import (
    ShardPlan,
    gpt2_tensor_rules,
    has_sharded_leaf,
    make_shardings,
)
from tpuflow_torch.parallel.sharding import owner
from tpuflow_torch.train import gpt as tgpt
from tpuflow_torch.train.step import TrainState

MESHES = {
    "fsdp2xtensor2": {"data": 1, "fsdp": 2, "tensor": 2},
    "data2xtensor2": {"data": 2, "fsdp": 1, "tensor": 2},
    "fsdp2xexpert2": {"data": 1, "fsdp": 2, "expert": 2},
    "tensor4": {"data": 1, "fsdp": 1, "tensor": 4},
}
STATES = [(preset, experts, opt) for preset in ("test", "gpt2", "medium")
          for experts in (0, 4) for opt in ("adamw", "adafactor")]


def _jax_mesh(axes: dict):
    n = int(np.prod(list(axes.values())))
    return jdist.make_mesh(dict(axes), devices=jax.devices()[:n])


@functools.lru_cache(maxsize=None)
def _jax_state(preset: str, experts: int, opt: str):
    cfg = jgpt.GptTrainConfig(preset=preset, experts=experts,
                              optimizer_name=opt)
    model = JGPT2(cfg.model_config())
    tx = cfg.optimizer()

    def init_fn(rng):
        params = model.init(rng, jnp.zeros((1, 8), jnp.int32))["params"]
        return JTrainState.create(apply_fn=model.apply, params=params,
                                  tx=tx)

    return jax.eval_shape(init_fn, jax.random.PRNGKey(0))


def _jax_specs(preset, experts, opt, axes) -> dict:
    abstract = _jax_state(preset, experts, opt)
    shardings = jax_make_shardings(abstract, _jax_mesh(axes),
                                   tensor_rules=jax_rules)
    out = {}
    for (path, leaf), (_, sh) in zip(
            jax.tree_util.tree_flatten_with_path(abstract)[0],
            jax.tree_util.tree_flatten_with_path(
                shardings, is_leaf=lambda x: hasattr(x, "spec"))[0]):
        spec = tuple(sh.spec) + (None,) * (len(leaf.shape) - len(sh.spec))
        out["/".join(_path_names(path))] = spec
    return out


@functools.lru_cache(maxsize=None)
def _port_tree(preset: str, experts: int, opt: str) -> dict:
    """The port's checkpoint tree of the whole state, shapes only."""
    cfg = tgpt.GptTrainConfig(preset=preset, experts=experts,
                              optimizer_name=opt)
    mc = cfg.model_config()
    model = GPT2(mc, seed=None, device="meta")
    state = TrainState(model=model, tx=cfg.optimizer(
        model.parameters(), JaxLeaves(model, mc.scan_layers)))
    return checkpoint_tree(state, scan_layers=mc.scan_layers, abstract=True)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("preset,experts,opt", STATES)
def test_state_specs_match_make_shardings(preset, experts, opt, mesh):
    """Every leaf of the state has JAX's spec on the mesh, and the model
    axis is used (the tensor axis always, the expert axis on MoE)."""
    axes = MESHES[mesh]
    want = _jax_specs(preset, experts, opt, axes)
    got = {"/".join(p): s for p, s in flatten(make_shardings(
        _port_tree(preset, experts, opt), axes,
        tensor_rules=gpt2_tensor_rules))}
    assert sorted(got) == sorted(want)
    assert got == want
    axis = "expert" if "expert" in axes else "tensor"
    if axis == "tensor" or experts:
        assert has_sharded_leaf(got, axis=axis)
        assert has_sharded_leaf(
            {k: v for k, v in got.items() if k.startswith("params/")},
            axis=axis)


def _port_plan(preset: str, axes: dict, rank: int, experts: int = 0):
    cfg = tgpt.GptTrainConfig(preset=preset, experts=experts)
    mc = cfg.model_config()
    shape = {a: axes.get(a, 1) for a in ("data", "fsdp", "tensor", "seq",
                                         "expert")}
    coords = dict(zip(shape, np.unravel_index(rank, list(shape.values()))))
    mesh = types.SimpleNamespace(
        shape=shape, coord=lambda a: int(coords[a]),
        fsdp_index=int(coords["data"] * shape["fsdp"] + coords["fsdp"]),
        full_mesh=None)
    return ShardPlan(GPT2(mc, seed=None, device="meta"), mc.scan_layers,
                     mesh, tensor_rules=gpt2_tensor_rules)


@pytest.mark.parametrize("preset,experts", [("test", 0), ("gpt2", 0),
                                            ("test", 4)])
def test_regions_are_jax_devices(preset, experts):
    """At fsdp 2 x tensor 2 (x expert 2 with experts) each process's block
    of every param leaf is JAX's for the device at its coordinate, and the
    writers cover each distinct region once."""
    axes = {"data": 1, "fsdp": 2, "tensor": 2}
    if experts:
        axes = {"data": 1, "fsdp": 2, "expert": 2}
    n = int(np.prod(list(axes.values())))
    mesh = _jax_mesh(axes)
    abstract = _jax_state(preset, experts, "adamw").params
    shardings = jax_make_shardings(abstract, mesh, tensor_rules=jax_rules)
    plans = [_port_plan(preset, axes, r, experts) for r in range(n)]
    assert has_sharded_leaf(plans[0], axis=list(axes)[-1])
    for (path, leaf), (_, sh) in zip(
            jax.tree_util.tree_flatten_with_path(abstract)[0],
            jax.tree_util.tree_flatten_with_path(
                shardings, is_leaf=lambda x: hasattr(x, "spec"))[0]):
        key = tuple(_path_names(path))
        index = sh.devices_indices_map(leaf.shape)
        written = []
        for r, plan in enumerate(plans):
            shape, spec, _, rule = plan._blocks(key)
            dev = jax.devices()[r]
            want = [(s.start or 0, (s.stop or n_) - (s.start or 0))
                    for s, n_ in zip(index[dev], leaf.shape)]
            assert list(zip(*rule)) == want, (key, r)
            if owner(spec, plan.coords):
                written.append(tuple(rule[0]))
        distinct = {tuple((s.start or 0) for s in idx)
                    for idx in index.values()}
        assert sorted(written) == sorted(distinct), key


@pytest.mark.parametrize("axes", [
    {"data": 1, "fsdp": 2, "tensor": 2},
    {"data": 2, "fsdp": 1, "tensor": 2},
    {"data": 1, "fsdp": 2, "expert": 2},
], ids=["fsdp2xtensor2", "data2xtensor2", "fsdp2xexpert2"])
def test_mesh_order_and_rows_are_jax_devices(axes):
    """Process r sits at the coordinate of JAX device r on the same mesh
    and ``shard_batch`` hands it the rows JAX's batch sharding gives that
    device (tensor and expert peers alike)."""
    got = spawn_world(4, "mesh_layout", axes=axes)
    mesh = _jax_mesh(axes)
    rows = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(("data", "fsdp"))
    ).devices_indices_map((8,))
    devices = np.asarray(mesh.devices)
    for r, g in enumerate(got):
        dev = jax.devices()[r]
        where = dict(zip(mesh.axis_names,
                         (int(i) for i in np.argwhere(devices == dev)[0])))
        assert g["all_coords"] == {a: where.get(a, 0) for a in
                                   g["all_coords"]}
        sl = rows[dev][0]
        assert g["rows"] == list(range(sl.start or 0, sl.stop or 8))


def test_seq_axis_names_item_14b():
    """ROADMAP item 14b is done: a ``seq`` axis above 1 is a mesh axis
    like the others, so past the world it raises the world's ValueError
    (``tests/test_torch_seq_*`` run it on several processes)."""
    from tpuflow_torch import dist

    with pytest.raises(ValueError, match="wants 2 processes but the world "
                       "has 1"):
        dist.make_mesh("cpu", {"seq": 2})


def test_rule_is_the_jax_rule():
    """The rule itself on every kind of leaf it names, and beyond."""
    cases = [
        (("h0", "c_attn", "kernel"), (128, 384)),
        (("h", "block", "c_attn", "kernel"), (12, 768, 2304)),
        (("h0", "c_proj", "kernel"), (128, 128)),
        (("h", "block", "mlp_proj", "kernel"), (12, 3072, 768)),
        (("h0", "mlp_fc", "bias"), (512,)),
        (("wte",), (512, 128)),
        (("wpe",), (1024, 768)),
        (("h0", "moe", "w1"), (4, 128, 512)),
        (("h", "block", "moe", "w2"), (12, 4, 512, 128)),
        (("h0", "moe", "b2"), (4, 128)),
        (("h0", "moe", "gate", "kernel"), (128, 4)),
        (("opt_state", "0", "v_row", "h0", "c_attn", "kernel"), (128,)),
        (("step",), ()),
    ]
    for names, shape in cases:
        assert gpt2_tensor_rules(names, shape) == jax_rules(names, shape)
