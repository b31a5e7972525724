"""The port's FSDP layout (``tpuflow_torch/parallel/sharding.py``,
``tpuflow_torch/dist/mesh.py``) against the JAX package's.

- The rule: for worlds 2, 3, 4 and 8, every leaf of the ``test`` and
  ``medium`` JAX param trees (abstract shapes only) is sharded on the dim
  ``tpuflow.parallel.make_shardings`` gives on a JAX mesh over that many
  of the 8 CPU devices (or kept replicated where it does), and each torch
  parameter's local shard, laid out by ``params_to_jax``, is that leaf's
  shard (the whole leaf where the rule shards the layer axis, which no
  torch parameter has).
- FSDP2 places the shards where the rule says: two spawned processes'
  local parameters are the matching blocks of the seed-0 model, and the
  AdamW moments mirror them.
- The mesh: named axes whose product must be the world, a hybrid mesh
  with its DCN axes major, and ``shard_batch`` handing process i of N the
  rows [i B / N, (i + 1) B / N), data major.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_gang_flows import spawn_world
from torch_parity import one_torch_thread  # noqa: F401
from tpuflow import dist as jdist
from tpuflow.models.gpt2 import GPT2 as JGPT2
from tpuflow.parallel import make_shardings as jax_make_shardings
from tpuflow.train import gpt as jgpt
from tpuflow_torch import dist
from tpuflow_torch.ckpt.tree import params_to_jax
from tpuflow_torch.models.gpt2 import GPT2
from tpuflow_torch.parallel import (
    ShardPlan,
    has_sharded_leaf,
    leaf_spec,
    make_shardings,
)
from tpuflow_torch.train import gpt as tgpt

WORLDS = (2, 3, 4, 8)
PRESETS = ("test", "medium")


def _port_model(preset: str):
    cfg = tgpt.GptTrainConfig(preset=preset).model_config()
    return GPT2(cfg, seed=None, device="meta"), cfg.scan_layers


def _fsdp(world: int) -> dist.Mesh:
    """The mesh of an fsdp world of ``world`` as its process 0 sees it."""
    return dist.Mesh({"data": 1, "fsdp": world}, torch.device("meta"))


def _leaf_paths(preset: str) -> list[str]:
    model, scan = _port_model(preset)
    return ["/".join(p) for p in ShardPlan(model, scan, _fsdp(2)).leaves]


@functools.lru_cache(maxsize=None)
def _jax_dims(preset: str, world: int) -> dict:
    """Leaf path → (shape, sharded dim or None) from the JAX package's
    ``make_shardings`` on a (data 1, fsdp world) mesh."""
    cfg = jgpt.GptTrainConfig(preset=preset).model_config()
    abstract = jax.eval_shape(JGPT2(cfg).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    mesh = jdist.make_mesh({"data": 1, "fsdp": world},
                           devices=jax.devices()[:world])
    shardings = jax_make_shardings(abstract, mesh)
    out = {}
    for (path, leaf), (_, sh) in zip(
            jax.tree_util.tree_flatten_with_path(abstract)[0],
            jax.tree_util.tree_flatten_with_path(
                shardings, is_leaf=lambda x: hasattr(x, "spec"))[0]):
        dims = [d for d, part in enumerate(sh.spec) if part is not None]
        assert len(dims) <= 1
        out["/".join(str(e.key) for e in path)] = (
            tuple(leaf.shape), dims[0] if dims else None)
    return out


@functools.lru_cache(maxsize=None)
def _port(preset: str, world: int):
    model, scan = _port_model(preset)
    plan = ShardPlan(model, scan, _fsdp(world))
    local = {}
    for name, p in model.named_parameters():
        shape = list(p.shape)
        d = plan.dims[name]
        if d is not None:
            shape[d] //= world
        local[name] = torch.empty(shape, device="meta")
    tree = params_to_jax(local, scan_layers=scan)
    from tpuflow_torch.ckpt.raw import flatten

    return plan, {"/".join(p): tuple(t.shape) for p, t in flatten(tree)}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("preset,path", [
    (preset, path) for preset in PRESETS for path in _leaf_paths(preset)])
def test_rule_matches_make_shardings(preset, path, world):
    """The port's dim of one JAX leaf is ``make_shardings``'s, and the
    torch parameters' local shards lay out as that leaf's shard."""
    plan, local = _port(preset, world)
    shape, want = _jax_dims(preset, world)[path]
    got_shape, got = plan.leaves[tuple(path.split("/"))]
    assert (tuple(got_shape), got) == (shape, want)
    stacked = path.startswith("h/block/")
    region = list(shape)
    if want is not None and not (stacked and want == 0):
        region[want] //= world
    assert local[path] == tuple(region)


@pytest.mark.parametrize("world", (2, 4, 8))
def test_medium_wte_shards_its_width(world):
    """The vocab (50257) is odd: medium's wte shards its dim 1, the torch
    embedding's dim 1 too."""
    plan, _ = _port("medium", world)
    assert plan.leaves[("wte",)] == ((50257, 1024), 1)
    assert plan.dims["wte"] == 1
    assert plan.dims["h.0.mlp_fc.weight"] == 0  # (L, 1024, 4096) dim 2
    assert plan.dims["h.0.mlp_proj.weight"] == 1  # (L, 4096, 1024) dim 1
    assert plan.dims["h.0.ln_1.weight"] == 0  # judged at (24, 1024)


def test_layer_axis_keeps_the_torch_parameters_whole():
    """At world 3 medium's stacked LayerNorms (24, 1024) shard the layer
    axis (1024 % 3 != 0): every process holds those tensors whole."""
    plan, local = _port("medium", 3)
    assert plan.leaves[("h", "block", "ln_1", "scale")][1] == 0
    assert plan.dims["h.0.ln_1.weight"] is None
    assert local["h/block/ln_1/scale"] == (24, 1024)


def test_make_shardings_and_has_sharded_leaf():
    tree = {"a": torch.empty(64, 128, device="meta"),
            "b": torch.empty(10, device="meta")}
    two, one = {"fsdp": 2}, {"fsdp": 1}
    assert make_shardings(tree, two) == {"a": (None, "fsdp"), "b": (None,)}
    assert leaf_spec((), (128, 64), two) == ("fsdp", None)
    assert leaf_spec((), (64, 64), two) == (None, "fsdp")
    assert leaf_spec((), (4096,), one) == (None,)
    assert leaf_spec((), (4095,), two) == (None,)
    assert has_sharded_leaf(make_shardings(tree, two))
    assert not has_sharded_leaf(make_shardings(tree, one))
    model, scan = _port_model("test")
    assert has_sharded_leaf(ShardPlan(model, scan, _fsdp(2)))
    assert not has_sharded_leaf(ShardPlan(model, scan, _fsdp(1)))


def test_fsdp2_places_the_rule_shards():
    """Two processes' local parameters (FSDP2 ``fully_shard`` with the
    plan's ``Shard`` dims) are the matching blocks of the seed-0 model,
    the replicated ones whole, and the AdamW moments have their shapes."""
    cfg = dict(preset="test", data_axis=1, fsdp_axis=2)
    got = spawn_world(2, "fsdp_local_shards", cfg=cfg)
    full = dict(GPT2(tgpt.GptTrainConfig(**cfg).model_config(), seed=0,
                     device="cpu").named_parameters())
    assert [r["index"] for r in got] == [0, 1]
    assert any(d is not None for d in got[0]["dims"].values())
    for r in got:
        for name, local in r["local"].items():
            want = full[name].detach().numpy()
            d = r["dims"][name]
            if d is not None:
                want = np.split(want, 2, axis=d)[r["index"]]
            np.testing.assert_array_equal(local, want, err_msg=name)
        assert r["moments"] == [v.shape for v in r["local"].values()]


def test_named_mesh_of_one_process():
    mesh = dist.make_mesh("cpu", {"data": 1, "fsdp": -1})
    assert mesh.shape == {"data": 1, "fsdp": 1, "tensor": 1, "seq": 1,
                          "expert": 1}
    assert dist.data_axis_size(mesh) == 1 and mesh.index == 0
    with pytest.raises(ValueError, match="wants 4 processes but the world "
                       "has 1"):
        dist.make_mesh("cpu", {"data": 2, "fsdp": 2})
    with pytest.raises(ValueError, match="unknown mesh axes"):
        dist.make_mesh("cpu", {"pipe": 1})
    with pytest.raises(ValueError, match="wants 2 processes but the world "
                       "has 1"):
        dist.make_mesh("cpu", {"seq": 2})
    with pytest.raises(ValueError, match="wants 2 processes but the world "
                       "has 1"):
        dist.make_mesh("cpu", {"tensor": 2})
    with pytest.raises(ValueError, match="both dcn and ici"):
        dist.make_hybrid_mesh({"data": 1}, {"data": 1}, "cpu")


def test_shard_batch_rows_and_hybrid_order():
    """Four processes: on data 2 x fsdp 2 process r takes rows
    [2r, 2r + 2) of 8; on a hybrid mesh with ``fsdp`` over DCN and
    ``data`` within, ranks fill ``data`` first, so rank 1 sits at
    (data 1, fsdp 0), the batch's third block."""
    flat = spawn_world(4, "mesh_layout", axes={"data": 2, "fsdp": 2})
    assert [r["rows"] for r in flat] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert [r["coords"] for r in flat] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    hyb = spawn_world(4, "mesh_layout", dcn={"fsdp": 2}, ici={"data": 2})
    assert [r["coords"] for r in hyb] == [[0, 0], [1, 0], [0, 1], [1, 1]]
    assert [r["index"] for r in hyb] == [0, 2, 1, 3]
    assert hyb[1]["rows"] == [4, 5]
    with pytest.raises(RuntimeError, match="does not split over 4"):
        spawn_world(4, "mesh_layout", axes={"data": 4}, rows=6)
