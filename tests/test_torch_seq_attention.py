"""The port's sequence-parallel attention (``parallel/ring_attention.py``,
``parallel/ulysses.py``, the gathered path of ``ops/attention.py``) and
its collectives (``parallel/p2p.py``) against the JAX package's on a
``seq`` mesh of the same size.

The port runs in spawned gloo worlds of 2 and 4 processes
(``torch_gang_flows.seq_attention``), each process on its block of the
sequence; the JAX functions run here on ``make_mesh({"seq": s})`` over s
of the suite's CPU devices, on the same seeded numpy inputs. Tolerances:
the forward within atol 1e-5, dq, dk, dv within atol 1e-4 (the JAX
tests' own tolerance against xla, ``tests/test_attention.py:108``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_gang_flows import _qkv, spawn_world
from torch_parity import one_torch_thread  # noqa: F401
from tpuflow import dist as jdist
from tpuflow.ops.attention import xla_attention as jxla
from tpuflow.ops.flash_attention import blockwise_attention as jblockwise
from tpuflow.parallel.ring_attention import ring_attention as jring
from tpuflow.parallel.ulysses import ulysses_attention as julysses
from tpuflow_torch import dist
from tpuflow_torch.ops import attention as tattn
from tpuflow_torch.parallel.ring_attention import ring_attention
from tpuflow_torch.parallel.ulysses import ulysses_attention

B, T, H, D = 2, 32, 4, 16
H_RAGGED = 3  # not divisible by 2 or 4: Ulysses's fallback
FWD_ATOL, GRAD_ATOL = 1e-5, 1e-4


def _jax_ref(fn, heads: int):
    """``fn(q, k, v)``'s output and q, k, v gradients on the seeded
    arrays of ``heads`` heads (the cotangent the ports use)."""
    q, k, v, do = (jnp.asarray(a) for a in _qkv((B, T, heads, D), heads))

    @jax.jit
    def both(q, k, v, do):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out, *vjp(do))

    return [np.asarray(t) for t in both(q, k, v, do)]


@pytest.fixture(scope="module", params=[2, 4], ids=["seq2", "seq4"])
def worlds(request):
    s = request.param
    got = spawn_world(s, "seq_attention", B=B, T=T, H=H, D=D,
                      h_ragged=H_RAGGED)
    return s, got


def _whole(got, name):
    """The ranks' blocks of each of ``name``'s four arrays, joined along
    T."""
    return [np.concatenate([r[name][i] for r in got], axis=1)
            for i in range(4)]


def _close(port, ref, what):
    for name, a, b, atol in zip(("out", "dq", "dk", "dv"), port, ref,
                                (FWD_ATOL, GRAD_ATOL, GRAD_ATOL,
                                 GRAD_ATOL)):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0,
                                   err_msg=f"{what} {name}")


def test_ring_and_ulysses_match_jax(worlds):
    """Ring and Ulysses on s processes against the JAX functions on a
    ``seq`` mesh of s devices: each process's block of the output and of
    the gradients, joined, within the stated tolerances; Ulysses at H % s
    != 0 takes the JAX fallback (blockwise attention over the whole
    sequence) on both sides."""
    s, got = worlds
    mesh = jdist.make_mesh({"seq": s}, devices=jax.devices()[:s])
    with mesh:
        ring = _jax_ref(lambda q, k, v: jring(q, k, v, causal=True,
                                              mesh=mesh), H)
        uly = _jax_ref(lambda q, k, v: julysses(q, k, v, causal=True,
                                                mesh=mesh), H)
        ragged = _jax_ref(lambda q, k, v: julysses(q, k, v, causal=True,
                                                   mesh=mesh), H_RAGGED)
    _close(_whole(got, "ring"), ring, f"ring s={s}")
    _close(_whole(got, "ulysses"), uly, f"ulysses s={s}")
    _close(_whole(got, "ulysses_ragged"), ragged,
           f"ulysses H={H_RAGGED} s={s}")
    # The ring is not the ragged fallback: the inputs split.
    assert T % s == 0 and H % s == 0


def test_gathered_xla_matches_whole(worlds):
    """``attention(impl="xla", seq=...)`` under a ``seq`` mesh sees the
    whole sequence: each process's block equals the JAX einsum attention
    over all of T (forward and gradients)."""
    s, got = worlds
    ref = _jax_ref(lambda q, k, v: jxla(q, k, v, causal=True), H)
    _close(_whole(got, "xla"), ref, f"gathered xla s={s}")


def test_ppermute_autograd(worlds):
    """``p2p.ppermute`` around the ring: process r receives r - 1's
    values, and its input's gradient is the cotangent its right
    neighbour applied (the reverse shift, JAX's transpose)."""
    s, got = worlds
    for r, res in enumerate(got):
        y, gx = res["ppermute"]
        assert (y == (r - 1) % s).all()
        assert (gx == (r + 1) % s + 1).all()


def test_fallbacks_trivial_and_ragged_axes():
    """The JAX fallbacks in one process: ``s == 1`` (no ``seq`` group, or
    a trivial one) and T % s != 0 (a sequence that does not split: the
    JAX functions fall back to blockwise attention, and
    ``dist.shard_batch`` refuses to split it, as JAX's placement does;
    the process holding it whole passes no ``seq``) give blockwise
    attention, equal to the JAX functions' results; ``attention``'s ring
    and ulysses without a ``seq`` group are the same."""
    ragged_T = 30
    q, k, v, _ = _qkv((B, ragged_T, H, D), 7)
    mesh = jdist.make_mesh({"seq": 4}, devices=jax.devices()[:4])
    with mesh:
        want_ring = np.asarray(jring(*map(jnp.asarray, (q, k, v)),
                                     causal=True, mesh=mesh))
        want_uly = np.asarray(julysses(*map(jnp.asarray, (q, k, v)),
                                       causal=True, mesh=mesh))
    want = np.asarray(jblockwise(*map(jnp.asarray, (q, k, v)),
                                 causal=True))
    np.testing.assert_allclose(want_ring, want, atol=0, rtol=0)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for got in (ring_attention(tq, tk, tv, causal=True),
                ulysses_attention(tq, tk, tv, causal=True),
                tattn.attention(tq, tk, tv, impl="ring"),
                tattn.attention(tq, tk, tv, impl="ulysses")):
        np.testing.assert_allclose(got.numpy(), want_ring, atol=FWD_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(got.numpy(), want_uly, atol=FWD_ATOL,
                                   rtol=0)
    mesh4 = dist.Mesh({"data": 1, "fsdp": 1, "tensor": 1, "seq": 4,
                       "expert": 1}, torch.device("cpu"),
                      coords={"seq": 1})
    with pytest.raises(ValueError, match="does not split over seq=4"):
        dist.shard_batch({"x": np.zeros((2, ragged_T), np.int64)}, mesh4)
    with pytest.raises(ValueError, match="inner_impl must be"):
        ulysses_attention(tq, tk, tv, inner_impl="ring")


@pytest.mark.parametrize("axes,dcn", [
    ({"data": 2, "seq": 2}, None),
    ({"data": 2, "stage": 2}, None),
    ({"data": 2, "seq": 2}, {"data": 2}),
], ids=["data2xseq2", "data2xstage2", "hybrid-dcn-data2xseq2"])
def test_seq_and_stage_mesh_layout(axes, dcn):
    """Process r sits where JAX's ``make_mesh`` (``make_hybrid_mesh``) puts
    device r: the canonical axes in order on a ``seq`` mesh, ``stage``
    right after ``data`` on the pipeline mesh; ``shard_batch`` hands it
    the rows of its (data, fsdp) block and, on ``seq``, the columns of its
    seq coordinate (JAX's ``P(("data", "fsdp"), "seq")``); stage peers
    take the same rows whole; the mesh holds a group for each axis above
    1."""
    n = 4
    if dcn is None:
        got = spawn_world(n, "mesh_layout", axes=axes, rows=4, cols=8)
        jmesh = jdist.make_mesh(axes, devices=jax.devices()[:n])
    else:
        ici = {k: v for k, v in axes.items() if k not in dcn}
        got = spawn_world(n, "mesh_layout", dcn=dcn, ici=ici, rows=4,
                          cols=8)
        jmesh = jdist.make_mesh(axes, devices=jax.devices()[:n])
    x = np.arange(32).reshape(4, 8)
    for r, res in enumerate(got):
        dev = jax.devices()[r]
        pos = {name: int(i) for name, i in zip(
            jmesh.axis_names, np.argwhere(jmesh.devices == dev)[0])}
        for a, c in res["all_coords"].items():
            assert c == pos.get(a, 0), (r, a)
        d = pos["data"]
        want = x[2 * d:2 * d + 2]
        if axes.get("seq", 1) > 1:
            c = pos["seq"]
            want = want[:, 4 * c:4 * c + 4]
        assert res["rows"] == want.tolist(), r
        assert res["groups"] == {a: axes.get(a, 1) > 1 for a in res["shape"]}
