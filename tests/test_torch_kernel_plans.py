"""The launch plans of the port's int8 matmul and flash kernels.

Pure Python: a plan holds the decisions the CUDA entry points are handed
(the int8 tile, split of K and ring depth; the flash forward's q tile
height; the flash backward's rows a dq and a dk/dv block own), so
these tests hold them on the CPU, where no kernel runs, against the way the
kernels walk them: the pieces of K each split covers, the grids, and the
order of the q tiles. The shared memory each launch takes is the C entry's
own and is held to the card's limit by ``tests/test_torch_cuda.py``.
"""

import pytest
import torch

from tpuflow_torch.ops import flash_attention as fa
from tpuflow_torch.ops import int8_matmul as im

# (K, N) of the main paths: GPT-2 124M's four Dense layers and its tied LM
# head, plus ragged shapes the card tests use.
MAIN_KN = [(768, 2304), (768, 768), (768, 3072), (3072, 768), (768, 50257)]
RAGGED_KN = [(100, 50), (3072, 50257), (768, 50), (1, 1)]
MS = [1, 7, 8, 9, 16, 17, 512, 1023]
# SMs of an H100 SXM and of an H100 PCIe: the plan follows the card.
SMS = [132, 114]
GRID_MAX = (2 ** 31 - 1, 65535, 65535)
PREFILL_ROWS = 64  # x rows per prefill block (csrc/int8_matmul.cu)


def _pieces(K, splits, cps):
    """[k0, k1) of each split, as the decode kernel walks them: split y
    takes the 64-wide chunks [y * cps, min((y + 1) * cps, n_chunks))."""
    n_chunks = -(-K // im.CHUNK_K)
    return [(y * cps * im.CHUNK_K,
             min(min((y + 1) * cps, n_chunks) * im.CHUNK_K, K))
            for y in range(splits)]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("K,N", MAIN_KN + RAGGED_KN)
@pytest.mark.parametrize("M", MS)
def test_int8_plan_tiles_splits_and_grid(M, K, N, sms):
    plan = im._int8_plan(M, K, N, sms)
    assert set(plan) == {"tile", "splits", "cps", "stages"}
    assert plan["tile"] == ("decode" if M <= 16 else "prefill")
    # The split-K pieces partition [0, K) in multiples of 32, none empty.
    pieces = _pieces(K, plan["splits"], plan["cps"])
    assert len(pieces) == plan["splits"] >= 1
    assert pieces[0][0] == 0 and pieces[-1][1] == K
    for (_, b), (c, _) in zip(pieces, pieces[1:]):
        assert b == c
    for a, b in pieces:
        assert a < b and a % 32 == 0 and (b % 32 == 0 or b == K)
    # The grid the C entry launches: 128 channels a block, then the splits
    # of K (decode) or 64 rows a block (prefill, which walks all of K).
    n_tiles = -(-N // im.TILE_N)
    if plan["tile"] == "decode":
        grid = (n_tiles, plan["splits"], 1)
        assert 1 <= plan["stages"] <= im.DECODE_MAX_STAGES
    else:
        grid = (n_tiles, -(-M // PREFILL_ROWS), 1)
        assert plan["splits"] == 1
    assert all(1 <= g <= lim for g, lim in zip(grid, GRID_MAX))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("K,N", MAIN_KN)
def test_int8_decode_plan_fills_the_card(K, N, sms):
    """At the decode step's shapes the split of K gives each warp a chunk
    of its own where the 128-channel tiles alone leave SMs idle, and no
    split where they fill the card (the LM head)."""
    plan = im._int8_plan(8, K, N, sms)
    n_tiles = -(-N // im.TILE_N)
    if n_tiles >= 2 * sms:
        assert plan["splits"] == 1
    else:
        assert plan["splits"] > 1
        assert plan["cps"] <= im.DECODE_WARPS
        assert n_tiles * plan["splits"] <= 2 * sms + n_tiles


def test_int8_plan_is_pure():
    assert im._int8_plan(8, 768, 2304, 132) == im._int8_plan(8, 768, 2304,
                                                             132)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B,T", [(1, 1), (2, 63), (2, 64), (2, 65),
                                 (2, 200), (1, 512), (1, 1024), (8, 1024)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plan_covers_every_row_once(B, T, causal, sms):
    """The q tile height the C entry takes (32 or 64), and the q tiles the
    kernel runs from it: grid row y takes tile n_qt - 1 - y under the
    causal mask (longest first), else tile y. Every q row once."""
    H = 12
    bq = fa._flash_bq(B, H, T, sms)
    assert bq in (32, 64)
    n_qt = -(-T // bq)
    order = [n_qt - 1 - y if causal else y for y in range(n_qt)]
    assert sorted(order) == list(range(n_qt))
    if causal:
        # Longest first: tile t walks the keys up to its last row.
        walks = [min(T, (t + 1) * bq) for t in order]
        assert walks == sorted(walks, reverse=True)
    rows = [t * bq + r for t in order for r in range(bq)]
    assert sorted(r for r in rows if r < T) == list(range(T))
    assert len(rows) - T < bq
    grid = (B * H, n_qt, 1)
    assert all(1 <= g <= lim for g, lim in zip(grid, GRID_MAX))


@pytest.mark.parametrize("sms", SMS)
def test_flash_plan_smaller_q_tile_for_small_grids(sms):
    """1 x 512 x 12 heads: 96 blocks of 64 rows would leave SMs idle; the
    training shape, 8 x 1024 x 12 heads, fills the card with 64."""
    assert fa._flash_bq(1, 12, 512, sms) == 32
    assert 12 * (512 // 32) >= sms
    assert fa._flash_bq(8, 12, 1024, sms) == 64


# The backward's shapes: the main paths' (prefill 1 x 512 and 1 x 1024,
# training 8 x 1024) and ragged ones, Tq != Tk included.
BWD_SHAPES = [(1, 512, 512), (1, 1024, 1024), (8, 1024, 1024), (1, 1, 1),
              (2, 63, 63), (2, 65, 65), (2, 200, 200), (2, 100, 37),
              (2, 37, 100), (3, 1000, 1000)]


def _bwd_tiles(T, rows, reverse):
    """The tiles of ``rows`` rows a backward grid runs, in launch order."""
    n = -(-T // rows)
    return [n - 1 - y if reverse else y for y in range(n)], n


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B,Tq,Tk", BWD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_plan_covers_every_row_and_key_once(B, Tq, Tk, D, dtype,
                                                      causal, sms):
    """The dq grid (q tiles in reverse under the causal mask) covers every
    q row once, the dk/dv grid (key tiles ascending) every key once, both
    within the card's grid limits, and under the causal mask each runs its
    longest tiles first: a dq tile walks the keys up to its last row, a
    dk/dv tile the q rows from its first key on."""
    H = 12
    plan = fa._flash_bwd_plan(B, H, Tq, Tk, D, getattr(torch, dtype), sms)
    assert set(plan) == {"dq_rows", "dkv_rows"}
    for key, T, reverse in (("dq_rows", Tq, causal), ("dkv_rows", Tk, False)):
        rows = plan[key]
        assert rows in ((32, 64, 128) if dtype == "float32" and D <= 64
                        else (32, 64))
        order, n = _bwd_tiles(T, rows, reverse)
        covered = [t * rows + r for t in order for r in range(rows)]
        assert sorted(r for r in covered if r < T) == list(range(T))
        assert len(covered) - T < rows
        assert all(1 <= g <= lim for g, lim in zip((B * H, n, 1), GRID_MAX))
        if causal and key == "dq_rows":
            walks = [min(Tk, (t + 1) * rows) for t in order]
            assert walks == sorted(walks, reverse=True)
        if causal and key == "dkv_rows":
            walks = [max(0, Tq - t * rows) for t in order]
            assert walks == sorted(walks, reverse=True)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_plan_fills_the_card(dtype, sms):
    """Every SM gets a block at the main paths' shapes: 1 x 512 x 12 heads
    (96 blocks of 64 rows) takes 32 rows (192 blocks), 1 x 1024 takes 64
    (192 blocks), and the training shape, 8 x 1024, the tallest tile: 128
    rows in f32 (768 blocks of 8 warps), 64 in bf16."""
    def plan(B, T):
        return fa._flash_bwd_plan(B, 12, T, T, 64, dtype, sms)

    assert plan(1, 512) == {"dq_rows": 32, "dkv_rows": 32}
    assert plan(1, 1024) == {"dq_rows": 64, "dkv_rows": 64}
    tall = 128 if dtype == torch.float32 else 64
    assert plan(8, 1024) == {"dq_rows": tall, "dkv_rows": tall}
    for B, T in ((1, 512), (1, 1024), (8, 1024)):
        rows = plan(B, T)["dq_rows"]
        assert B * 12 * -(-T // rows) >= sms


def test_flash_bwd_plan_is_pure():
    args = (8, 12, 1024, 1024, 64, torch.bfloat16, 132)
    assert fa._flash_bwd_plan(*args) == fa._flash_bwd_plan(*args)
    # f32 at D = 128: 128 rows would not fit a block's shared memory.
    assert fa._flash_bwd_plan(8, 12, 1024, 1024, 128, torch.float32,
                              132) == {"dq_rows": 64, "dkv_rows": 64}


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B,Tq,Tk", BWD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [384, 512, 640])
def test_wide_plans_cover_every_row_and_key_once(B, Tq, Tk, D, dtype, sms):
    """The wide-head kernels' plans (D > 256): f32 blocks of 32 rows; bf16
    forward and dq 64 q rows where the grid of B*H x ceil(T/64) blocks
    gives every SM one, else 32; dk/dv 32 keys. Every q row and key once,
    within the grid limits; grid.z holds the 512-column panels."""
    H = 12
    dt = getattr(torch, dtype)
    bq = fa._flash_bq(B, H, Tq, sms, D, dt)
    plan = fa._flash_bwd_plan(B, H, Tq, Tk, D, dt, sms)
    if dtype == "float32":
        assert bq == 32 and plan == {"dq_rows": 32, "dkv_rows": 32}
    else:
        assert bq == plan["dq_rows"] == (
            64 if B * H * -(-Tq // 64) >= sms else 32)
        assert plan["dkv_rows"] == 32
    for rows, T in ((bq, Tq), (plan["dq_rows"], Tq), (plan["dkv_rows"], Tk)):
        order, n = _bwd_tiles(T, rows, False)
        covered = [t * rows + r for t in order for r in range(rows)]
        assert sorted(r for r in covered if r < T) == list(range(T))
        assert len(covered) - T < rows
        assert all(1 <= g <= lim for g, lim in
                   zip((B * H, n, -(-D // 512)), GRID_MAX))
