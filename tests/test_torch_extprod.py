"""The wgmma product kernel's launch plan and register-A fragment map, on
the CPU (the kernel itself runs only on the card: tests/test_torch_cuda.py).

extprod_plan's split, through the kernel's grid and range formulas, must
cover every (output tile, limb, batch tile, contraction stage) of a step
exactly once and keep the card's SMs busy; at Karatsuba depth d > 0 every
(output tile, batch tile, leaf, stage of the leaf), with each output
quarter summing each of the leaves that feed it once. rotation_plan takes
the persistent kernel exactly where that split is > 1, on a grid of at most
one block an SM; its row-tile groups of blocks, their shares of a step
(stream-K cuts snapped to a leaf's end) and their rotdec walk cover every
stage and row once, each in its own tile's group, modelled from the
source's formulas. The fragment map is a
NumPy model of what csrc/blind_rotate.cu's extprod_kernel does: the
producer's key windows in shared memory (their order, offsets and bytes),
then each consumer lane's four A registers per limb and 32-byte k-step,
from the lane -> window-word and __byte_perm selector formulas of the
source (the upper rows' registers reused from the previous k-step inside a
key row), placed where wgmma's m64nNk32 register-A layout puts them. The
tiles it builds must be the transposed Toeplitz operator of the plain
product (ops.blind_rotate.toeplitz_operator, which ext_product_ref
contracts against), with zero rows past (k+1)*N.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from cufhe_tpu_torch import params as P
from cufhe_tpu_torch._build import H100_SMS
from cufhe_tpu_torch.ops import blind_rotate as BR
from cufhe_tpu_torch.ops.limbs import decomp_digit_limb_plan

SOURCE = (pathlib.Path(__file__).resolve().parent.parent / "cufhe_tpu_torch"
          / "csrc" / "blind_rotate.cu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Intra-op threads off while this module runs: the suite runs several
    worker processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cu_constants() -> dict:
    """The integer constants csrc/blind_rotate.cu states as literals."""
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", SOURCE.read_text())}


C = cu_constants()
WG_OUT, CONSUMERS, ROW_TILE = C["kWgOut"], C["kConsumers"], C["kRowTile"]
STAGE_K, GROUP = C["kStageK"], C["kGroup"]


def test_plan_tile_is_the_kernels():
    assert BR.EXTPROD_OUT_TILE == CONSUMERS * WG_OUT == 128
    assert BR.EXTPROD_ROW_TILE == ROW_TILE == 64
    assert BR.EXTPROD_STAGE_BYTES == STAGE_K == 128
    assert GROUP == 32 and WG_OUT == 2 * GROUP


def _digit_rows(kp1: int) -> int:
    """I at l = 3, nd = 1: the plan's contraction, I*N bytes."""
    return kp1 * 3


def kernel_stages(N: int, I: int, depth: int = 0) -> int:
    """extprod_kernel's T: the step's contraction stages, S a leaf times
    3^depth leaves."""
    LN = N >> depth
    return (I * LN + STAGE_K - 1) // STAGE_K * 3 ** depth


def kernel_tiles(B: int, N: int, kp1: int, depth: int = 0) -> tuple:
    """The grid's x and y in rotate: output tiles of a leaf, batch
    tiles."""
    out_tile = CONSUMERS * WG_OUT
    LN = N >> depth
    return ((kp1 * LN + out_tile - 1) // out_tile,
            (B + ROW_TILE - 1) // ROW_TILE)


def kernel_ranges(stages: int, split: int) -> list:
    """[s0, s1) of the stages block z sums: extprod_kernel's z*T/Z and
    (z+1)*T/Z."""
    return [(z * stages // split, (z + 1) * stages // split)
            for z in range(split)]


def test_grid_and_range_formulas_are_the_kernels():
    """kernel_stages, kernel_tiles and kernel_ranges are the source's."""
    src = re.sub(r"\s+", " ", SOURCE.read_text())
    for text in (
            "st.LN = N >> D;",
            "st.KB = I * st.LN;",
            "st.S = (st.KB + kStageK - 1) / kStageK;",
            "st.T = st.S * pow3(D);",
            "it.go0 = x * kOutTile;",
            "it.b0 = y * kRowTile;",
            "it.s0 = s0;",
            "it.s1 = s1;",
            "ext_item<SEG>( st, blockIdx.x, blockIdx.y, "
            "static_cast<int>(static_cast<long long>(blockIdx.z) * st.T / "
            "gridDim.z), "
            "static_cast<int>(static_cast<long long>(blockIdx.z + 1) * st.T / "
            "gridDim.z));",
            "const int v = D > 0 ? s / st.S : 0;",
            "leaf_quarters(s / st.S, D)",
            "if (s + 1 == it.s1 || (s + 1) % st.S == 0) {",
            "const int LN = N >> D; const EncodeTiled fn",
            "const dim3 ext_grid((kp1 * LN + kOutTile - 1) / kOutTile, "
            "(B + kRowTile - 1) / kRowTile, split);",
            "constexpr int kOutTile = kConsumers * kWgOut;"):
        assert text in src, text


@pytest.mark.parametrize("B", [1, 63, 65, 129, 4096])
@pytest.mark.parametrize("nlimbs", [3, 4])
@pytest.mark.parametrize("kp1", [2, 3])
@pytest.mark.parametrize("N", [32, 64, 128, 512, 1024, 2048])
def test_plan_covers_every_block_once(N, kp1, nlimbs, B):
    I = _digit_rows(kp1)
    split = BR.extprod_plan(B, N, kp1, I)
    stages = kernel_stages(N, I)
    assert 1 <= split <= stages
    nx, ny = kernel_tiles(B, N, kp1)
    out_tile = CONSUMERS * WG_OUT
    assert (nx - 1) * out_tile < kp1 * N <= nx * out_tile
    assert (ny - 1) * ROW_TILE < B <= ny * ROW_TILE
    ranges = kernel_ranges(stages, split)
    assert all(lo < hi for lo, hi in ranges)
    seen = {}
    for x in range(nx):
        for y in range(ny):
            for lo, hi in ranges:
                for s in range(lo, hi):
                    for li in range(nlimbs):   # a block sums every limb
                        seen[x, y, li, s] = seen.get((x, y, li, s), 0) + 1
    assert set(seen.values()) == {1}
    assert len(seen) == nx * ny * nlimbs * stages
    if nx * ny >= H100_SMS:
        assert split == 1        # a full card needs no split


@pytest.mark.parametrize("B", [1, 4096])
def test_plan_fills_the_card_at_tfhepp_128bit(B):
    lp = P.TFHEPP_128.lvl1
    I = (lp.k + 1) * lp.l * decomp_digit_limb_plan(lp.Bgbit)[0]
    split = BR.extprod_plan(B, lp.n, lp.k + 1, I)
    nx, ny = kernel_tiles(B, lp.n, lp.k + 1)
    assert nx * ny * split >= H100_SMS
    assert (split > 1) == (B == 1)


def quarters_model(v: int, depth: int) -> list:
    """The output quarters leaf v feeds, from the Karatsuba identity:
    [[A, T01], [T10, A]] (x_l, x_r) = (A(x_l + x_r) + (T01 - A) x_r,
    A(x_l + x_r) + (T10 - A) x_l) at each level, leaf digits 0, 1, 2."""
    if depth == 0:
        return [0]
    digit, rest = divmod(v, 3 ** (depth - 1))
    halves = {0: (0, 1), 1: (0,), 2: (1,)}[digit]
    sub = quarters_model(rest, depth - 1)
    return sorted(h * 2 ** (depth - 1) + q for h in halves for q in sub)


def test_leaf_quarters_are_the_kernels_and_the_models():
    """ops.blind_rotate.leaf_quarters, the kernel's leaf_quarters (the
    source's rule) and the model agree; every quarter is fed by 2^d
    leaves, 4^d leaf-quarter pairs in all (the schoolbook's blocks)."""
    src = re.sub(r"\s+", " ", SOURCE.read_text())
    assert "if (digit != 2) next |= 1u << (2 * q);" in src
    assert "if (digit != 1) next |= 1u << (2 * q + 1);" in src
    for depth in range(3):
        per_q = {}
        for v in range(3 ** depth):
            got = BR.leaf_quarters(v, depth)
            assert got == quarters_model(v, depth)
            for q in got:
                per_q[q] = per_q.get(q, 0) + 1
        assert per_q == {q: 2 ** depth for q in range(2 ** depth)}
    # prefix order: the root's A first, feeding every quarter
    assert BR.leaf_quarters(0, 2) == [0, 1, 2, 3]
    assert [BR.leaf_quarters(v, 2) for v in range(1, 9)] == [
        [0, 2], [1, 3], [0, 1], [0], [1], [2, 3], [2], [3]]


@pytest.mark.parametrize("B", [1, 63, 64, 65, 4096])
@pytest.mark.parametrize("kp1", [2, 3])
@pytest.mark.parametrize("N,depth", [(256, 1), (512, 1), (512, 2),
                                     (1024, 1), (1024, 2), (2048, 2)])
def test_plan_covers_every_leaf_block_once(N, depth, kp1, B):
    """At depth d the kernel's ranges cover every (output tile, batch
    tile, leaf, stage of the leaf) once, and each output quarter of each
    tile sums every stage of each leaf that feeds it exactly once across
    the ranges (each range flushes the quarters it touched); a split
    range lies inside one leaf."""
    I = _digit_rows(kp1)
    split = BR.extprod_plan(B, N, kp1, I, depth=depth)
    stages = kernel_stages(N, I, depth)
    S = stages // 3 ** depth
    assert S * 3 ** depth == stages and 1 <= split <= stages
    nx, ny = kernel_tiles(B, N, kp1, depth)
    assert nx * STAGE_K == kp1 * (N >> depth)
    ranges = kernel_ranges(stages, split)
    assert all(lo < hi for lo, hi in ranges)
    if split > 1:              # no range straddles two leaves
        assert split % 3 ** depth == 0
        assert all((lo // S) == (hi - 1) // S for lo, hi in ranges)
    seen, fed = {}, {}
    for lo, hi in ranges:
        for s in range(lo, hi):
            v, sv = divmod(s, S)
            seen[v, sv] = seen.get((v, sv), 0) + 1
            for q in BR.leaf_quarters(v, depth):
                fed[q, v, sv] = fed.get((q, v, sv), 0) + 1
    assert set(seen.values()) == {1} and len(seen) == stages
    assert set(fed.values()) == {1}
    assert len(fed) == 4 ** depth * S
    if nx * ny >= H100_SMS:
        assert split == 1
    else:              # the least waves x (stages a range + overhead)
        def cost(z):
            return (-(-nx * ny * z // H100_SMS)
                    * (-(-stages // z) + BR.EXTPROD_LEAF_BLOCK_OVERHEAD))
        assert all(cost(split) <= cost(z)
                   for z in [1, *range(3 ** depth, stages + 1, 3 ** depth)])


@pytest.mark.parametrize("B,split_over_1", [(1, True), (64, True),
                                            (4096, False)])
def test_leaf_plan_at_tfhepp_128bit(B, split_over_1):
    """Depth 2 at tfhepp_128bit: 4 output tiles (512 leaf outputs) x
    ceil(B/64) batch tiles, each block 9 leaves x 12 stages; 4096 rows
    fill the card with 256 blocks, 1 and 64 rows split the 108 stages
    into 27 ranges of 4 (108 blocks, one wave)."""
    params = P.TFHEPP_128
    lp = params.lvl1
    depth = BR.kar_depth(params)
    I = (lp.k + 1) * lp.l
    assert depth == 2 and kernel_stages(lp.n, I, depth) == 9 * 12
    split = BR.extprod_plan(B, lp.n, lp.k + 1, I, depth=depth)
    nx, ny = kernel_tiles(B, lp.n, lp.k + 1, depth)
    assert (nx, ny) == (4, -(-B // 64))
    assert (split > 1) == split_over_1
    assert split == (27 if split_over_1 else 1)


# -- the persistent rotation's launch and walk ------------------------------

def _digit_rows_of(params) -> int:
    """I = (k+1) l nd of a set."""
    lp = params.lvl1
    return (lp.k + 1) * lp.l * decomp_digit_limb_plan(lp.Bgbit)[0]


#: (set, key limbs, Karatsuba depth): every depth from the set's own (at
#: that limb count) down to 0, as the tests and benchmarks.rotation run them
PATH_CASES = [(p, nl, d) for p in P.PRESETS.values() for nl in (4, 3)
              if nl == 4 or p.lvl1.n >= BR.PALLAS3_MIN_N
              for d in range(BR.kar_depth(p, nl) + 1)]
#: batch sizes the path choice is checked at: every row count to 64, then
#: every 7th and the edges of each batch tile to 4096
PATH_ROWS = sorted(set(range(1, 65)) | set(range(65, 4097, 7))
                   | {64 * t + e for t in range(1, 65) for e in (0, 1)})


@pytest.mark.parametrize(
    "params,nlimbs,depth", PATH_CASES,
    ids=[f"{p.name}-limbs{nl}-d{d}" for p, nl, d in PATH_CASES])
def test_persistent_path_is_where_the_plan_splits(params, nlimbs, depth):
    """rotation_plan takes the persistent kernel exactly where extprod_plan
    splits the contraction, with a grid of one block an SM, or one a stage
    of the step's tiles x stages where that is fewer; the loop (grid 0)
    elsewhere."""
    lp = params.lvl1
    N, kp1, I = lp.n, lp.k + 1, _digit_rows_of(params)
    for B in PATH_ROWS:
        split, grid = BR.rotation_plan(B, N, kp1, I, H100_SMS, depth)
        assert split == BR.extprod_plan(B, N, kp1, I, H100_SMS, depth)
        assert (grid > 0) == (split > 1), B
        if grid:
            nx, ny = kernel_tiles(B, N, kp1, depth)
            units = nx * ny * kernel_stages(N, I, depth)
            assert grid == min(units, H100_SMS), B
            assert nx * ny < H100_SMS         # the tiles leave SMs idle


@pytest.mark.parametrize("params", [P.TFHEPP_128, P.CONCRETE],
                         ids=lambda p: p.name)
def test_nand_cells_take_the_loop(params):
    """Both NAND cells' 4096 rows fill the card: split 1, the loop of
    2 n0 launches; AES's 48 to 480 rows at tfhepp_128bit take the
    persistent kernel."""
    lp = params.lvl1
    plan = BR.rotation_plan(4096, lp.n, lp.k + 1, _digit_rows_of(params),
                            H100_SMS, BR.kar_depth(params))
    assert plan == (1, 0)
    if params is P.TFHEPP_128:
        for B in (1, 48, 160, 480):
            assert BR.rotation_plan(B, lp.n, lp.k + 1, _digit_rows_of(params),
                                    H100_SMS, 2)[1] > 0


@pytest.mark.parametrize("sms", [1, 16, 78, 114, 132, 144])
def test_persistent_grid_never_exceeds_the_sms(sms):
    """On a card of any SM count the cooperative grid is at most one block
    an SM (every block resident, as grid_sync needs) and at least one."""
    for params in P.PRESETS.values():
        lp = params.lvl1
        N, kp1, I = lp.n, lp.k + 1, _digit_rows_of(params)
        for B in (1, 7, 48, 64, 65, 160, 480, 1024, 4096):
            split, grid = BR.rotation_plan(B, N, kp1, I, sms,
                                           BR.kar_depth(params))
            assert 0 <= grid <= sms
            assert (grid > 0) == (split > 1)


def rotdec_rows_a_block(N: int, depth: int) -> int:
    """rotdec_plan's rows a block (of kRotThreads threads, 1 << tpr_log a
    row), from the source's rule."""
    nbit = N.bit_length() - 1
    tpr_log = nbit - 2 - depth
    while (1 << tpr_log) > C["kRotThreads"] or (
            tpr_log > 0 and (1 << (nbit - 2 - tpr_log)) < C["kRotQuads"]):
        tpr_log -= 1
    return C["kRotThreads"] >> tpr_log


def test_persistent_walk_formulas_are_the_kernels():
    """The walk modelled below is the source's: the grid cut into
    min(ny, G) row-tile groups, sizes one apart, each owning a run of row
    tiles (tile_group, written once to shared memory); each block's share
    of its group's tiles x stages, tile-major, cut equally between the
    group's blocks, each cut moved to a leaf's end within kShareSnap
    stages (for_share, share_cut) and walked item by item; rotdec's blocks over the group's rows alone, its pointers
    moved to the group's first row, strided by the group's size; two
    group_sync a step on the group's counter, each waiting for the group's
    size more arrivals."""
    src = re.sub(r"\s+", " ", SOURCE.read_text())
    for text in (
            "const int nx = (st.kp1 * st.LN + kOutTile - 1) / kOutTile;",
            "const int ny = (st.B + kRowTile - 1) / kRowTile;",
            "__shared__ TileGroup tg;",
            "if (tid == 0) tg = tile_group(ny);",
            "const int G = gridDim.x, b = blockIdx.x;",
            "const int n = min(ny, G);",
            "tg.g = ((b + 1) * n - 1) / G;",
            "const int first = tg.g * G / n;",
            "tg.rank = b - first;",
            "tg.size = (tg.g + 1) * G / n - first;",
            "tg.y0 = tg.g * ny / n;",
            "tg.y1 = (tg.g + 1) * ny / n;",
            "const int y0 = tg.y0;",
            "const int units = nx * (tg.y1 - y0) * st.T;",
            "const int u1 = share_cut(units, st.S, tg.rank + 1, tg.size);",
            "for (int u = share_cut(units, st.S, tg.rank, tg.size); u < u1;) {",
            "const int u = static_cast<int>(static_cast<long long>(units) * b "
            "/ size);",
            "const int r = u % S;",
            "return r <= kShareSnap ? u - r : S - r <= kShareSnap ? u + S - r "
            ": u;",
            "const int tile = u / st.T;",
            "const int t0 = tile * st.T;",
            "const int s1 = min(st.T, u1 - t0);",
            "fn(ext_item<SEG>(st, tile % nx, y0 + tile / nx, u - t0, s1));",
            "u = t0 + s1;",
            # rotdec on the group's rows alone, rotdec_rows unchanged
            "const int b0 = tg.y0 * kRowTile;",
            "ra.nrows = (min(st.B, tg.y1 * kRowTile) - b0) * st.kp1;",
            "const int rows = kRotThreads >> ra.tpr_log;",
            "for (int blk = tg.rank; blk < (ra.nrows + rows - 1) / rows; "
            "blk += tg.size) {",
            "rotdec_rows<L, ND, D>( "
            "acc + static_cast<size_t>(b0) * st.kp1 * st.N, "
            "abar + static_cast<size_t>(i) * a.B + b0, "
            "dec + static_cast<size_t>(b0) * E::kLeaves * st.KB, ra, blk, tid,",
            "const int row0 = blk * rows;",
            "const int here = min(rows, a.nrows - row0);",
            "return (B * kp1 + plan.rows - 1) / plan.rows;",
            "int tpr_log = nbit - 2 - depth;",
            "} while (seen < target);"):
        assert text in src, text
    # each role passes group_sync twice a step on the group's counter, the
    # targets rising by the group's size each time: the producer
    # warpgroup and the consumers, so the block's barriers pair up; both
    # walk for_share
    for j in (1, 2):
        assert src.count(
            f"group_sync(arrivals + tg.g * kArrivalStride, "
            f"tg.size * (2 * i + {j}));") == 2
    assert "grid_sync" not in src
    assert src.count("for_share<SEG>(st, nx, tg, [&](const ExtItem& it) {") \
        == 2
    assert BR.ARRIVAL_STRIDE == C["kArrivalStride"]


def share_cut(units: int, S: int, b: int, size: int) -> int:
    """share_cut: cut b of a group of `size` blocks at b/size of the
    units, moved to the nearest multiple of S within kShareSnap."""
    u = units * b // size
    r, snap = u % S, C["kShareSnap"]
    return u - r if r <= snap else u + S - r if S - r <= snap else u


def tile_group(blk: int, grid: int, ny: int) -> tuple:
    """tile_group: (group, rank, size, y0, y1) of block blk."""
    n = min(ny, grid)
    g = ((blk + 1) * n - 1) // grid
    first = g * grid // n
    return (g, blk - first, (g + 1) * grid // n - first, g * ny // n,
            (g + 1) * ny // n)


def share_items(rank: int, size: int, nx: int, y0: int, y1: int, T: int,
                S: int) -> list:
    """for_share's items of the block of rank `rank` in a group of `size`
    blocks owning row tiles [y0, y1): (x, y, s0, s1) in order."""
    units = nx * (y1 - y0) * T
    u, u1 = (share_cut(units, S, rank, size),
             share_cut(units, S, rank + 1, size))
    out = []
    while u < u1:
        tile = u // T
        t0 = tile * T
        s0, s1 = u - t0, min(T, u1 - t0)
        out.append((tile % nx, y0 + tile // nx, s0, s1))
        u = t0 + s1
    return out


def _published_walk_cases() -> list:
    """Every published set at its own depth at the AES-like and edge row
    counts where rotation_plan takes the persistent kernel on an H100."""
    out = []
    for params in (P.TFHEPP_128, P.TFHEPP_128_BG8, P.TFHEPP_80, P.CGGI19,
                   P.CONCRETE):
        lp = params.lvl1
        depth = BR.kar_depth(params)
        for B in (1, 48, 64, 65, 128, 160, 320, 480, 1408):
            if BR.rotation_plan(B, lp.n, lp.k + 1, _digit_rows_of(params),
                                H100_SMS, depth)[1]:
                out.append((params, 4, depth, B, None))
    return out


#: cases whose shares in a group lie within 1 + 2 kShareSnap stages of
#: each other (the rule allows 1 + 4 kShareSnap: each of a share's two cuts
#: moves up to kShareSnap)
TIGHT_WALK_CASES = [(P.TFHEPP_128, 4, 2, B, None)
                    for B in (1, 48, 63, 64, 65, 160, 480, 1408)] + \
    [(P.CONCRETE, 4, 0, B, None) for B in (1, 160, 640)] + \
    [(P.CGGI19, 4, 1, 48, None), (P.TFHEPP_128, 3, 0, 160, None),
     (P.TINY_K2, 4, 0, 3, None), (P.PALLAS_KAR, 4, 2, 129, None)]
WALK_CASES = TIGHT_WALK_CASES + [c for c in _published_walk_cases()
                                 if c not in TIGHT_WALK_CASES]
#: grids below the plan's, as the tests and benchmarks may force: fewer
#: blocks than row tiles, one block; TINY_K2's rotdec blocks (128 rows)
#: straddle its 192-row tiles
WALK_CASES += [(P.TFHEPP_128, 4, 2, 480, 5), (P.TFHEPP_128, 4, 2, 300, 1),
               (P.CONCRETE, 4, 0, 640, 7), (P.TINY_K2, 4, 0, 1000, 132),
               (P.TINY_K2, 4, 0, 1000, 3)]


def _walk_id(case) -> str:
    p, nl, d, B, grid = case
    return f"{p.name}-limbs{nl}-d{d}-B{B}" + (f"-grid{grid}" if grid else "")


@pytest.mark.parametrize("params,nlimbs,depth,B,grid", WALK_CASES,
                         ids=[_walk_id(c) for c in WALK_CASES])
def test_persistent_walk_covers_every_item_once(params, nlimbs, depth, B,
                                                grid):
    """In a step of the persistent kernel every block is in one row-tile
    group, the groups' sizes one apart; the blocks' shares take every
    (output tile, batch tile, limb, stage) of the step once, and only the
    group owning the batch tile takes it; each block within 1 + 2
    kShareSnap stages of the others in its group, each item inside one
    tile; every leaf a range cuts is folded at its end (the consumer's
    rule), so each output quarter sums each stage of each leaf that feeds
    it once. The rotdec walk takes every row (b, j) once, in the group
    owning b's tile. Each group's counter targets rise by its size at each
    of the 2 n0 barriers and stay inside 32 bits; the groups are
    persistent_groups'. grid None is rotation_plan's. A share is within
    1 + 4 kShareSnap stages of the others (each of its two cuts moves up
    to kShareSnap), within 1 + 2 kShareSnap in TIGHT_WALK_CASES."""
    lp = params.lvl1
    N, kp1, I = lp.n, lp.k + 1, _digit_rows_of(params)
    tight = (params, nlimbs, depth, B, grid) in TIGHT_WALK_CASES
    split, planned = BR.rotation_plan(B, N, kp1, I, H100_SMS, depth)
    if grid is None:
        assert split > 1 and planned > 0
        grid = planned
    nx, ny = kernel_tiles(B, N, kp1, depth)
    T = kernel_stages(N, I, depth)
    S = T // 3 ** depth
    groups = [tile_group(blk, grid, ny) for blk in range(grid)]
    n = BR.persistent_groups(B, grid)
    assert n == min(ny, grid) and {g for g, *_ in groups} == set(range(n))
    sizes = {g: size for g, _, size, _, _ in groups}
    assert max(sizes.values()) - min(sizes.values()) <= 1
    assert sum(sizes.values()) == grid
    for g in range(n):
        members = sorted((rank, size, y0, y1) for gg, rank, size, y0, y1
                         in groups if gg == g)
        assert [m[0] for m in members] == list(range(sizes[g]))
        assert len({m[1:] for m in members}) == 1
    owner = {}
    for g, _, _, y0, y1 in groups:
        for y in range(y0, y1):
            assert owner.setdefault(y, g) == g
    assert sorted(owner) == list(range(ny))
    seen, fed, work = {}, {}, {}
    for g, rank, size, y0, y1 in groups:
        items = share_items(rank, size, nx, y0, y1, T, S)
        work.setdefault(g, []).append(sum(s1 - s0 for *_, s0, s1 in items))
        for x, y, s0, s1 in items:
            assert 0 <= s0 < s1 <= T and x < nx and y0 <= y < y1
            assert owner[y] == g
            folds = [s for s in range(s0, s1) if s + 1 == s1
                     or (s + 1) % S == 0]
            for s in range(s0, s1):
                for li in range(nlimbs):
                    seen[x, y, li, s] = seen.get((x, y, li, s), 0) + 1
                # the stage's leaf sums land at the next fold, in the
                # quarters its leaf feeds
                fold = min(f for f in folds if f >= s)
                assert fold // S == s // S
                for q in BR.leaf_quarters(s // S, depth):
                    fed[x, y, q, s] = fed.get((x, y, q, s), 0) + 1
    assert set(seen.values()) == {1}
    assert len(seen) == nx * ny * nlimbs * T
    assert set(fed.values()) == {1}
    assert len(fed) == nx * ny * 2 ** depth * 2 ** depth * S
    for w in work.values():
        assert max(w) - min(w) <= 1 + (2 if tight else 4) * C["kShareSnap"]
    # rotdec: the group's rows (b, j) from b0 = 64 y0 on, rotdec_rows'
    # blocks of `rows` rows relative to it, strided by the group's size
    rows = rotdec_rows_a_block(N, depth)
    covered = {}
    for g, rank, size, y0, y1 in groups:
        b0 = ROW_TILE * y0
        nrows = (min(B, ROW_TILE * y1) - b0) * kp1
        for rb in range(rank, -(-nrows // rows), size):
            for rel in range(rb * rows, min((rb + 1) * rows, nrows)):
                row = b0 * kp1 + rel
                assert owner[row // kp1 // ROW_TILE] == g
                covered[row] = covered.get(row, 0) + 1
    assert set(covered.values()) == {1} and len(covered) == B * kp1
    targets = [max(sizes.values()) * (j + 1)
               for j in range(2 * params.lvl0.dim)]
    assert targets[-1] < 2 ** 32


# -- the kernel's fragment map, as a model --------------------------------

def byte_perm(x, y, sel):
    """__byte_perm(x, y, sel): byte i of the result is byte sel[4i:4i+3]
    of the eight bytes y:x (x the low word); elementwise on arrays."""
    b = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(np.shape(b), dtype=np.uint64)
    for i in range(4):
        nib = ((sel >> (4 * i)) & 7).astype(np.uint64)
        out |= ((b >> (np.uint64(8) * nib)) & np.uint64(0xFF)) \
            << np.uint64(8 * i)
    return out.astype(np.uint32)


def seg_bytes(N: int) -> int:
    """extprod_kernel's SEG: contraction bytes of one key row a stage."""
    return min(N, STAGE_K)


def stage_windows(bk_i, N, kp1, I, x, s, fill):
    """The producer's key windows of stage s in block x: {wi: the window's
    kWinStride bytes}, garbage `fill` where the kernel copies nothing (the
    16 trailing bytes, runs past (k+1)*N or key rows past I), and the
    bytes the stage's barrier expects beside the dec tile."""
    NL = bk_i.shape[2]
    SEG = seg_bytes(N)
    runs_all = CONSUMERS * WG_OUT // SEG
    win, stride = 2 * SEG, 2 * SEG + 16
    segs_all = STAGE_K // SEG
    KB = I * N
    segs = min(segs_all, -(-(KB - s * STAGE_K) // SEG))
    go0 = x * CONSUMERS * WG_OUT
    runs = min(runs_all, (kp1 * N - go0) // SEG)
    out, copied = {}, 0
    for wi in range(segs_all * runs_all * NL):
        li, run, seg = wi % NL, wi // NL % runs_all, wi // NL // runs_all
        buf = np.full(stride, fill, dtype=np.uint8)
        if seg < segs and run < runs:
            p = s * STAGE_K + seg * SEG
            r, t0 = divmod(p, N)
            o, c0 = divmod(go0 + SEG * run, N)
            start = N + c0 - t0 - SEG
            assert start % 16 == 0 and 0 <= start and start + win <= 2 * N
            buf[:win] = bk_i[r, o, li, start:start + win].view(np.uint8)
            copied += win
        out[wi] = buf
    assert copied == segs * runs * NL * win
    return out, copied


def a_tiles(bk_i, N, kp1, I, x, s, fill=0x5A):
    """The A operand extprod_kernel's consumer warpgroups hand wgmma in
    stage s of block x: [consumers, NL, k-steps, 64 rows, 32 bytes] int8,
    from the registers each lane builds."""
    NL = bk_i.shape[2]
    SEG = seg_bytes(N)
    runs_all = CONSUMERS * WG_OUT // SEG
    kW = (2 * SEG + 16) // 4
    windows, _ = stage_windows(bk_i, N, kp1, I, x, s, fill)
    words = np.concatenate([windows[wi] for wi in sorted(windows)]
                           ).view("<u4")
    groups = min(CONSUMERS * WG_OUT // GROUP,
                 (kp1 * N - x * CONSUMERS * WG_OUT) // GROUP)
    warp = np.arange(4)[:, None]
    lane = np.arange(32)[None, :]
    g, q = lane >> 2, lane & 3
    sh = (g + 1) & 3
    sel = (sh + 3) | ((sh + 2) << 4) | ((sh + 1) << 8) | (sh << 12)
    m0 = 2 * warp + SEG // 4 - q + ((g + 1) >> 2) - 1
    tiles = np.zeros((CONSUMERS, NL, STAGE_K // 32, 64, 32), dtype=np.int8)
    for wg in range(CONSUMERS):
        lo_ok, hi_ok = 2 * wg < groups, 2 * wg + 1 < groups
        # each row group's window: run u0 // SEG, from word u0 % SEG / 4
        at = [(u0 // SEG) * NL * kW + u0 % SEG // 4 + m0
              for u0 in (WG_OUT * wg, WG_OUT * wg + GROUP)]
        before = None
        for kk in range(STAGE_K // 32):
            seg, kq = divmod(kk, SEG // 32)
            f = {}
            for li in range(NL):
                w0 = (seg * runs_all * NL + li) * kW - 8 * kq
                ml, mh = w0 + at[0], w0 + at[1]
                zero = np.zeros(m0.shape, dtype=np.uint32)
                f[li, 0] = (byte_perm(words[ml], words[ml + 1], sel)
                            if lo_ok else zero)
                f[li, 2] = (byte_perm(words[ml - 4], words[ml - 3], sel)
                            if lo_ok else zero)
                if kq > 0:
                    f[li, 1], f[li, 3] = before[li, 0], before[li, 2]
                else:
                    f[li, 1] = (byte_perm(words[mh], words[mh + 1], sel)
                                if hi_ok else zero)
                    f[li, 3] = (byte_perm(words[mh - 4], words[mh - 3], sel)
                                if hi_ok else zero)
            before = f
            # wgmma's register A (m64nNk32, 8-bit): register 2*h2 + hi of
            # lane (g, q) in warp w holds row 16w + g + 8*hi, bytes
            # 16*h2 + 4q .. +3
            for li in range(NL):
                for reg in range(4):
                    h2, hi = divmod(reg, 2)
                    vals = f[li, reg].view(np.uint8).reshape(4, 32, 4)
                    for w in range(4):
                        for ln in range(32):
                            row = 16 * w + (ln >> 2) + 8 * hi
                            k = 16 * h2 + 4 * (ln & 3)
                            tiles[wg, li, kk, row, k:k + 4] = \
                                vals[w, ln].view(np.int8)
    return tiles


def _random_bk_i(params, nlimbs, seed, depth=0):
    """One step of the key layout on a random BK [1, (k+1)l, k+1, N] at
    Karatsuba depth `depth` (prepare_bk_ext's at the set's own depth)."""
    lp = params.lvl1
    bk = np.random.default_rng(seed).integers(
        0, 1 << 32, (1, (lp.k + 1) * lp.l, lp.k + 1, lp.n),
        dtype=np.uint64).astype(np.uint32)
    return BR.prepare_bk_ext(torch.from_numpy(bk.view(np.int32)), params,
                             nlimbs, depth)[0].numpy()


@pytest.mark.parametrize("params,nlimbs,blocks", [
    (P.TINY_K2, 4, None),          # N = 32: a stage is 4 key rows, 96
    (P.TINY, 4, None),             # outputs (rows 96-127 masked); N = 64
    (P.PALLAS_TINY, 4, None),
    (P.PALLAS_TINY, 3, None),
    (P.PALLAS_TINY_K2, 3, None),   # k = 2: 384 outputs, 3 column tiles
    (P.PALLAS_KAR, 4, ((1, 3), (3, 0))),
    (P.TFHEPP_128, 4, ((0, 7), (15, 47))),
    (P.TFHEPP_128, 3, ((9, 0), (15, 8))),
], ids=lambda v: getattr(v, "name", str(v)))
def test_fragment_model_rebuilds_the_toeplitz_operator(params, nlimbs,
                                                      blocks):
    lp = params.lvl1
    _check_fragments(_random_bk_i(params, nlimbs, 61), lp.n, lp.k + 1,
                     blocks)


@pytest.mark.parametrize("params,leaves,blocks", [
    (P.PALLAS_KAR, (0, 4, 8), None),            # leaves of 128
    (P.TFHEPP_128, (0, 5, 7), ((0, 3), (3, 11))),   # leaves of 256
], ids=lambda v: getattr(v, "name", str(v)))
def test_fragment_model_rebuilds_each_leaf_operator(params, leaves, blocks):
    """At Karatsuba depth 2 the producer reads leaf v's windows at
    2 LN v of each key row of 3^d * 2 LN bytes; the consumer's fragments
    of those windows are the leaf generator's Toeplitz operator, the
    depth-0 map at N = LN."""
    lp = params.lvl1
    depth = BR.kar_depth(params)
    LN = lp.n >> depth
    bk_i = _random_bk_i(params, 4, 62, depth)
    assert bk_i.shape[-1] == 3 ** depth * 2 * LN
    src = re.sub(r"\s+", " ", SOURCE.read_text())
    assert ("((static_cast<size_t>(r) * kp1 + o) * NL + li) * E::kLeaves "
            "* 2 * LN + 2 * LN * v + (LN + c0 - t0 - SEG);") in src
    for v in leaves:
        leaf = np.ascontiguousarray(bk_i[..., 2 * LN * v:2 * LN * (v + 1)])
        _check_fragments(leaf, LN, lp.k + 1, blocks)


def _check_fragments(bk_i, N, kp1, blocks):
    """The A tiles of a_tiles at blocks [(x, s)] (every block where None)
    are the transposed Toeplitz operator of bk_i [I, kp1, NL, 2N], with
    zero rows past kp1*N."""
    I = bk_i.shape[0]
    T = BR.toeplitz_operator(torch.from_numpy(bk_i)).numpy()
    if blocks is None:
        blocks = [(x, s) for x in range(kernel_tiles(1, N, kp1)[0])
                  for s in range(kernel_stages(N, I))]
    outs, KB = kp1 * N, I * N
    for x, s in blocks:
        tiles = a_tiles(bk_i, N, kp1, I, x, s)
        for wg in range(CONSUMERS):
            for kk in range(STAGE_K // 32):
                p0 = s * STAGE_K + 32 * kk
                cols = min(32, max(0, KB - p0))   # B is zero past I*N
                for row in range(64):
                    w, rem = divmod(row, 16)
                    hi, g = divmod(rem, 8)
                    go = (x * CONSUMERS * WG_OUT + WG_OUT * wg + GROUP * hi
                          + 8 * w + g)
                    got = tiles[wg, :, kk, row, :cols]
                    if go >= outs:
                        assert not got.any(), (x, s, wg, kk, row)
                        continue
                    want = T[:, p0:p0 + cols, go]
                    assert np.array_equal(got, want), (x, s, wg, kk, row)


def test_fragment_model_reads_inside_each_window():
    """The words a lane reads, m-4 .. m+1 at every k-step of a key row,
    lie inside its window's kWinStride bytes, and the lanes together
    read from its first byte."""
    for N in (32, 64, 128, 1024):
        SEG = seg_bytes(N)
        stride = 2 * SEG + 16
        lows, highs = [], []
        for u0 in range(0, CONSUMERS * WG_OUT, GROUP):
            for warp in range(4):
                for lane in range(32):
                    g, q = lane >> 2, lane & 3
                    m0 = 2 * warp + SEG // 4 - q + ((g + 1) >> 2) - 1
                    for kq in range(SEG // 32):
                        m = u0 % SEG // 4 + m0 - 8 * kq
                        lows.append(4 * (m - 4))
                        highs.append(4 * (m + 2) - 1)
        assert min(lows) == 0 and max(highs) < stride
