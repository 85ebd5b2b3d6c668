"""The n0-step blind rotation: the counterpart of cufhe_tpu/ops/pallas_br.py.

    acc <- acc + ExtProd(BK_i, Decomp(acc * X^abar_i - acc + offset))  mod 2^32

for i = 0 .. n0-1, batched over B accumulators [B, k+1, N].

Two versions of the same function live here:

* blind_rotate_ref, plain PyTorch: rotate, decompose (rotdec_ref) and a
  materialised negacyclic Toeplitz product per step, built from the key
  windows the kernel reads. Exact on the CPU and on CUDA.
* blind_rotate_cuda, the hand-written CUDA kernels (csrc/blind_rotate.cu),
  reading the key in the layout prepare_bk_ext builds. The product kernel
  runs on wgmma; extprod_plan chooses how many ranges its contraction is
  cut into, and the C entry takes that split. rotation_plan chooses the
  launch: where the split is 1, two kernels a step (rotdec_kernel, then
  extprod_kernel); where the batch is too small to fill the card and the
  contraction is split, one cooperative launch of
  persistent_extprod_kernel that walks all n0 steps.

Both take the key at four limbs (the exact path) or three (the reduced-
precision `pallas3` path of the JAX package: the lowest of the four
balanced limbs dropped, pallas_br.py:57-62); the limb count is the key's
shape[3].

The product is a block-Karatsuba tree of depth kar_depth(params, nlimbs)
(0, 1 or 2; the JAX kernel's rule, pallas_br.py:160-190): the negacyclic
Toeplitz operator of a key polynomial splits into 2x2 Toeplitz blocks
[[A, T01], [T10, A]], and three leaf products, A (x_l + x_r), (T01 - A)
x_r and (T10 - A) x_l, replace four. prepare_bk_ext builds the 3^d leaf
generators in uint32 before the limb split; the step's digits become the
leaf operands (leaf_operands); each leaf's product adds to the output
quarters it feeds (leaf_quarters). Every step is linear mod 2^32, so the
result is the same uint32 words as the schoolbook product's. The depth
follows from the set and the limb count alone: blind_rotate_cuda and
blind_rotate_ref raise on a key built at another depth.

One step's rotate-and-decompose has the same pair, rotdec_ref and
rotdec_cuda (the kernel blind_rotate_cuda launches once per step), so the
kernel can be held against its plain version and timed alone.

blind_rotate and rotdec take the plain version for CPU tensors and the
kernel for CUDA tensors; a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import torch

from .._build import H100_SMS, call, cdiv, check_cuda, sms
from ..params import GateParams
from ..torus import int_mm
from ..utils.spans import count, span
from .limbs import LIMB_BITS, NLIMBS, decomp_digit_limb_plan
from .poly import decompose_rotate_sub, split_decomp_digits

#: key limb counts the rotation takes: 4 is exact, 3 the `pallas3` path
KEY_LIMBS = (3, 4)
#: the least N of a three-limb key: the JAX package's pallas3 kernel needs
#: N % 128 == 0 (pallas_br.py:343, 816)
PALLAS3_MIN_N = 128

#: extprod_kernel's block tile (csrc/blind_rotate.cu: kOutTile, kRowTile,
#: kStageK): outputs (o, c), batch rows, and contraction bytes a stage
EXTPROD_OUT_TILE = 128
EXTPROD_ROW_TILE = 64
EXTPROD_STAGE_BYTES = 128
#: a block's fixed cost (launch, barriers, the ring's first fill, the
#: epilogue) in stages, as the plan weighs it against shorter ranges; a
#: guess, not timed against other values (PERF.md)
EXTPROD_BLOCK_OVERHEAD = 2
#: the same at Karatsuba depth > 0, where a range also folds its leaf and
#: adds up to four quarters to acc: 6 picks the fastest split at every row
#: count timed at tfhepp_128bit, 1 to 2048 rows (PERF.md)
EXTPROD_LEAF_BLOCK_OVERHEAD = 6
#: the deepest Karatsuba tree (csrc/blind_rotate.cu: kMaxKar)
KAR_MAX_DEPTH = 2
#: int32 words from one row-tile group's barrier counter to the next in
#: the persistent kernel (csrc/blind_rotate.cu: kArrivalStride)
ARRIVAL_STRIDE = 32


def kar_depth(params: GateParams, nlimbs: int = NLIMBS) -> int:
    """The Karatsuba depth of the product at `params` with an `nlimbs`-limb
    key: the JAX kernel's rule (pallas_br.py:kar_depth, without its
    environment override). A leaf operand sums 2^d sub-digits of at most
    2^(dbits-1), which must fit int8; a leaf keeps at least 128
    coefficients; the three-limb key stays at 0 (its dropped limb's error
    would grow with the digit sums)."""
    if nlimbs < NLIMBS:
        return 0
    lp = params.lvl1
    dbits = decomp_digit_limb_plan(lp.Bgbit)[1]
    return max(0, min(KAR_MAX_DEPTH, 8 - dbits, lp.nbit - 7))


def leaf_width(N: int, depth: int) -> int:
    """The last dimension of a key row at Karatsuba depth `depth`: 3^d
    leaf generators of 2 (N >> d) coefficients each."""
    return 3 ** depth * 2 * (N >> depth)


def leaf_quarters(v: int, depth: int) -> list:
    """The output quarters (of 2^depth) leaf v adds to
    (pallas_br.py:_leaf_quarters; csrc/blind_rotate.cu: leaf_quarters).
    v's base-3 digits, the first level's first, are 0: A, both halves;
    1: T01 - A, the first half; 2: T10 - A, the second half."""
    qs = [0]
    for lev in range(depth):
        digit = v // 3 ** (depth - 1 - lev) % 3
        qs = [2 * q + h for q in qs for h in (0, 1)
              if (digit, h) != (1, 1) and (digit, h) != (2, 0)]
    return qs


def leaf_operands(dec: torch.Tensor, depth: int) -> torch.Tensor:
    """The Karatsuba leaf operands of one step's digits, in the layout
    rotdec_kernel writes: dec [B, I, N] int8 -> [B, 3^d, I, N >> d] int8
    (dec itself at depth 0). Leaf v of a node x = (x_l, x_r) is, by its
    base-3 digit, x_l + x_r, x_r or x_l, recursively. Raises ValueError
    where a sum leaves int8 (a depth kar_depth would not give)."""
    if depth == 0:
        return dec
    nodes = [dec.to(torch.int16)]
    for _ in range(depth):
        nxt = []
        for x in nodes:
            h = x.shape[-1] // 2
            lo, hi = x[..., :h], x[..., h:]
            nxt += [lo + hi, hi, lo]
        nodes = nxt
    out = torch.stack(nodes, dim=1)
    if out.numel() and (int(out.min()) < -128 or int(out.max()) > 127):
        raise ValueError(f"Karatsuba depth {depth}: a leaf operand leaves "
                         f"int8")
    return out.to(torch.int8)


def extprod_items(B: int, N: int, kp1: int, depth: int, split: int) -> int:
    """The work items of one step of the product: output tiles x batch
    tiles x ranges, extprod_kernel's grid (csrc/blind_rotate.cu)."""
    LN = N >> depth
    return (cdiv(kp1 * LN, EXTPROD_OUT_TILE) * cdiv(B, EXTPROD_ROW_TILE)
            * split)


def extprod_stages(N: int, I: int, depth: int) -> int:
    """The contraction stages of one step of the product: 3^depth leaves
    of ceil(I * (N >> depth) / 128)."""
    return 3 ** depth * cdiv(I * (N >> depth), EXTPROD_STAGE_BYTES)


def extprod_plan(B: int, N: int, kp1: int, I: int,
                 sms: int = H100_SMS, depth: int = 0) -> int:
    """The product kernel's split for B accumulators [B, kp1, N], I digit
    rows and Karatsuba depth `depth` (LN = N >> depth coefficients a
    leaf): the number of ranges its 3^depth * ceil(I*LN / 128) contraction
    stages are cut into (gridDim.z; the kernel takes the grid's output
    and batch tiles from B, kp1 and LN). 1 where output tiles x batch
    tiles fill the `sms` SMs (one block an SM); otherwise at least `sms`
    blocks, at the split of the least waves x (stages a range +
    EXTPROD_BLOCK_OVERHEAD). At depth d > 0 the split is 1 or the
    multiple of the 3^d leaves with the least waves x (stages a range +
    EXTPROD_LEAF_BLOCK_OVERHEAD), so a split's ranges z*T/Z never straddle
    two leaves: a range folds once and adds only the quarters its leaf
    feeds to acc."""
    blocks = extprod_items(B, N, kp1, depth, 1)
    stages = extprod_stages(N, I, depth)
    if blocks >= sms:
        return 1
    if depth:
        splits = [1, *range(3 ** depth, stages + 1, 3 ** depth)]
        overhead = EXTPROD_LEAF_BLOCK_OVERHEAD
    else:
        splits = range(min(cdiv(sms, blocks), stages), stages + 1)
        overhead = EXTPROD_BLOCK_OVERHEAD
    return min(splits, key=lambda z: (
        cdiv(blocks * z, sms) * (cdiv(stages, z) + overhead), z))


def rotation_plan(B: int, N: int, kp1: int, I: int, sms: int = H100_SMS,
                  depth: int = 0) -> tuple:
    """(split, grid) of one rotation of B accumulators [B, kp1, N] with I
    digit rows at Karatsuba depth `depth` on a card of `sms` SMs: split is
    extprod_plan's, the loop's ranges; grid is the persistent kernel's
    cooperative grid, or 0 for the loop of 2 n0 launches. The persistent
    kernel runs exactly where the split is > 1, where the step's output
    tiles x batch tiles leave SMs idle, and saves the n0 steps' launches,
    block prologues and rotdec launches. Its grid is one block an SM, or
    one a stage of the step's work where that is fewer, cut into
    persistent_groups row-tile groups whose blocks share their tiles x
    stages equally (csrc/blind_rotate.cu: tile_group, for_share). Where
    the tiles fill the card (both NAND cells' 4096 rows) the loop runs.
    The choice follows from the shape alone."""
    split = extprod_plan(B, N, kp1, I, sms, depth)
    if split == 1:
        return split, 0
    stages = extprod_stages(N, I, depth)
    return split, min(extprod_items(B, N, kp1, depth, stages), sms)


def persistent_groups(B: int, grid: int) -> int:
    """The row-tile groups of a persistent rotation of B rows on `grid`
    blocks: one a 64-row batch tile, at most one a block. Each walks the
    n0 steps behind barriers of its own blocks alone
    (csrc/blind_rotate.cu: tile_group)."""
    return min(cdiv(B, EXTPROD_ROW_TILE), grid)


def check_key_limbs(nlimbs: int, params: GateParams) -> None:
    """Raise ValueError unless the rotation takes an `nlimbs`-limb key at
    `params`: 4 anywhere, 3 where the JAX package's pallas3 runs."""
    if nlimbs not in KEY_LIMBS:
        raise ValueError(f"a key has 4 limbs (exact) or 3 (pallas3), not "
                         f"{nlimbs}")
    if nlimbs == 3 and params.lvl1.n < PALLAS3_MIN_N:
        raise ValueError(
            f"backend 'pallas3' needs N >= {PALLAS3_MIN_N}, as the JAX "
            f"package's pallas3 kernel does (N % 128 == 0); "
            f"{params.name} has N = {params.lvl1.n}")


def child_exts(h_ext: torch.Tensor) -> list:
    """The Karatsuba children of extended generators h_ext [..., 2m]
    (int32 holding uint32 bits; h_ext[u] = h[u - m] of a size-m Toeplitz
    operator): [A, T01 - A, T10 - A], each [..., m], the extended
    generators of the size-m/2 blocks (pallas_br.py:_child_exts), mod
    2^32."""
    m = h_ext.shape[-1] // 2
    a = h_ext[..., m // 2:m // 2 + m]
    return [a, h_ext[..., :m] - a, h_ext[..., m:] - a]


def _signed_limbs(x: torch.Tensor, nlimbs: int) -> torch.Tensor:
    """int32 [..., W] (uint32 bits) -> the top `nlimbs` of its four
    balanced 8-bit limbs, [..., nlimbs, W] int8: limbs.u32_to_signed_limbs
    in int32 arithmetic (each shift loses a multiple of 2^24, 2^16, 2^8,
    which no lower limb sees), on x's device."""
    out = []
    for _ in range(NLIMBS):
        d = ((x + 128) & 255) - 128
        out.append(d.to(torch.int8))
        x = (x - d) >> LIMB_BITS
    return torch.stack(out[NLIMBS - nlimbs:], dim=-2)


def prepare_bk_ext(bk: torch.Tensor, params: GateParams,
                   nlimbs: int = NLIMBS, depth: int | None = None
                   ) -> torch.Tensor:
    """BK [n0, (k+1)l, k+1, N] int32 (uint32 bits) -> the product's key
    [n0, I, k+1, nlimbs, leaf_width(N, d)] int8 on bk's device, at
    Karatsuba depth d = kar_depth(params, nlimbs) unless `depth` is given
    (tests and benchmarks.rotation build other depths; the rotation's
    public entries refuse them).

    Row r of I = (k+1)*l*nd holds, for each output component o, the
    balanced 8-bit limbs of the extended generator ext = [-bk, bk]: the
    negacyclic Toeplitz operator of a key polynomial is T[t, c] =
    ext[N + c - t], so any tile of it is one contiguous window of ext. At
    depth d > 0 it holds the 3^d leaf generators instead, leaf v's at
    [2 LN v, 2 LN (v + 1)) with LN = N >> d: child_exts applied d times,
    in uint32 (pallas_br.py:prepare_wext). The negation and the
    differences are done in uint32 before the limb split, so no int8 -128
    is ever negated. For Bgbit > 8 the nd sub-digit rows of gadget row r
    use the generator bk[r] << dbits*dl (scaled in uint32, exact).
    nlimbs = 3 keeps limbs 1-3 of the four-limb split, limb li worth
    2^(8(li+1)): the JAX package's pallas3 key (prepare_wext,
    pallas_br.py:907-920), which truncates each scaled generator and each
    negation on its own.
    """
    check_key_limbs(nlimbs, params)
    if depth is None:
        depth = kar_depth(params, nlimbs)
    n0, I0, kp1, N = bk.shape
    nd, dbits = decomp_digit_limb_plan(params.lvl1.Bgbit)
    if nd > 1:
        bk = torch.stack([bk << (dbits * dl) for dl in range(nd)],
                         dim=2).reshape(n0, I0 * nd, kp1, N)
    leaves = [torch.cat([0 - bk, bk], dim=-1)]
    for _ in range(depth):
        leaves = [c for e in leaves for c in child_exts(e)]
    ext = torch.cat(leaves, dim=-1) if depth else leaves[0]
    del leaves
    return _signed_limbs(ext, nlimbs).contiguous()


def rotdec_ref(acc: torch.Tensor, abar_i: torch.Tensor,
               params: GateParams) -> torch.Tensor:
    """Plain PyTorch rotate-and-decompose of one step. acc: [B, k+1, N]
    int32; abar_i: [B] int32 rotations in [0, 2N). Returns dec [B, I, N]
    int8, I = (k+1)*l*nd, with sub-digit dl of digit d of component j in
    row (j*l + d)*nd + dl: the A operand of the step's product."""
    lp = params.lvl1
    dec = decompose_rotate_sub(acc, abar_i, lp)             # [B, (k+1)l, N]
    parts, _ = split_decomp_digits(dec, lp.Bgbit)
    B, rows, N = dec.shape
    return torch.stack(parts, dim=2).reshape(B, rows * len(parts), N)


def toeplitz_operator(bk_i: torch.Tensor) -> torch.Tensor:
    """[L, I*N, (k+1)*N] int8: the negacyclic Toeplitz operator of one
    step's key, T_li[(r, t), (o, c)] = ext_li[r, o][N + c - t], built from
    the windows of bk_i [I, k+1, L, 2N] (one step of prepare_bk_ext)."""
    I, kp1, L, N2 = bk_i.shape
    N = N2 // 2
    t = torch.arange(N, device=bk_i.device)
    T = bk_i[..., N + t[None, :] - t[:, None]]        # [I, k+1, L, t, c]
    return T.permute(2, 0, 3, 1, 4).reshape(L, I * N, kp1 * N)


def _toeplitz_product(dec: torch.Tensor, bk_i: torch.Tensor) -> torch.Tensor:
    """[B, k+1, n] int32 = sum_li (sum_{r,t} dec[b, r, t] *
    ext_li[r, o][n + c - t]) << shift_li mod 2^32 for dec [B, I, n] int8
    and generators bk_i [I, k+1, L, 2n] int8."""
    B, I, N = dec.shape
    _, kp1, L, _ = bk_i.shape
    T = toeplitz_operator(bk_i)
    lhs = dec.reshape(B, I * N)
    out = torch.zeros((B, kp1 * N), dtype=torch.int32, device=dec.device)
    for li in range(L):
        out += int_mm(lhs, T[li]) << (LIMB_BITS * (li + NLIMBS - L))
    return out.reshape(B, kp1, N)


def ext_product_ref(dec: torch.Tensor, bk_i: torch.Tensor) -> torch.Tensor:
    """One step's external product, plain: [B, k+1, N] int32 =
    sum_li (sum_{r,t} dec[b, r, t] * ext_li[r, o][N + c - t]) << shift_li
    mod 2^32, the negacyclic Toeplitz operator of every key row built
    from its window of ext as the kernel reads it; limb li is worth
    2^(8(li + 4 - L)). At depth 0, dec is [B, I, N] int8 and bk_i
    [I, k+1, L, 2N] int8, one step of prepare_bk_ext. At Karatsuba depth
    d, dec is the leaf operands [B, 3^d, I, LN] (leaf_operands), bk_i
    [I, k+1, L, 3^d * 2LN]: leaf v's product against its generator adds
    to each output quarter leaf_quarters(v, d) names."""
    if dec.dim() == 3:
        return _toeplitz_product(dec, bk_i)
    B, nleaves, I, LN = dec.shape
    depth = {3 ** d: d for d in range(KAR_MAX_DEPTH + 1)}[nleaves]
    kp1 = bk_i.shape[1]
    out = torch.zeros((B, kp1, LN << depth), dtype=torch.int32,
                      device=dec.device)
    for v in range(nleaves):
        part = _toeplitz_product(dec[:, v],
                                 bk_i[..., 2 * LN * v:2 * LN * (v + 1)])
        for q in leaf_quarters(v, depth):
            out[..., q * LN:(q + 1) * LN] += part
    return out


def _key_shape(params: GateParams, nlimbs: int, depth: int) -> tuple:
    """bk_ext's shape at `params`, `nlimbs` limbs and Karatsuba depth
    `depth`."""
    N, _, k, l, _, nd, _, _ = _decomp_args(params)
    return (params.lvl0.dim, (k + 1) * l * nd, k + 1, nlimbs,
            leaf_width(N, depth))


def _key_limbs(bk_ext: torch.Tensor) -> int:
    """bk_ext's limb count, or ValueError where it is none the rotation
    takes."""
    nlimbs = bk_ext.shape[3] if bk_ext.dim() == 5 else 0
    if nlimbs not in KEY_LIMBS:
        raise ValueError(f"bk_ext: want [n0, I, k+1, 4 or 3, W] int8, got "
                         f"{tuple(bk_ext.shape)}")
    return nlimbs


def blind_rotate_ref(acc: torch.Tensor, abar: torch.Tensor,
                     bk_ext: torch.Tensor, params: GateParams) -> torch.Tensor:
    """Plain PyTorch blind rotation. acc: [B, k+1, N] int32; abar: [n0, B]
    int32 switched rotations in [0, 2N); bk_ext as prepare_bk_ext builds
    it, at 4 or 3 limbs and at kar_depth(params, limbs): a key of another
    shape raises ValueError. Digit row (r, dl) of each step contracts
    against its own pre-scaled key row r*nd + dl, as the kernel and the
    JAX kernel do: with 3 limbs, truncating bk << dbits is not truncating
    bk and then shifting. Returns a new [B, k+1, N] int32 tensor."""
    return _blind_rotate_ref(acc, abar, bk_ext, params,
                             kar_depth(params, _key_limbs(bk_ext)))


def _blind_rotate_ref(acc: torch.Tensor, abar: torch.Tensor,
                      bk_ext: torch.Tensor, params: GateParams,
                      depth: int) -> torch.Tensor:
    """blind_rotate_ref at Karatsuba depth `depth`, for tests that hold
    other depths to it."""
    want = _key_shape(params, _key_limbs(bk_ext), depth)
    if tuple(bk_ext.shape) != want:
        raise ValueError(f"bk_ext: want {want} at Karatsuba depth {depth}, "
                         f"got {tuple(bk_ext.shape)}")
    for i in range(params.lvl0.dim):
        acc = acc + ext_product_ref(
            leaf_operands(rotdec_ref(acc, abar[i], params), depth),
            bk_ext[i])
    return acc


def _decomp_args(params: GateParams) -> tuple:
    """(N, nbit, k, l, Bgbit, nd, dbits, offset) as the C entries take
    them."""
    lp = params.lvl1
    nd, dbits = decomp_digit_limb_plan(lp.Bgbit)
    off = (lp.decomp_offset + lp.decomp_roundoffset) % (1 << 32)
    return lp.n, lp.nbit, lp.k, lp.l, lp.Bgbit, nd, dbits, off


def blind_rotate_cuda(acc: torch.Tensor, abar: torch.Tensor,
                      bk_ext: torch.Tensor, params: GateParams
                      ) -> torch.Tensor:
    """One blind rotation through the CUDA kernels.

    acc: [B, k+1, N] int32, abar: [n0, B] int32, bk_ext as prepare_bk_ext
    builds it at 4 or 3 limbs, all contiguous on one CUDA device. The
    kernels update their accumulator in place, so they are given a clone:
    `acc` is left unchanged and the result is returned. The Karatsuba
    depth is kar_depth(params, limbs), and a key of another shape raises
    ValueError; the C entry picks the product kernel's instance from the
    limb count, N and the depth, and refuses a depth whose leaf operands
    could leave int8. Enqueued on the current stream; raises if the
    kernels cannot be built or launched. The product's contraction split
    and the launch (the loop, or one persistent kernel) are
    rotation_plan's for the card's SM count; each persistent rotation
    counts once on spans.counts()["blind_rotate.persistent"] and its
    row-tile groups on "blind_rotate.persistent_groups", each loop n0
    times on "rotdec".
    """
    return _blind_rotate_cuda(acc, abar, bk_ext, params,
                              kar_depth(params, _key_limbs(bk_ext)))


def _blind_rotate_cuda(acc: torch.Tensor, abar: torch.Tensor,
                       bk_ext: torch.Tensor, params: GateParams,
                       depth: int, grid: int | None = None) -> torch.Tensor:
    """blind_rotate_cuda at Karatsuba depth `depth`, for the tests and
    benchmarks.rotation, which hold and time other depths; and with the
    persistent kernel's `grid` in place of rotation_plan's (0: the loop),
    to hold and time both launches at one shape."""
    n0 = params.lvl0.dim
    N, nbit, k, l, Bgbit, nd, dbits, off = _decomp_args(params)
    I = (k + 1) * l * nd
    B = acc.shape[0]
    nlimbs = _key_limbs(bk_ext)
    check_cuda({"acc": (acc, torch.int32, (B, k + 1, N)),
                "abar": (abar, torch.int32, (n0, B)),
                "bk_ext": (bk_ext, torch.int8,
                           _key_shape(params, nlimbs, depth))})
    split, planned = rotation_plan(B, N, k + 1, I, sms(acc.device), depth)
    grid = planned if grid is None else grid
    out = acc.clone()
    dec = torch.empty((B, 3 ** depth * I * (N >> depth)), dtype=torch.int8,
                      device=acc.device)
    # the persistent kernel's barrier counters, one a row-tile group,
    # zeroed for each rotation
    groups = persistent_groups(B, grid) if grid else 0
    arrivals = (torch.zeros(groups * ARRIVAL_STRIDE, dtype=torch.int32,
                            device=acc.device) if grid else None)
    call("cufhe_blind_rotate", acc.device, out.data_ptr(), abar.data_ptr(),
         bk_ext.data_ptr(), dec.data_ptr(), B, n0, N, nbit, k, l, Bgbit, nd,
         dbits, nlimbs, depth, off, split, grid,
         arrivals.data_ptr() if grid else None)
    count("blind_rotate")
    count(f"blind_rotate.limbs{nlimbs}")
    count(f"blind_rotate.kar{depth}")
    if grid:
        count("blind_rotate.persistent")
        count("blind_rotate.persistent_groups", groups)
    else:
        count("rotdec", n0)
    return out


def rotdec_cuda(acc: torch.Tensor, abar_i: torch.Tensor,
                params: GateParams) -> torch.Tensor:
    """One step's rotate-and-decompose through the CUDA kernel, as the
    exact rotation launches it: at Karatsuba depth d = kar_depth(params)
    the leaf operands [B, 3^d, I, N >> d] int8, which are
    leaf_operands(rotdec_ref(...), d); at depth 0 dec [B, I, N] as
    rotdec_ref returns it. acc: [B, k+1, N] int32, abar_i: [B] int32,
    contiguous on one CUDA device (checked before anything is built).
    Enqueued on the current stream; raises if the kernel cannot be built
    or launched."""
    N, nbit, k, l, Bgbit, nd, dbits, off = _decomp_args(params)
    B = acc.shape[0]
    check_cuda({"acc": (acc, torch.int32, (B, k + 1, N)),
                "abar_i": (abar_i, torch.int32, (B,))})
    depth = kar_depth(params)
    I = (k + 1) * l * nd
    shape = (B, I, N) if depth == 0 else (B, 3 ** depth, I, N >> depth)
    dec = torch.empty(shape, dtype=torch.int8, device=acc.device)
    call("cufhe_rotdec", acc.device, acc.data_ptr(), abar_i.data_ptr(),
         dec.data_ptr(), B, N, nbit, k, l, Bgbit, nd, dbits, depth, off)
    count("rotdec")
    return dec


def rotdec(acc: torch.Tensor, abar_i: torch.Tensor,
           params: GateParams) -> torch.Tensor:
    """One step's rotate-and-decompose on acc's device, in the layout the
    exact rotation's product reads at kar_depth(params): the CUDA kernel
    for CUDA tensors, the plain version (leaf_operands of rotdec_ref) for
    CPU tensors, no fallback between them."""
    if acc.device.type == "cuda":
        return rotdec_cuda(acc, abar_i, params)
    if acc.device.type == "cpu":
        return leaf_operands(rotdec_ref(acc, abar_i, params),
                             kar_depth(params))
    raise NotImplementedError(f"no rotate-and-decompose for device "
                              f"{acc.device}")


def blind_rotate(acc: torch.Tensor, abar: torch.Tensor, bk_ext: torch.Tensor,
                 params: GateParams, nlimbs: int = NLIMBS) -> torch.Tensor:
    """Blind rotation on acc's device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. There is no fallback between them.
    nlimbs is the path's key precision (4 exact, 3 pallas3): a key of
    another limb count raises ValueError, so no path runs the other's
    key."""
    check_key_limbs(nlimbs, params)
    if bk_ext.dim() != 5 or bk_ext.shape[3] != nlimbs:
        raise ValueError(f"the path reads a {nlimbs}-limb key, bk_ext is "
                         f"{tuple(bk_ext.shape)} (limbs in dim 3): prepare "
                         f"the key for this backend")
    with span("cufhe.blind_rotate"):
        if acc.device.type == "cuda":
            return blind_rotate_cuda(acc, abar, bk_ext, params)
        if acc.device.type == "cpu":
            return blind_rotate_ref(acc, abar, bk_ext, params)
    raise NotImplementedError(f"no blind rotation for device {acc.device}")
