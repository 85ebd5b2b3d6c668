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
  cut into, and the C entry takes that split.

Both take the key at four limbs (the exact path) or three (the reduced-
precision `pallas3` path of the JAX package: the lowest of the four
balanced limbs dropped, pallas_br.py:57-62); the limb count is the key's
shape[3].

One step's rotate-and-decompose has the same pair, rotdec_ref and
rotdec_cuda (the kernel blind_rotate_cuda launches once per step), so the
kernel can be held against its plain version and timed alone.

blind_rotate and rotdec take the plain version for CPU tensors and the
kernel for CUDA tensors; a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..params import GateParams
from ..torus import int_mm
from ..utils.spans import count, span
from .limbs import (LIMB_BITS, NLIMBS, decomp_digit_limb_plan,
                    u32_to_signed_limbs)
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
#: streaming multiprocessors of an H100 SXM, the plan's default
H100_SMS = 132
#: a block's fixed cost (launch, barriers, the ring's first fill, the
#: epilogue) in stages, as the plan weighs it against shorter ranges; a
#: guess, not timed against other values (PERF.md)
EXTPROD_BLOCK_OVERHEAD = 2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def extprod_plan(B: int, N: int, kp1: int, I: int,
                 sms: int = H100_SMS) -> int:
    """The product kernel's split for B accumulators [B, kp1, N] and I
    digit rows: the number of ranges its ceil(I*N / 128) contraction
    stages are cut into (gridDim.z; the kernel takes the grid's output
    and batch tiles from B, kp1 and N). 1 where output tiles x batch tiles
    fill the `sms` SMs (one block an SM); otherwise at least `sms` blocks,
    at the split of the least waves x (stages a range +
    EXTPROD_BLOCK_OVERHEAD)."""
    blocks = _cdiv(kp1 * N, EXTPROD_OUT_TILE) * _cdiv(B, EXTPROD_ROW_TILE)
    stages = _cdiv(I * N, EXTPROD_STAGE_BYTES)
    if blocks >= sms:
        return 1
    least = min(_cdiv(sms, blocks), stages)
    return min(range(least, stages + 1), key=lambda z: (
        _cdiv(blocks * z, sms) * (_cdiv(stages, z) + EXTPROD_BLOCK_OVERHEAD),
        z))


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


def prepare_bk_ext(bk: np.ndarray, params: GateParams,
                   nlimbs: int = NLIMBS) -> np.ndarray:
    """BK [n0, (k+1)l, k+1, N] uint32 -> [n0, I, k+1, nlimbs, 2N] int8.

    Row r of I = (k+1)*l*nd holds, for each output component o, the
    balanced 8-bit limbs of the extended generator ext = [-bk, bk]: the
    negacyclic Toeplitz operator of a key polynomial is T[t, c] =
    ext[N + c - t], so any tile of it is one contiguous window of ext. The
    negation is done in uint32 before the limb split, so no int8 -128 is
    ever negated. For Bgbit > 8 the nd sub-digit rows of gadget row r use
    the generator bk[r] << dbits*dl (scaled in uint32, exact). nlimbs = 3
    keeps limbs 1-3 of the four-limb split, limb li worth 2^(8(li+1)): the
    JAX package's pallas3 key (prepare_wext, pallas_br.py:907-920), which
    truncates each scaled generator and each negation on its own.
    """
    check_key_limbs(nlimbs, params)
    n0, I0, kp1, N = bk.shape
    nd, dbits = decomp_digit_limb_plan(params.lvl1.Bgbit)
    if nd > 1:
        scaled = np.empty((n0, I0 * nd, kp1, N), dtype=np.uint32)
        for r in range(I0):
            for dl in range(nd):
                scaled[:, r * nd + dl] = bk[:, r] << np.uint32(dbits * dl)
        bk = scaled
    ext = np.empty(bk.shape[:3] + (2 * N,), dtype=np.uint32)
    ext[..., :N] = np.zeros_like(bk) - bk
    ext[..., N:] = bk
    limbs = u32_to_signed_limbs(ext)                 # [n0, I, k+1, 2N, 4]
    limbs = limbs[..., NLIMBS - nlimbs:]
    return np.ascontiguousarray(np.moveaxis(limbs, 4, 3))


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


def ext_product_ref(dec: torch.Tensor, bk_i: torch.Tensor) -> torch.Tensor:
    """One step's external product, plain: [B, k+1, N] int32 =
    sum_li (sum_{r,t} dec[b, r, t] * ext_li[r, o][N + c - t]) << shift_li
    mod 2^32, the negacyclic Toeplitz operator of every key row built
    from its window of ext as the kernel reads it. dec: [B, I, N] int8;
    bk_i: [I, k+1, L, 2N] int8, one step of prepare_bk_ext; limb li is
    worth 2^(8(li + 4 - L))."""
    B, I, N = dec.shape
    _, kp1, L, _ = bk_i.shape
    T = toeplitz_operator(bk_i)
    lhs = dec.reshape(B, I * N)
    out = torch.zeros((B, kp1 * N), dtype=torch.int32, device=dec.device)
    for li in range(L):
        out += int_mm(lhs, T[li]) << (LIMB_BITS * (li + NLIMBS - L))
    return out.reshape(B, kp1, N)


def blind_rotate_ref(acc: torch.Tensor, abar: torch.Tensor,
                     bk_ext: torch.Tensor, params: GateParams) -> torch.Tensor:
    """Plain PyTorch blind rotation. acc: [B, k+1, N] int32; abar: [n0, B]
    int32 switched rotations in [0, 2N); bk_ext as prepare_bk_ext builds
    it, at 4 or 3 limbs. Digit row (r, dl) of each step contracts against
    its own pre-scaled key row r*nd + dl, as the kernel and the JAX
    kernel do: with 3 limbs, truncating bk << dbits is not truncating bk
    and then shifting. Returns a new [B, k+1, N] int32 tensor."""
    for i in range(params.lvl0.dim):
        acc = acc + ext_product_ref(rotdec_ref(acc, abar[i], params),
                                    bk_ext[i])
    return acc


def _check_cuda(want: dict) -> None:
    """Raise ValueError unless every tensor has its dtype and shape (checked
    first, for all), lies on the first one's CUDA device and is contiguous.
    want: name -> (tensor, dtype, shape)."""
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    device = next(iter(want.values()))[0].device
    for name, (t, _, _) in want.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name} must lie on one CUDA device with the "
                             f"others, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _decomp_args(params: GateParams) -> tuple:
    """(N, nbit, k, l, Bgbit, nd, dbits, offset) as the C entries take
    them."""
    lp = params.lvl1
    nd, dbits = decomp_digit_limb_plan(lp.Bgbit)
    off = (lp.decomp_offset + lp.decomp_roundoffset) % (1 << 32)
    return lp.n, lp.nbit, lp.k, lp.l, lp.Bgbit, nd, dbits, off


def _raise_on(lib, rc: int, entry: str) -> None:
    if rc != 0:
        msg = lib.cufhe_error_string(rc).decode()
        raise RuntimeError(f"{entry} failed: {msg} ({rc})")


def _sms(device: torch.device) -> int:
    """The SM count of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def blind_rotate_cuda(acc: torch.Tensor, abar: torch.Tensor,
                      bk_ext: torch.Tensor, params: GateParams
                      ) -> torch.Tensor:
    """One blind rotation through the CUDA kernels.

    acc: [B, k+1, N] int32, abar: [n0, B] int32, bk_ext as prepare_bk_ext
    builds it at 4 or 3 limbs, all contiguous on one CUDA device. The
    kernels update their accumulator in place, so they are given a clone:
    `acc` is left unchanged and the result is returned. The C entry picks
    the product kernel's instance from the limb count and N. Enqueued on
    the current stream; raises if the kernels cannot be built or
    launched. The product's contraction split is extprod_plan's for the
    card's SM count.
    """
    from .._build import load

    n0 = params.lvl0.dim
    N, nbit, k, l, Bgbit, nd, dbits, off = _decomp_args(params)
    I = (k + 1) * l * nd
    B = acc.shape[0]
    nlimbs = bk_ext.shape[3] if bk_ext.dim() == 5 else 0
    if nlimbs not in KEY_LIMBS:
        raise ValueError(f"bk_ext: want [n0, I, k+1, 4 or 3, 2N] int8, got "
                         f"{tuple(bk_ext.shape)}")
    _check_cuda({"acc": (acc, torch.int32, (B, k + 1, N)),
                 "abar": (abar, torch.int32, (n0, B)),
                 "bk_ext": (bk_ext, torch.int8,
                            (n0, I, k + 1, nlimbs, 2 * N))})
    lib = load()
    split = extprod_plan(B, N, k + 1, I, _sms(acc.device))
    out = acc.clone()
    dec = torch.empty((B, I, N), dtype=torch.int8, device=acc.device)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cufhe_blind_rotate(
            out.data_ptr(), abar.data_ptr(), bk_ext.data_ptr(),
            dec.data_ptr(), B, n0, N, nbit, k, l, Bgbit, nd, dbits, nlimbs,
            off, split, stream)
    _raise_on(lib, rc, "cufhe_blind_rotate")
    count("blind_rotate")
    count(f"blind_rotate.limbs{nlimbs}")
    count("rotdec", n0)
    return out


def rotdec_cuda(acc: torch.Tensor, abar_i: torch.Tensor,
                params: GateParams) -> torch.Tensor:
    """One step's rotate-and-decompose through the CUDA kernel: dec
    [B, I, N] int8 as rotdec_ref returns it. acc: [B, k+1, N] int32,
    abar_i: [B] int32, contiguous on one CUDA device (checked before
    anything is built). Enqueued on the current stream; raises if the
    kernel cannot be built or launched."""
    from .._build import load

    N, nbit, k, l, Bgbit, nd, dbits, off = _decomp_args(params)
    B = acc.shape[0]
    _check_cuda({"acc": (acc, torch.int32, (B, k + 1, N)),
                 "abar_i": (abar_i, torch.int32, (B,))})
    lib = load()
    dec = torch.empty((B, (k + 1) * l * nd, N), dtype=torch.int8,
                      device=acc.device)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cufhe_rotdec(acc.data_ptr(), abar_i.data_ptr(),
                              dec.data_ptr(), B, N, nbit, k, l, Bgbit, nd,
                              dbits, off, stream)
    _raise_on(lib, rc, "cufhe_rotdec")
    count("rotdec")
    return dec


def rotdec(acc: torch.Tensor, abar_i: torch.Tensor,
           params: GateParams) -> torch.Tensor:
    """One step's rotate-and-decompose on acc's device: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors, no fallback
    between them."""
    if acc.device.type == "cuda":
        return rotdec_cuda(acc, abar_i, params)
    if acc.device.type == "cpu":
        return rotdec_ref(acc, abar_i, params)
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
