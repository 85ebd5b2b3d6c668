"""The n0-step blind rotation: the counterpart of cufhe_tpu/ops/pallas_br.py.

    acc <- acc + ExtProd(BK_i, Decomp(acc * X^abar_i - acc + offset))  mod 2^32

for i = 0 .. n0-1, batched over B accumulators [B, k+1, N].

Two versions of the same function live here:

* blind_rotate_ref, plain PyTorch built on ops/poly.py: rotate, decompose
  and a materialised negacyclic Toeplitz product per step. Exact on the
  CPU and on CUDA.
* blind_rotate_cuda, the hand-written CUDA kernel (csrc/blind_rotate.cu),
  reading the key in the layout prepare_bk_ext builds.

blind_rotate takes the plain version for CPU tensors and the kernel for
CUDA tensors; a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..params import GateParams
from .limbs import NLIMBS, decomp_digit_limb_plan, u32_to_signed_limbs
from .poly import (decompose_rotate_sub, negacyclic_conv_toeplitz,
                   split_decomp_digits)


def prepare_bk_ext(bk: np.ndarray, params: GateParams) -> np.ndarray:
    """BK [n0, (k+1)l, k+1, N] uint32 -> [n0, I, k+1, NLIMBS, 2N] int8.

    Row r of I = (k+1)*l*nd holds, for each output component o, the
    balanced 8-bit limbs of the extended generator ext = [-bk, bk]: the
    negacyclic Toeplitz operator of a key polynomial is T[t, c] =
    ext[N + c - t], so any tile of it is one contiguous window of ext. The
    negation is done in uint32 before the limb split, so no int8 -128 is
    ever negated. For Bgbit > 8 the nd sub-digit rows of gadget row r use
    the generator bk[r] << dbits*dl (scaled in uint32, exact).
    """
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
    limbs = u32_to_signed_limbs(ext)                 # [n0, I, k+1, 2N, L]
    return np.ascontiguousarray(np.moveaxis(limbs, 4, 3))


def blind_rotate_ref(acc: torch.Tensor, abar: torch.Tensor,
                     bk_ext: torch.Tensor, params: GateParams) -> torch.Tensor:
    """Plain PyTorch blind rotation. acc: [B, k+1, N] int32; abar: [n0, B]
    int32 switched rotations in [0, 2N); bk_ext as prepare_bk_ext builds
    it, of which only the limbs of bk itself are read (row r*nd of gadget
    row r, second half). Returns a new [B, k+1, N] int32 tensor."""
    lp = params.lvl1
    N = lp.n
    nd, _ = decomp_digit_limb_plan(lp.Bgbit)
    for i in range(params.lvl0.dim):
        bk_limbs = bk_ext[i, ::nd, :, :, N:].permute(2, 0, 1, 3)
        dec = decompose_rotate_sub(acc, abar[i], lp)
        parts, bits = split_decomp_digits(dec, lp.Bgbit)
        for dl, d8 in enumerate(parts):
            upd = negacyclic_conv_toeplitz(d8, bk_limbs, lp.k)
            acc = acc + (upd << (bits * dl))
    return acc


def blind_rotate_cuda(acc: torch.Tensor, abar: torch.Tensor,
                      bk_ext: torch.Tensor, params: GateParams) -> torch.Tensor:
    """One blind rotation through the CUDA kernel.

    acc: [B, k+1, N] int32, abar: [n0, B] int32, bk_ext as prepare_bk_ext
    builds it, all contiguous on one CUDA device. The kernel updates its
    accumulator in place, so it is given a clone: `acc` is left unchanged
    and the result is returned. Enqueued on the current stream; raises if
    the kernel cannot be built or launched.
    """
    from .._build import load

    lp = params.lvl1
    n0, N, k = params.lvl0.dim, lp.n, lp.k
    nd, dbits = decomp_digit_limb_plan(lp.Bgbit)
    I = (k + 1) * lp.l * nd
    B = acc.shape[0]
    want = {"acc": (acc, torch.int32, (B, k + 1, N)),
            "abar": (abar, torch.int32, (n0, B)),
            "bk_ext": (bk_ext, torch.int8, (n0, I, k + 1, NLIMBS, 2 * N))}
    for name, (t, dtype, shape) in want.items():
        if t.device.type != "cuda" or t.device != acc.device:
            raise ValueError(f"{name} must lie on acc's CUDA device, "
                             f"got {t.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = load()
    out = acc.clone()
    dec = torch.empty((B, I, N), dtype=torch.int8, device=acc.device)
    off = (lp.decomp_offset + lp.decomp_roundoffset) % (1 << 32)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cufhe_blind_rotate(
            out.data_ptr(), abar.data_ptr(), bk_ext.data_ptr(),
            dec.data_ptr(), B, n0, N, lp.nbit, k, lp.l, lp.Bgbit, nd, dbits,
            off, stream)
    if rc != 0:
        msg = lib.cufhe_error_string(rc).decode()
        raise RuntimeError(f"cufhe_blind_rotate failed: {msg} ({rc})")
    blind_rotate_cuda.launches += 1
    return out


#: blind rotations launched through the kernel (one per successful call)
blind_rotate_cuda.launches = 0


def blind_rotate(acc: torch.Tensor, abar: torch.Tensor, bk_ext: torch.Tensor,
                 params: GateParams) -> torch.Tensor:
    """Blind rotation on acc's device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. There is no fallback between them."""
    if acc.device.type == "cuda":
        return blind_rotate_cuda(acc, abar, bk_ext, params)
    if acc.device.type == "cpu":
        return blind_rotate_ref(acc, abar, bk_ext, params)
    raise NotImplementedError(f"no blind rotation for device {acc.device}")
