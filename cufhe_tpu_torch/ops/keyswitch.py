"""Identity key switch: the counterpart of cufhe_tpu/ops/keyswitch.py,
bit-exact to it.

Each decomposed digit selects a KSK row with a sign, so the key switch is a
{-1, 0, +1} coefficient matrix times the KSK, held as NLIMBS balanced int8
limbs: NLIMBS exact int8 x int8 -> int32 products (the sums stay below
128 d1 t <= 2^21), shifted and added mod 2^32. The coefficients are int8,
not bf16 as on the TPU: on CUDA a bf16 product may reduce in lower
precision, while int8 with int32 accumulation is exact.

Two versions of the same function live here:

* key_switch_cuda, the hand-written kernel (csrc/keyswitch.cu:
  keyswitch_kernel), one launch a key switch, reading the KSK in the
  layout ksk_tiles builds: a stage of 128 contraction bytes holds whole
  input coefficients, each with its t digits of nb one-hot bytes in the
  order (j, dig, m). ks_plan chooses its row tile and how many ranges its
  contraction is cut into.
* key_switch_ref, plain PyTorch in the kernel's layout and contraction
  order (ks_stage_coeffs), the version key_switch takes for CPU tensors
  and the one the kernel is held against on the card. The CPU tests hold
  it against the JAX package's key switch and the golden model.

key_switch takes the plain version for CPU tensors and the kernel for CUDA
tensors; a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from .._build import H100_SMS, call, cdiv, check_cuda, sms
from ..params import GateParams
from ..torus import i32, int_mm
from ..utils.spans import count, span
from .limbs import LIMB_BITS, NLIMBS

#: keyswitch_kernel's tiling (csrc/keyswitch.cu: kCols, kStageK, Ks<NT>):
#: output columns a block, contraction bytes a stage, and its row tiles
KS_COL_TILE = 64
KS_STAGE_BYTES = 128
KS_ROW_TILES = (64, 128)
#: a block's fixed cost (launch, barriers, the ring's first fill, the
#: limb fold and the red.global.add epilogue) in stages, as ks_plan weighs
#: it against shorter ranges
KS_BLOCK_OVERHEAD = 2


def ks_layout(params: GateParams) -> tuple:
    """(P, J, S, Mt) of the kernel's KSK layout: P bytes an input
    coefficient (its t * numbase coefficient bytes rounded up to 4), J
    coefficients a 128-byte stage, S stages, Mt column tiles of 64."""
    kp = params.ks
    P = cdiv(kp.t * kp.numbase, 4) * 4
    J = KS_STAGE_BYTES // P
    d1 = params.lvl1.k * params.lvl1.n
    return P, J, cdiv(d1, J), cdiv(params.lvl0.dim + 1, KS_COL_TILE)


def ksk_tiles(ksk_limbs_sei: torch.Tensor, params: GateParams
              ) -> torch.Tensor:
    """The KSK in the kernel's layout, on the input's device:
    [NLIMBS, t*nb*d1, n0+1] int8 in keys.ksk_limbs_sei's (dig, m, j) row
    order -> [Mt, S, NLIMBS, 64, 128] int8: column tile, stage, limb,
    column, contraction byte, so that a stage's four limbs of 64 columns
    are 32 KB in one piece. Stage s holds coefficients j = sJ .. sJ+J-1,
    byte (j - sJ) P + dig * nb + m; every other byte (past t * nb in a P,
    past J P in a stage, past d1, past column n0) is zero."""
    kp = params.ks
    t, nb = kp.t, kp.numbase
    d1 = params.lvl1.k * params.lvl1.n
    P, J, S, Mt = ks_layout(params)
    L, _, cols = ksk_limbs_sei.shape
    x = ksk_limbs_sei.reshape(L, t, nb, d1, cols).permute(0, 4, 3, 1, 2)
    x = F.pad(x.reshape(L, cols, d1, t * nb), (0, P - t * nb, 0, S * J - d1))
    x = F.pad(x.reshape(L, cols, S, J * P), (0, KS_STAGE_BYTES - J * P))
    x = F.pad(x.reshape(L, cols, S * KS_STAGE_BYTES),
              (0, 0, 0, Mt * KS_COL_TILE - cols))
    return x.reshape(L, Mt, KS_COL_TILE, S, KS_STAGE_BYTES).permute(
        1, 3, 0, 2, 4).contiguous()


def ks_stage_coeffs(a_in: torch.Tensor, params: GateParams) -> torch.Tensor:
    """[B, d1] int32 -> [B, S * 128] int8: the selection coefficients in the
    kernel's contraction order (ksk_tiles), zero at every padding byte."""
    kp = params.ks
    P, J, S, _ = ks_layout(params)
    B, d1 = a_in.shape
    tmp = a_in + i32(kp.decomp_offset + kp.roundoffset)
    shifts = torch.tensor([32 - (dig + 1) * kp.basebit for dig in range(kp.t)],
                          dtype=torch.int32, device=a_in.device)
    val = ((tmp[:, :, None] >> shifts) & ((1 << kp.basebit) - 1)
           ) - kp.numbase                              # [B, d1, t]
    m1 = torch.arange(1, kp.numbase + 1, dtype=torch.int32,
                      device=a_in.device)
    co = ((val[..., None] == -m1).to(torch.int8)
          - (val[..., None] == m1).to(torch.int8))     # [B, d1, t, nb]
    co = F.pad(co.reshape(B, d1, -1), (0, P - kp.t * kp.numbase,
                                       0, S * J - d1))
    return F.pad(co.reshape(B, S, J * P),
                 (0, KS_STAGE_BYTES - J * P)).reshape(B, -1)


@functools.lru_cache(maxsize=None)
def ks_plan(B: int, params: GateParams, sms: int = H100_SMS) -> tuple:
    """(row tile, split) of keyswitch_kernel for B rows at `params`: 64-row
    tiles up to 64 rows, 128 above; the split, the number of ranges the S
    stages are cut into (gridDim.z), is the one of least waves x (stages a
    range + KS_BLOCK_OVERHEAD) over the `sms` SMs, one block an SM.
    Cached: AES asks for it at every step."""
    row_tile = KS_ROW_TILES[0] if B <= KS_ROW_TILES[0] else KS_ROW_TILES[1]
    _, _, S, Mt = ks_layout(params)
    blocks = Mt * cdiv(B, row_tile)
    split = min(range(1, S + 1), key=lambda z: (
        cdiv(blocks * z, sms) * (cdiv(S, z) + KS_BLOCK_OVERHEAD), z))
    return row_tile, split


def _per_row(c, shape):
    """A pre-add constant: an int mod 2^32 (its int32 representative), or
    an int32 tensor of one value per row ([B] or [B, 1]) reshaped to
    `shape`."""
    return c.reshape(shape) if isinstance(c, torch.Tensor) else i32(c)


def _ks_inputs(tlwe1: torch.Tensor, params: GateParams, pre, perm):
    """(a_in [B, d1], b_in [B]) of a key switch: the gate linear
    combination pre = (ca, cb, offset, other) applied, then the mask
    columns gathered by perm; views of tlwe1 where neither is given."""
    d1 = params.lvl1.k * params.lvl1.n
    if pre is not None:
        ca, cb, off, other = pre
        comb = (_per_row(ca, (-1, 1)) * tlwe1
                + _per_row(cb, (-1, 1)) * other)
        a_in = comb[:, :d1]
        b_in = comb[:, d1] + _per_row(off, (-1,))
    else:
        a_in = tlwe1[:, :d1]
        b_in = tlwe1[:, d1]
    if perm is not None:
        a_in = a_in[:, perm]
    return a_in, b_in


def key_switch_ref(tlwe1: torch.Tensor, ksk: torch.Tensor,
                   params: GateParams, pre=None,
                   perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: for each column tile, the
    sum over its stages of the tile's four limbs [4 * 64, 128] (a view of
    ksk, in ksk_tiles' layout) times the stage's ks_stage_coeffs, through
    torus.int_mm; the limb sums shifted and added, column n0 plus the b
    term. Any device. Arguments and result as key_switch's."""
    n0 = params.lvl0.dim
    a_in, b_in = _ks_inputs(tlwe1, params, pre, perm)
    B = a_in.shape[0]
    Mt, S, L, C, SK = ksk.shape
    # [S, 128, B'] with the rows padded to a multiple of 8 (CUDA's _int_mm)
    co = F.pad(ks_stage_coeffs(a_in, params), (0, 0, 0, -B % 8))
    co = co.T.reshape(S, SK, -1).contiguous()
    out = torch.empty((Mt, C, co.shape[2]), dtype=torch.int32,
                      device=co.device)
    for mt in range(Mt):
        acc = int_mm(ksk[mt, 0].reshape(L * C, SK), co[0])
        for s in range(1, S):
            acc += int_mm(ksk[mt, s].reshape(L * C, SK), co[s])
        acc = acc.reshape(L, C, -1)
        out[mt] = sum(acc[l] << (LIMB_BITS * l) for l in range(L))
    out = out.reshape(Mt * C, -1)[:n0 + 1, :B].T.contiguous()
    out[:, n0] += b_in
    return out


def key_switch_cuda(tlwe1: torch.Tensor, ksk: torch.Tensor,
                    params: GateParams, pre=None,
                    perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One key switch through keyswitch_kernel: the pre-add and the perm
    gather, if given, as torch ops in front of one launch. tlwe1 [B, d1+1]
    int32 and ksk (ksk_tiles) on one CUDA device. Enqueued on the current
    stream; raises if the kernel cannot be built or launched."""
    kp = params.ks
    d1 = params.lvl1.k * params.lvl1.n
    n0 = params.lvl0.dim
    B = tlwe1.shape[0]
    _, _, S, Mt = ks_layout(params)
    tlwe1 = tlwe1.contiguous()
    check_cuda({"tlwe1": (tlwe1, torch.int32, (B, d1 + 1)),
                "ksk": (ksk, torch.int8, (Mt, S, NLIMBS, KS_COL_TILE,
                                          KS_STAGE_BYTES))})
    # a_in and b_in are views of tlwe1 or of new tensors, columns adjacent
    a_in, b_in = _ks_inputs(tlwe1, params, pre, perm)
    out = torch.zeros((B, n0 + 1), dtype=torch.int32, device=tlwe1.device)
    if B == 0:
        return out
    row_tile, split = ks_plan(B, params, sms(tlwe1.device))
    call("cufhe_key_switch", tlwe1.device, ksk.data_ptr(), a_in.data_ptr(),
         a_in.stride(0), b_in.data_ptr(), b_in.stride(0), out.data_ptr(), B,
         d1, n0, kp.t, kp.basebit,
         (kp.decomp_offset + kp.roundoffset) % (1 << 32), row_tile, split)
    count("key_switch")
    return out


def key_switch(tlwe1: torch.Tensor, ksk: torch.Tensor,
               params: GateParams, pre=None,
               perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KeySwitchFromTLWE / IdentityKeySwitchPreAdd, batched.

    tlwe1: [B, d1+1] int32; ksk: keys.DeviceKeys.ksk_tiles (ksk_tiles'
    layout) on tlwe1's device; pre = (ca, cb, offset, other) fuses the
    gate linear combination: ca, cb and offset are ints mod 2^32 or int32
    tensors with one value per row ([B] or [B, 1]), other is [B, d1+1].
    perm, if given, gathers the d1 mask columns after the pre-add
    (keys.DeviceKeys.sei_perm: a natural-order input against the
    sample-extract row order of ksk_tiles). Returns [B, n0+1] int32: the
    kernel on CUDA tensors, key_switch_ref on CPU tensors.
    """
    with span("cufhe.key_switch"):
        if tlwe1.device.type == "cuda":
            return key_switch_cuda(tlwe1, ksk, params, pre, perm)
        return key_switch_ref(tlwe1, ksk, params, pre, perm)
