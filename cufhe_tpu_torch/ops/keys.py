"""Device key preparation: the counterpart of cufhe_tpu/ops/keys.py.

The NumPy evaluation key (golden.EvalKey: bk [n0, (k+1)l, k+1, N] and ksk
[d1, t, numbase, n0+1], both uint32) is converted once to signed 8-bit limb
forms and moved to one device; so is a user TRGSW for CMUX (prepare_trgsw).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..golden import EvalKey
from ..params import GateParams
from .blind_rotate import prepare_bk_ext
from .limbs import NLIMBS, u32_to_signed_limbs


@dataclasses.dataclass(frozen=True)
class DeviceKeys:
    """Limb-encoded evaluation keys on one device.

    bk_ext: [n0, I, k+1, NLIMBS, 2N] int8, I = (k+1)*l*nd: the limbs of the
        extended generators [-bk, bk] (blind_rotate.prepare_bk_ext). The
        CUDA kernel and the plain blind rotation both read it.
    ksk_limbs_sei: [NLIMBS, t*numbase*k*N, n0+1] int8 with contraction
        index (dig*numbase + m)*k*N + j, each component's rows permuted by
        the negacyclic reversal j -> (N - j) mod N, so
        key_switch(poly.sample_extract_for_ks(acc)) equals the key switch
        of the true extraction.
    sei_perm: [k*N] int64, that permutation (sei_perm()). It is an
        involution, so the one KSK also serves key switches of natural-order
        inputs (lvl1 ciphertexts): key_switch(x, natural KSK) equals
        key_switch(x with its first k*N columns gathered by sei_perm,
        ksk_limbs_sei). No second, natural-order KSK is kept (41.7 MB at
        tfhepp_128bit).
    """
    bk_ext: torch.Tensor
    ksk_limbs_sei: torch.Tensor
    sei_perm: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.bk_ext.device


def sei_perm(params: GateParams) -> np.ndarray:
    """The negacyclic index reversal j -> (N - j) mod N within each of the
    k lvl1 components: [k*N] int64, its own inverse."""
    lp = params.lvl1
    perm = np.arange(lp.k * lp.n).reshape(lp.k, lp.n)
    return np.concatenate([perm[:, :1], perm[:, :0:-1]], axis=1).reshape(-1)


def ksk_limbs_sei(ksk: np.ndarray, params: GateParams) -> np.ndarray:
    """KSK [d1, t, numbase, n0+1] uint32 -> [NLIMBS, K, n0+1] int8 in the
    (dig, m, j) row order with the sample-extract permutation."""
    d1, t, nb, cols = ksk.shape
    kl = u32_to_signed_limbs(ksk[sei_perm(params)])  # [d1, t, nb, n0+1, L]
    return np.transpose(kl, (4, 1, 2, 0, 3)).reshape(NLIMBS, t * nb * d1, cols)


def prepare_trgsw(trgsw: np.ndarray, params: GateParams,
                  device="cuda") -> torch.Tensor:
    """Limb-encode one user TRGSW [(k+1)l, k+1, N] uint32 for CMUX: the
    natural-order limbs [NLIMBS, (k+1)l, k+1, N] int8 on `device`, the
    operand poly.negacyclic_conv_toeplitz reads."""
    want = ((params.lvl1.k + 1) * params.lvl1.l, params.lvl1.k + 1,
            params.lvl1.n)
    if tuple(trgsw.shape) != want:
        raise ValueError(f"TRGSW must be {want}, got {tuple(trgsw.shape)}")
    limbs = u32_to_signed_limbs(np.asarray(trgsw, dtype=np.uint32))
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(limbs, 3, 0))).to(device)


#: how each DeviceKeys field is built from the host EvalKey
_FIELDS = {"bk_ext": lambda ek: prepare_bk_ext(ek.bk, ek.params),
           "ksk_limbs_sei": lambda ek: ksk_limbs_sei(ek.ksk, ek.params),
           "sei_perm": lambda ek: sei_perm(ek.params)}


def prepare_fields(ek: EvalKey, names, device="cuda") -> dict:
    """The named DeviceKeys fields, converted on the host and uploaded to
    `device` (Context.prepare_backend rebuilds released ones with it)."""
    return {n: torch.from_numpy(np.ascontiguousarray(_FIELDS[n](ek))
                                ).to(device) for n in names}


def prepare_keys(ek: EvalKey, device="cuda") -> DeviceKeys:
    """One-time host-side key conversion and upload to `device` (by
    default the card)."""
    return DeviceKeys(**prepare_fields(ek, _FIELDS, device))
