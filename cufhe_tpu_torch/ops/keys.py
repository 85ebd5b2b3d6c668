"""Device key preparation: the counterpart of cufhe_tpu/ops/keys.py for the
lvl0 gate path.

The NumPy evaluation key (golden.EvalKey: bk [n0, (k+1)l, k+1, N] and ksk
[d1, t, numbase, n0+1], both uint32) is converted once to signed 8-bit limb
forms and moved to one device.
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
    """
    bk_ext: torch.Tensor
    ksk_limbs_sei: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.bk_ext.device


def ksk_limbs_sei(ksk: np.ndarray, params: GateParams) -> np.ndarray:
    """KSK [d1, t, numbase, n0+1] uint32 -> [NLIMBS, K, n0+1] int8 in the
    (dig, m, j) row order with the sample-extract permutation."""
    lp = params.lvl1
    d1, t, nb, cols = ksk.shape
    perm = np.arange(d1).reshape(lp.k, lp.n)
    perm = np.concatenate([perm[:, :1], perm[:, :0:-1]], axis=1).reshape(-1)
    kl = u32_to_signed_limbs(ksk[perm])             # [d1, t, nb, n0+1, L]
    return np.transpose(kl, (4, 1, 2, 0, 3)).reshape(NLIMBS, t * nb * d1, cols)


def prepare_keys(ek: EvalKey, device="cpu") -> DeviceKeys:
    """One-time host-side key conversion and upload to `device`."""
    p = ek.params

    def put(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return DeviceKeys(bk_ext=put(prepare_bk_ext(ek.bk, p)),
                      ksk_limbs_sei=put(ksk_limbs_sei(ek.ksk, p)))
