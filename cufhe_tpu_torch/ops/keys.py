"""Device key preparation: the counterpart of cufhe_tpu/ops/keys.py.

The NumPy evaluation key (golden.EvalKey: bk [n0, (k+1)l, k+1, N] and ksk
[d1, t, numbase, n0+1], both uint32) is converted once to the forms the
blind rotation and the key switch read, and moved to one device; so is a
user TRGSW for CMUX (prepare_trgsw). Only the forms a context's path needs
are built (KEY_FORMS).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..golden import EvalKey
from ..params import GateParams
from ..torus import from_u32
from . import ntt as NTT
from .blind_rotate import prepare_bk_ext
from .keyswitch import ksk_tiles
from .limbs import NLIMBS, u32_to_signed_limbs


@dataclasses.dataclass(frozen=True)
class DeviceKeys:
    """Evaluation keys on one device. A field of a form the context does
    not use is an empty tensor.

    bk_ext: [n0, I, k+1, L, W] int8, I = (k+1)*l*nd: the limbs of the
        extended generators [-bk, bk] (blind_rotate.prepare_bk_ext; W =
        2N), or of their 3^d Karatsuba leaf generators at the depth
        d = blind_rotate.kar_depth(params, L) (W = leaf_width(N, d)),
        L = 4 for the exact path, 3 (the top three, d = 0) for pallas3.
        Built on the device. The CUDA kernel and the plain blind rotation
        both read it.
    ksk_tiles: [ceil((n0+1)/64), S, NLIMBS, 64, 128] int8, the KSK in
        the key switch kernel's layout (keyswitch.ksk_tiles of
        ksk_limbs_sei()): the input coefficients j permuted by the
        negacyclic reversal j -> (N - j) mod N within each component, so
        key_switch(poly.sample_extract_for_ks(acc)) equals the key switch
        of the true extraction. The kernel and the plain key switch both
        read it; it is the one KSK on the device.
    sei_perm: [k*N] int64, that permutation (sei_perm()). It is an
        involution, so the one KSK also serves key switches of natural-order
        inputs (lvl1 ciphertexts): key_switch(x, natural KSK) equals
        key_switch(x with its first k*N columns gathered by sei_perm,
        ksk_tiles). No second, natural-order KSK is kept (41.9 MB at
        tfhepp_128bit).
    bk_ntt, bk_ntt_shoup: [n0, (k+1)l, k+1, N] int32 holding uint32 bits:
        the key lifted to Z_p and transformed (ntt.ntt_forward_host), and
        the Shoup companions of its values, read by the `ntt` path.
    """
    bk_ext: torch.Tensor
    ksk_tiles: torch.Tensor
    sei_perm: torch.Tensor
    bk_ntt: torch.Tensor
    bk_ntt_shoup: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.ksk_tiles.device


def sei_perm(params: GateParams) -> np.ndarray:
    """The negacyclic index reversal j -> (N - j) mod N within each of the
    k lvl1 components: [k*N] int64, its own inverse."""
    lp = params.lvl1
    perm = np.arange(lp.k * lp.n).reshape(lp.k, lp.n)
    return np.concatenate([perm[:, :1], perm[:, :0:-1]], axis=1).reshape(-1)


def ksk_limbs_sei(ksk: np.ndarray, params: GateParams) -> np.ndarray:
    """KSK [d1, t, numbase, n0+1] uint32 -> [NLIMBS, K, n0+1] int8 in the
    (dig, m, j) row order with the sample-extract permutation: the JAX
    package's layout of the same name, which keyswitch.ksk_tiles re-lays
    into the kernel's."""
    d1, t, nb, cols = ksk.shape
    kl = u32_to_signed_limbs(ksk[sei_perm(params)])  # [d1, t, nb, n0+1, L]
    return np.transpose(kl, (4, 1, 2, 0, 3)).reshape(NLIMBS, t * nb * d1, cols)


def prepare_bk_ntt(bk: np.ndarray, params: GateParams):
    """BK [n0, (k+1)l, k+1, N] uint32 -> (its NTT over Z_p, the Shoup
    companions), both uint32 of the same shape (the JAX package's
    prepare_keys, keys.py:133-138)."""
    tabs = NTT.make_tables(params.lvl1.nbit)
    fwd = NTT.ntt_forward_host(NTT.torus_to_mod_host(bk), tabs)
    return fwd, NTT.shoup_precompute(fwd)


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


#: the DeviceKeys fields of each key form, the unit of preparation and of
#: Context.release_keys: "pallas" is the exact blind rotation's key,
#: "pallas3" the same field at three limbs, "ntt" the ntt path's, "ksk"
#: every key switch's
KEY_FORMS = {"pallas": ("bk_ext",),
             "pallas3": ("bk_ext",),
             "ntt": ("bk_ntt", "bk_ntt_shoup"),
             "ksk": ("ksk_tiles", "sei_perm")}

_EMPTY_DTYPES = {"bk_ext": torch.int8, "ksk_tiles": torch.int8,
                 "sei_perm": torch.int64, "bk_ntt": torch.int32,
                 "bk_ntt_shoup": torch.int32}


def _build_form(ek: EvalKey, form: str, device) -> dict:
    """The fields of one key form on `device`: the rotation's key uploaded
    as uint32 and converted there, the KSK's limbs uploaded and laid out
    there, the others converted on the host and uploaded."""
    p = ek.params
    if form in ("pallas", "pallas3"):
        return {"bk_ext": prepare_bk_ext(
            from_u32(ek.bk, device), p, 3 if form == "pallas3" else NLIMBS)}
    elif form == "ntt":
        fwd, shoup = prepare_bk_ntt(ek.bk, p)
        return {"bk_ntt": from_u32(fwd, device),
                "bk_ntt_shoup": from_u32(shoup, device)}
    elif form == "ksk":
        limbs = torch.from_numpy(ksk_limbs_sei(ek.ksk, p)).to(device)
        return {"ksk_tiles": ksk_tiles(limbs, p),
                "sei_perm": torch.from_numpy(sei_perm(p)).to(device)}
    raise ValueError(f"unknown key form {form!r}")


def prepare_fields(ek: EvalKey, forms, device="cuda") -> dict:
    """The DeviceKeys fields of the named key forms on `device`
    (Context.prepare_backend rebuilds released ones with it). "pallas" and
    "pallas3" share bk_ext: one key precision per context, as in the JAX
    package (keys.py:144-148)."""
    if "pallas" in forms and "pallas3" in forms:
        raise ValueError("choose one pallas key precision per Context")
    out = {}
    for form in forms:
        out.update(_build_form(ek, form, device))
    return out


def prepare_keys(ek: EvalKey, device="cuda",
                 backends=("pallas",)) -> DeviceKeys:
    """One-time host-side key conversion and upload to `device` (by
    default the card): the key switch's form and those of `backends` (key
    forms: "pallas" or "pallas3", and/or "ntt"); every other field is left
    empty."""
    device = torch.device(device)
    fields = prepare_fields(ek, ("ksk", *backends), device)
    for name, dtype in _EMPTY_DTYPES.items():
        fields.setdefault(name, torch.empty((0,), dtype=dtype, device=device))
    return DeviceKeys(**fields)
