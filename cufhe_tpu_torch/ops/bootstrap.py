"""Gate bootstrapping programs: the counterpart of cufhe_tpu/ops/bootstrap.py,
bit-exact to it.

    gate_lvl0 = pre-add -> mod switch + rotated test vector -> n0-step
                blind rotation -> sample extraction (key-switch input form)
                -> key switch back to lvl0
    gate_lvl1 = key switch with the pre-add fused -> blind rotation ->
                sample extraction (lvl1 out)

and the paths built from the same pieces: mux/nmux (two rotations summed),
per-row gate constants (gate_rows), custom test vectors (programmable
bootstrapping), the rounded mod switch of PBSmanyLUT (pbs_many), CMUX on a
user TRGSW, refresh and the TLWE -> TRLWE bootstrap.

Every op that rotates takes the JAX package's `backend=` name
(resolve_backend). The exact backends go through ops/blind_rotate.py: the
CUDA kernel for CUDA tensors, its plain version for CPU tensors; so does
"pallas3", with a three-limb key (the kernel's three-limb instance, never
the exact one). "ntt" runs the RAINTT-prime external product of
ops/ntt.py as torch ops on the tensors' device, and never the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..params import GateParams
from ..torus import i32, srl
from ..utils.spans import count, span
from . import blind_rotate as BR
from . import ntt as NTT
from .keys import DeviceKeys
from .keyswitch import key_switch
from .poly import (batched_test_vector, decompose, decompose_rotate_sub,
                   negacyclic_conv_toeplitz, rotate_by_xai,
                   sample_extract_for_ks, sample_extract_index0,
                   split_decomp_digits)

#: the JAX package's backend names whose results are exact and equal to
#: each other ("auto" picks one of them there); the port runs every one as
#: its one exact path (the blind rotation of ops/blind_rotate.py)
EXACT_BACKENDS = ("auto", "pallas", "conv", "toeplitz")
#: the port's paths: the exact rotation, its reduced-precision `pallas3`
#: instance (a three-limb key), the RAINTT `ntt` path
PATHS = ("pallas", "pallas3", "ntt")


def resolve_backend(backend: str) -> str:
    """The port's path for a JAX backend name: "pallas" for every exact
    backend, "pallas3" for the reduced-precision one, "ntt" for the RAINTT
    parity path; any other name is refused."""
    if backend in EXACT_BACKENDS:
        return "pallas"
    if backend in PATHS:
        return backend
    raise ValueError(f"unknown backend {backend!r}; the port's backends are "
                     f"{EXACT_BACKENDS}, 'pallas3' and 'ntt'")


def _mod_switch(phase: torch.Tensor, nbit: int) -> torch.Tensor:
    """modSwitchFromTorus: the top nbit+1 bits of the uint32 phase. A
    logical shift: int32 `>>` would carry the sign bit down."""
    return srl(phase, 32 - 1 - nbit)


def _mod_switch_round(phase: torch.Tensor, nbit: int,
                      theta: int) -> torch.Tensor:
    """Mod switch rounded to a multiple of 2^theta windows (PBSmanyLUT;
    golden.mod_switch_round), in [0, 2N). theta=0 equals the rounded
    a-coefficient switch _mod_switch(x + roundoffset). The add wraps as
    uint32 and the shift is logical (srl)."""
    sh = 32 - 1 - nbit + theta
    return srl(phase + i32(1 << (sh - 1)), sh) << theta


def encode_gate_consts(gate_consts, mu: int) -> tuple[int, int, int]:
    """(ca, cb, om) from golden.GATE_CONSTANTS -> int32 representatives of
    (ca, cb, om*mu) mod 2^32."""
    ca, cb, om = gate_consts
    return i32(ca), i32(cb), i32(om * mu)


def encode_gate_consts_rows(names, mu: int, device=None) -> torch.Tensor:
    """[len(names), 3] int32 per-row constants: row i holds (ca, cb,
    om*mu) of gate names[i]. Passed as `gate_consts` (tiled to the batch),
    one call evaluates a mix of the ten two-input gates."""
    from ..golden import GATE_CONSTANTS
    rows = [encode_gate_consts(GATE_CONSTANTS[nm], mu) for nm in names]
    return torch.tensor(rows, dtype=torch.int32,
                        device=device).reshape(len(rows), 3)


def _gate_coeffs(gate_consts, mu: int):
    """(ca, cb, offset) of a gate: a (ca, cb, om) int tuple from
    golden.GATE_CONSTANTS, or per-row int32 constants [B, 3] from
    encode_gate_consts_rows (ca and cb as [B, 1], offset as [B])."""
    if isinstance(gate_consts, torch.Tensor):
        if gate_consts.dim() != 2 or gate_consts.shape[1] != 3:
            raise ValueError(f"per-row gate constants must be [B, 3], got "
                             f"{tuple(gate_consts.shape)}")
        return (gate_consts[:, 0:1], gate_consts[:, 1:2], gate_consts[:, 2])
    return encode_gate_consts(gate_consts, mu)


def _pre_add(in0, in1, ca, cb, off, dim):
    comb = ca * in0 + cb * in1
    return comb[:, :dim], comb[:, dim] + off


def blind_rotate(a: torch.Tensor, b: torch.Tensor, mu: int, keys: DeviceKeys,
                 params: GateParams, backend: str = "auto") -> torch.Tensor:
    """BlindRotate, batched. a: [B, n0] mask, b: [B] body (gate pre-add
    already applied). Returns the TRLWE accumulator [B, k+1, N] int32."""
    lp = params.lvl1
    bar = 2 * lp.n - _mod_switch(b, lp.nbit)
    acc = batched_test_vector(bar, mu, lp)
    return blind_rotate_acc(acc, a, keys, params, backend)


def blind_rotate_tv(a: torch.Tensor, b: torch.Tensor, tv: torch.Tensor,
                    keys: DeviceKeys, params: GateParams,
                    backend: str = "auto",
                    theta: Optional[int] = None) -> torch.Tensor:
    """Blind rotation of a custom test polynomial tv ([N] or [B, N] int32):
    the returned TRLWE's constant slot carries tv at the mod-switched input
    phase (negacyclic: windows N..2N-1 see -tv). theta=None switches b by
    truncation, as blind_rotate; an int selects the PBSmanyLUT rounded
    switch for b and every a coefficient."""
    lp = params.lvl1
    B = a.shape[0]
    if theta is None:
        bar = 2 * lp.n - _mod_switch(b, lp.nbit)
    else:
        bar = 2 * lp.n - _mod_switch_round(b, lp.nbit, theta)
    acc0 = torch.zeros((B, lp.k + 1, lp.n), dtype=torch.int32,
                       device=a.device)
    acc0[:, lp.k, :] = tv
    # bar == 2N (b = 0) wraps to rotation 0 under the mask
    acc = rotate_by_xai(acc0, bar & (2 * lp.n - 1), lp)
    return blind_rotate_acc(acc, a, keys, params, backend, theta=theta)


def blind_rotate_acc(acc: torch.Tensor, a: torch.Tensor, keys: DeviceKeys,
                     params: GateParams, backend: str = "auto",
                     theta: Optional[int] = None) -> torch.Tensor:
    """The n0-step CMUX loop from an explicit initial accumulator
    [B, k+1, N]. The mod switch of every mask coefficient is done here, on
    a's device, as abar [n0, B] int32: rounded (theta None or 0), or
    rounded to multiples of 2^theta windows (PBSmanyLUT). Every path reads
    the same abar."""
    lp = params.lvl1
    if theta:
        abar = _mod_switch_round(a, lp.nbit, theta)
    else:
        abar = _mod_switch(a + (1 << (32 - 2 - lp.nbit)), lp.nbit)
    abar = abar.T.contiguous()
    path = resolve_backend(backend)
    if path == "ntt":
        return blind_rotate_ntt(acc, abar, keys, params)
    return BR.blind_rotate(acc, abar, keys.bk_ext, params,
                           3 if path == "pallas3" else 4)


def blind_rotate_ntt(acc: torch.Tensor, abar: torch.Tensor, keys: DeviceKeys,
                     params: GateParams) -> torch.Tensor:
    """The `ntt` backend's n0-step loop (the reference's
    USE_SMALL_NTT_MODULUS gate mode; JAX bootstrap.py:201-235): each step
    lifts the digits to Z_p, transforms them, multiplies-accumulates with
    the key's NTT (Shoup), transforms back and adds the result, switched
    to the torus by mod_to_torus_jax, to the accumulator. acc [B, k+1, N]
    int32, abar [n0, B] int32; returns a new accumulator."""
    lp = params.lvl1
    tabs = NTT.make_tables(lp.nbit)
    for i in range(params.lvl0.dim):
        dec = decompose_rotate_sub(acc, abar[i], lp).long()   # [B, I, N]
        dntt = NTT.ntt_forward(torch.where(dec < 0, dec + NTT.P, dec), tabs)
        bk_i = keys.bk_ntt[i].long()                          # [I, k+1, N]
        sh_i = keys.bk_ntt_shoup[i].long() & 0xFFFFFFFF
        # sum over I of dntt * bk mod p: each product is < p, so the int64
        # sum of the (k+1)l terms is exact and one reduction equals the JAX
        # package's chain of addmods
        prod = NTT.pointwise_mul(dntt[:, :, None, :], bk_i, sh_i)
        upd = NTT.ntt_inverse(prod.sum(dim=1) % NTT.P, tabs)
        acc = acc + NTT.to_i32(NTT.mod_to_torus_jax(upd))
    return acc


def _key_switch_lvl1(x: torch.Tensor, keys: DeviceKeys, params: GateParams,
                     pre=None) -> torch.Tensor:
    """Key switch of natural-order lvl1 ciphertexts [B, k*N+1] through the
    one KSK kept (ksk_tiles): the mask columns are gathered by the
    involution sei_perm after the pre-add."""
    return key_switch(x, keys.ksk_tiles, params, pre=pre,
                      perm=keys.sei_perm)


def gate_lvl0(gate_consts, in0: torch.Tensor, in1: torch.Tensor,
              keys: DeviceKeys, params: GateParams,
              backend: str = "auto") -> torch.Tensor:
    """HomGate in br -> iks order: lvl0 inputs [B, n0+1], the pre-add fused
    into the mod switch, blind rotation, extraction, key switch back to
    lvl0. gate_consts is (ca, cb, om) as in golden.GATE_CONSTANTS, or
    per-row constants [B, 3] (encode_gate_consts_rows)."""
    with span("cufhe.gate"):
        ca, cb, off = _gate_coeffs(gate_consts, params.lvl0.mu)
        n0 = params.lvl0.dim
        a, b = _pre_add(in0, in1, ca, cb, off, n0)
        acc = blind_rotate(a, b, params.lvl1.mu, keys, params, backend)
        # the extraction's index reversal lives in the KSK row permutation
        tlwe1 = sample_extract_for_ks(acc, params.lvl1)
        return key_switch(tlwe1, keys.ksk_tiles, params)


def gate_lvl1(gate_consts, in0: torch.Tensor, in1: torch.Tensor,
              keys: DeviceKeys, params: GateParams,
              backend: str = "auto") -> torch.Tensor:
    """HomGate in iks -> br order: lvl1 inputs [B, k*N+1], the pre-add
    fused into the key switch, blind rotation, extraction to lvl1."""
    with span("cufhe.gate"):
        ca, cb, off = _gate_coeffs(gate_consts, params.lvl1.mu)
        n0 = params.lvl0.dim
        tlwe0 = _key_switch_lvl1(in0, keys, params, pre=(ca, cb, off, in1))
        acc = blind_rotate(tlwe0[:, :n0], tlwe0[:, n0], params.lvl1.mu, keys,
                           params, backend)
        return sample_extract_index0(acc, params.lvl1)


def mux_lvl0(inc, in1, in0, keys: DeviceKeys, params: GateParams,
             negate: bool = False, backend: str = "auto") -> torch.Tensor:
    """Mux(inc ? in1 : in0) on lvl0 inputs (nmux with negate): the
    AND(c, in1) and ANDNY(c, in0) rotations summed, b += mu (negated
    first for nmux), extraction, key switch."""
    with span("cufhe.gate.mux"):
        count("mux")
        count("mux.rows", inc.shape[0])
        n0 = params.lvl0.dim
        mu0, mu1 = params.lvl0.mu, params.lvl1.mu
        a1, b1 = _pre_add(inc, in1, 1, 1, i32(-mu0), n0)
        acc1 = blind_rotate(a1, b1, mu1, keys, params, backend)
        a0, b0 = _pre_add(inc, in0, -1, 1, i32(-mu0), n0)
        acc0 = blind_rotate(a0, b0, mu1, keys, params, backend)
        acc = acc1 + acc0
        if negate:
            acc = -acc
        acc[:, params.lvl1.k, 0] += i32(-mu1 if negate else mu1)
        tlwe1 = sample_extract_for_ks(acc, params.lvl1)
        return key_switch(tlwe1, keys.ksk_tiles, params)


def mux_lvl1(inc, in1, in0, keys: DeviceKeys, params: GateParams,
             negate: bool = False, backend: str = "auto") -> torch.Tensor:
    """Mux on lvl1 inputs: two key switches with the pre-add fused, two
    rotations, the TRLWEs summed, extraction, b +- mu."""
    with span("cufhe.gate.mux"):
        count("mux")
        count("mux.rows", inc.shape[0])
        n0 = params.lvl0.dim
        d1 = params.lvl1.k * params.lvl1.n
        mu1 = params.lvl1.mu
        t1 = _key_switch_lvl1(inc, keys, params, pre=(1, 1, -mu1, in1))
        acc1 = blind_rotate(t1[:, :n0], t1[:, n0], mu1, keys, params, backend)
        t0 = _key_switch_lvl1(inc, keys, params, pre=(-1, 1, -mu1, in0))
        acc0 = blind_rotate(t0[:, :n0], t0[:, n0], mu1, keys, params, backend)
        out = sample_extract_index0(acc1 + acc0, params.lvl1)
        if negate:
            out = -out
        out[:, d1] += i32(-mu1 if negate else mu1)
        return out


def not_gate(ct: torch.Tensor) -> torch.Tensor:
    """Negation, no bootstrap."""
    return -ct


def copy_gate(ct: torch.Tensor) -> torch.Tensor:
    return ct


def cmux(trgsw_limbs: torch.Tensor, c1: torch.Tensor, c0: torch.Tensor,
         params: GateParams) -> torch.Tensor:
    """c0 + trgsw (external product) (c1 - c0), batched over TRLWEs
    [B, k+1, N]: one exact negacyclic product in plain PyTorch
    (poly.negacyclic_conv_toeplitz), as the JAX package leaves this single
    product to XLA. trgsw_limbs comes from keys.prepare_trgsw."""
    lp = params.lvl1
    dec = decompose(c1 - c0 + i32(lp.decomp_offset + lp.decomp_roundoffset),
                    lp)
    parts, bits = split_decomp_digits(dec, lp.Bgbit)
    out = c0
    for dl, d8 in enumerate(parts):
        out = out + (negacyclic_conv_toeplitz(d8, trgsw_limbs, lp.k)
                     << (bits * dl))
    return out


def refresh(trlwe: torch.Tensor, keys: DeviceKeys, params: GateParams,
            backend: str = "auto") -> torch.Tensor:
    """TRLWE -> TRLWE noise refresh: extraction, key switch, blind rotation
    from the key-switched sample (golden.refresh)."""
    return bootstrap_tlwe2trlwe(sei_and_ks(trlwe, keys, params),
                                params.lvl1.mu, keys, params, backend)


def bootstrap_tlwe2trlwe(tlwe0: torch.Tensor, mu: int, keys: DeviceKeys,
                         params: GateParams,
                         backend: str = "auto") -> torch.Tensor:
    """Gate bootstrapping of lvl0 TLWEs [B, n0+1] to TRLWEs [B, k+1, N]."""
    n0 = params.lvl0.dim
    return blind_rotate(tlwe0[:, :n0], tlwe0[:, n0], mu, keys, params,
                        backend)


def sei_and_ks(trlwe: torch.Tensor, keys: DeviceKeys,
               params: GateParams) -> torch.Tensor:
    """Sample extraction of coefficient 0 and key switch to lvl0."""
    return key_switch(sample_extract_for_ks(trlwe, params.lvl1),
                      keys.ksk_tiles, params)


def pbs_tlwe2trlwe(tlwe0: torch.Tensor, tv: torch.Tensor, keys: DeviceKeys,
                   params: GateParams, backend: str = "auto") -> torch.Tensor:
    """Programmable bootstrap, TLWE -> TRLWE: blind-rotate a custom test
    polynomial tv ([N] or [B, N] int32) by the input phase."""
    n0 = params.lvl0.dim
    return blind_rotate_tv(tlwe0[:, :n0], tlwe0[:, n0], tv, keys, params,
                           backend)


def programmable_bootstrap(tlwe0: torch.Tensor, tv: torch.Tensor,
                           keys: DeviceKeys, params: GateParams,
                           backend: str = "auto") -> torch.Tensor:
    """Custom-test-vector blind rotation, extraction, key switch to lvl0.
    The output encrypts tv[w] (or -tv[w - N]) for the mod-switched phase
    window w of the input."""
    return sei_and_ks(pbs_tlwe2trlwe(tlwe0, tv, keys, params, backend), keys,
                      params)


def pbs_many(tlwe0: torch.Tensor, tv: torch.Tensor, J: int, keys: DeviceKeys,
             params: GateParams, backend: str = "auto",
             theta: Optional[int] = None) -> torch.Tensor:
    """Multi-output programmable bootstrap (PBSmanyLUT): one blind rotation
    with the mod switch rounded to 2^theta windows, so accumulator
    coefficient j is tv[w + j]; J negacyclic rotations by X^-j share one
    batched extraction and key switch. tlwe0 [B, n0+1], tv [N] or [B, N].
    Returns [J, B, n0+1]: output j encrypts LUT j of the input."""
    if theta is None:
        theta = (J - 1).bit_length()
    if J > 1 << theta:
        raise ValueError(f"J = {J} outputs need theta >= "
                         f"{(J - 1).bit_length()}, got {theta}")
    n0 = params.lvl0.dim
    lp = params.lvl1
    acc = blind_rotate_tv(tlwe0[:, :n0], tlwe0[:, n0], tv, keys, params,
                          backend, theta=theta)
    B = acc.shape[0]
    rots = [acc] + [rotate_by_xai(acc, torch.full((B,), 2 * lp.n - j,
                                                  dtype=torch.int32,
                                                  device=acc.device), lp)
                    for j in range(1, J)]
    out = key_switch(sample_extract_for_ks(torch.cat(rots), lp),
                     keys.ksk_tiles, params)
    return out.reshape(J, B, n0 + 1)
