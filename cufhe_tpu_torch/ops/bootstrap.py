"""Gate bootstrapping at lvl0: the counterpart of the main-path part of
cufhe_tpu/ops/bootstrap.py, bit-exact to it.

    gate_lvl0 = pre-add -> mod switch + rotated test vector -> n0-step
                blind rotation -> sample extraction (key-switch input form)
                -> key switch back to lvl0
"""
from __future__ import annotations

import torch

from ..params import GateParams
from ..torus import i32, srl
from . import blind_rotate as BR
from .keys import DeviceKeys
from .keyswitch import key_switch
from .poly import batched_test_vector, sample_extract_for_ks


def _mod_switch(phase: torch.Tensor, nbit: int) -> torch.Tensor:
    """modSwitchFromTorus: the top nbit+1 bits of the uint32 phase. A
    logical shift: int32 `>>` would carry the sign bit down."""
    return srl(phase, 32 - 1 - nbit)


def encode_gate_consts(gate_consts, mu: int) -> tuple[int, int, int]:
    """(ca, cb, om) from golden.GATE_CONSTANTS -> int32 representatives of
    (ca, cb, om*mu) mod 2^32."""
    ca, cb, om = gate_consts
    return i32(ca), i32(cb), i32(om * mu)


def _pre_add(in0, in1, ca, cb, off, dim):
    comb = ca * in0 + cb * in1
    return comb[:, :dim], comb[:, dim] + off


def blind_rotate(a: torch.Tensor, b: torch.Tensor, mu: int, keys: DeviceKeys,
                 params: GateParams) -> torch.Tensor:
    """BlindRotate, batched. a: [B, n0] mask, b: [B] body (gate pre-add
    already applied). Returns the TRLWE accumulator [B, k+1, N] int32."""
    lp = params.lvl1
    bar = 2 * lp.n - _mod_switch(b, lp.nbit)
    acc = batched_test_vector(bar, mu, lp)
    return blind_rotate_acc(acc, a, keys, params)


def blind_rotate_acc(acc: torch.Tensor, a: torch.Tensor, keys: DeviceKeys,
                     params: GateParams) -> torch.Tensor:
    """The n0-step CMUX loop from an explicit initial accumulator
    [B, k+1, N]. The rounded mod switch of every mask coefficient is done
    here, on a's device, as abar [n0, B] int32."""
    lp = params.lvl1
    roundoffset = 1 << (32 - 2 - lp.nbit)
    abar = _mod_switch(a + roundoffset, lp.nbit).T.contiguous()
    return BR.blind_rotate(acc, abar, keys.bk_ext, params)


def gate_lvl0(gate_consts, in0: torch.Tensor, in1: torch.Tensor,
              keys: DeviceKeys, params: GateParams) -> torch.Tensor:
    """HomGate in br -> iks order: lvl0 inputs [B, n0+1], the pre-add fused
    into the mod switch, blind rotation, extraction, key switch back to
    lvl0. gate_consts is (ca, cb, om) as in golden.GATE_CONSTANTS."""
    ca, cb, off = encode_gate_consts(gate_consts, params.lvl0.mu)
    n0 = params.lvl0.dim
    a, b = _pre_add(in0, in1, ca, cb, off, n0)
    acc = blind_rotate(a, b, params.lvl1.mu, keys, params)
    # the extraction's index reversal lives in the KSK row permutation
    tlwe1 = sample_extract_for_ks(acc, params.lvl1)
    return key_switch(tlwe1, keys.ksk_limbs_sei, params)
