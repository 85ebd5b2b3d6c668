"""Torus arithmetic on torch tensors.

A torus value is an element of Z_{2^32}. The JAX package holds it as uint32;
here it is held as int32 that wraps. On the CPU, torch.uint32 has no add,
sub, neg, shifts or compares, while int32 add, sub, mul and neg wrap
mod 2^32 on both the CPU and CUDA. The one operation whose meaning differs
is the right shift: int32 `>>` is arithmetic, so every shift of a torus
value that needs the uint32 (logical) result goes through `srl`.
"""
from __future__ import annotations

import numpy as np
import torch

_MOD = 1 << 32


def from_u32(x: np.ndarray, device=None) -> torch.Tensor:
    """uint32 NumPy array -> int32 tensor with the same bits."""
    arr = np.array(x, dtype=np.uint32, order="C").view(np.int32)
    t = torch.from_numpy(arr)
    return t if device is None else t.to(device)


def to_u32(x: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 NumPy array with the same bits."""
    return x.detach().to("cpu").contiguous().numpy().view(np.uint32)


def i32(c: int) -> int:
    """The int32 representative of a Python int mod 2^32."""
    c %= _MOD
    return c - _MOD if c >= 1 << 31 else c


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32-held uint32 values by 0 < s < 32."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def _pad_to(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if x.shape[dim] == size:
        return x
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, size - x.shape[dim]]
    return torch.nn.functional.pad(x, pad)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M, K] @ int8 [K, N] -> int32 [M, N] (torch._int_mm).

    A plain `int8 @ int8` would wrap in int8. The CPU's _int_mm takes any
    shape. CUDA's takes only M > 16 and K, N multiples of 8 (it raises
    otherwise; probed on an H100 with torch 2.x, see ROADMAP F7), so on
    CUDA the operands are zero-padded up to that, which leaves the product
    unchanged, and the result is sliced back.
    """
    if a.device.type != "cuda":
        return torch._int_mm(a.contiguous(), b.contiguous())
    M, K = a.shape
    N = b.shape[1]
    Mp = max(M, 17)
    Kp = -(-K // 8) * 8
    Np = -(-N // 8) * 8
    out = torch._int_mm(_pad_to(_pad_to(a, 0, Mp), 1, Kp).contiguous(),
                        _pad_to(_pad_to(b, 0, Kp), 1, Np).contiguous())
    return out[:M, :N]
