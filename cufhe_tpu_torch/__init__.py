"""cufhe_tpu_torch — TFHE gate bootstrapping on PyTorch and CUDA.

The port of cufhe_tpu (JAX) to NVIDIA Hopper. It imports torch and never
JAX, nor the JAX package; the JAX package stays the reference it is tested
against. The client side (keygen, encrypt, decrypt) and the NumPy gate
oracle are golden.py, with params.py and rng.py: copies of their
cufhe_tpu namesakes, held equal to them by the tests.

Layers:
  golden, params, rng — client side, presets, CSPRNG (NumPy)
  torus   — int32-held torus arithmetic (logical shift, exact int8 GEMM)
  ops     — poly, key switch, key preparation, blind rotation (plain PyTorch
            and the CUDA kernel of csrc/), the lvl0 gate
  models  — Context and the gate API
"""
from .models import Context, Ctxt, decrypt_bits, encrypt_bits
from .params import (CGGI19, CONCRETE, DEFAULT, PALLAS_BG10, PALLAS_BG10_KAR,
                     PALLAS_KAR, PALLAS_TINY, PALLAS_TINY_K2, PRESETS,
                     RADIX4_2048, TFHEPP_128, TFHEPP_128_BG8, TFHEPP_80, TINY,
                     TINY_K2, TINY_Q, GateParams)

__all__ = ["Context", "Ctxt", "decrypt_bits", "encrypt_bits", "GateParams",
           "PRESETS", "DEFAULT", "TFHEPP_128", "TFHEPP_128_BG8", "TFHEPP_80",
           "CGGI19", "CONCRETE", "RADIX4_2048", "TINY", "TINY_Q", "TINY_K2",
           "PALLAS_TINY", "PALLAS_TINY_K2", "PALLAS_BG10", "PALLAS_KAR",
           "PALLAS_BG10_KAR"]
