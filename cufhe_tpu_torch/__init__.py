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
            and the CUDA kernel of csrc/), gates at both levels, mux, CMUX,
            refresh, programmable and multi-output bootstrapping
  models  — Context and the gate API (streams, the key lifecycle),
            composite circuits (circuits), encrypted integers on
            multi-output bootstrapping (integers: IntContext) and the TOY8
            encrypted processor (processor)
  compat  — the v1 cuFHE API (SetSeed, KeyGen, Initialize, Encrypt,
            capitalised gates, Synchronize, CleanUp)
  runtime — circuit builder and level scheduler (C++ core), Bristol
            import, AES-128 / SHA-256 netlists, the schedule executor,
            streams on CUDA streams and events
  utils   — key and ciphertext files, CUDA-event timing
  benchmarks — the tensor-core probe (plain PyTorch and the CUDA kernels
            of csrc/mxu_peak*.cu), AES-128, SHA-256, the stream stress
            test, encrypted integers, the TOY8 processor
"""
from .models import Context, Ctxt, TrlweCtxt, decrypt_bits, encrypt_bits
from .params import (CGGI19, CONCRETE, DEFAULT, PALLAS_BG10, PALLAS_BG10_KAR,
                     PALLAS_KAR, PALLAS_TINY, PALLAS_TINY_K2, PRESETS,
                     RADIX4_2048, TFHEPP_128, TFHEPP_128_BG8, TFHEPP_80, TINY,
                     TINY_K2, TINY_Q, GateParams)

__all__ = ["Context", "Ctxt", "TrlweCtxt", "decrypt_bits", "encrypt_bits",
           "GateParams", "PRESETS", "DEFAULT", "TFHEPP_128", "TFHEPP_128_BG8",
           "TFHEPP_80", "CGGI19", "CONCRETE", "RADIX4_2048", "TINY", "TINY_Q",
           "TINY_K2", "PALLAS_TINY", "PALLAS_TINY_K2", "PALLAS_BG10",
           "PALLAS_KAR", "PALLAS_BG10_KAR"]
