"""Server/client key separation with serialization and a data-parallel
mesh.

The counterpart of examples/03_server_client_split.py on PyTorch. The
client generates keys and encrypts; the server holds only the evaluation
key (never the secret key), evaluates gates over a device mesh and returns
ciphertexts. Key and ciphertext files are plain npz (utils.serialization),
readable by the JAX package too.

Run:  python cufhe_tpu_torch/examples/03_server_client_split.py
          # the mesh is every CUDA device
      python cufhe_tpu_torch/examples/03_server_client_split.py --cpu
          # a mesh of two CPU shards
"""
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from cufhe_tpu_torch import TINY, golden as G  # noqa: E402
from cufhe_tpu_torch.models import (Context, Ctxt, decrypt_bits,  # noqa: E402
                                    encrypt_bits)
from cufhe_tpu_torch.parallel import data_mesh  # noqa: E402
from cufhe_tpu_torch.torus import from_u32, to_u32  # noqa: E402
from cufhe_tpu_torch.utils import serialization as S  # noqa: E402

CPU = "--cpu" in sys.argv
if not CPU and not torch.cuda.is_available():
    sys.exit("no CUDA device: run on the card, or pass --cpu")
rng = np.random.default_rng(11)

with tempfile.TemporaryDirectory() as workdir:
    # --- client: keygen, persist, encrypt ---------------------------------
    sk = G.keygen(TINY, seed=1)
    ek = G.make_eval_key(sk, seed=2)
    S.save_secret_key(f"{workdir}/secret.npz", sk)    # stays with the client
    S.save_eval_key(f"{workdir}/eval.npz", ek)        # shipped to the server

    bits_a = rng.integers(0, 2, 32)
    bits_b = rng.integers(0, 2, 32)
    for name, bits in (("a", bits_a), ("b", bits_b)):
        ct = encrypt_bits(bits, sk, rng, device="cpu")
        S.save_ciphertexts(f"{workdir}/inputs_{name}.npz", to_u32(ct.data),
                           ct.level)

    # --- server: no secret key anywhere -----------------------------------
    server_ek = S.load_eval_key(f"{workdir}/eval.npz")
    mesh = data_mesh(["cpu"] * 2) if CPU else data_mesh()
    ctx = Context(server_ek, mesh=mesh)     # keys on every shard's device

    da, la = S.load_ciphertexts(f"{workdir}/inputs_a.npz")
    db, lb = S.load_ciphertexts(f"{workdir}/inputs_b.npz")
    in_a = Ctxt(from_u32(da, mesh.device), la)
    in_b = Ctxt(from_u32(db, mesh.device), lb)

    # each shard bootstraps its own rows: no data moves between shards
    out = ctx.nand(in_a, in_b)
    S.save_ciphertexts(f"{workdir}/result.npz", to_u32(out.data), out.level)
    print(f"server: NAND over a {mesh.size}-device mesh "
          f"({', '.join(str(d) for d in mesh.devices)}), "
          f"{out.batch // mesh.size} rows a shard, 0 collectives")

    # --- client: decrypt the returned result ------------------------------
    client_sk = S.load_secret_key(f"{workdir}/secret.npz")
    dr, lr = S.load_ciphertexts(f"{workdir}/result.npz")
    got = decrypt_bits(Ctxt(from_u32(dr, "cpu"), lr), client_sk)
    assert np.array_equal(got, 1 - (bits_a & bits_b))
    print("client: all decryptions correct")
