"""Two processes of cufhe_tpu_torch on one gloo process group (the
counterpart of tests/test_distributed.py): each builds the same TINY keys
from a fixed seed, evaluates its 8 of 16 NAND rows on a CPU mesh of two
shards, checks them against the port's golden model, and all_gathers them;
the gathered batch equals the single-process unsharded run as uint32. The
gate path itself calls no collective: the one all_gather is the test's.

The worker is this file run as a script, so it loads neither conftest.py
(which imports JAX) nor another file:

    python tests/test_torch_distributed.py <init-address> 2 <rank>
"""
import os
import socket
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Intra-op threads off while this module runs (the workers set the
    same): the suite runs several worker processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(addr: str):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), addr, "2", str(rank)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(2)]
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=240)[0])
    except subprocess.TimeoutExpired:
        for pr in procs:
            pr.kill()
            pr.communicate()
        return False, "timed out:\n" + "\n".join(o or "" for o in outs)
    for rank, (pr, out) in enumerate(zip(procs, outs)):
        if pr.returncode != 0 or f"DIST_OK rank={rank}" not in out:
            return False, f"rank {rank} failed:\n{out[-3000:]}"
    return True, ""


def test_two_process_distributed_nand():
    assert torch.distributed.is_gloo_available()
    # the free-port probe can race another process for the port between
    # its close and the rendezvous bind: one retry on a fresh port
    ok, msg = _run_workers(f"tcp://127.0.0.1:{_free_port()}")
    if not ok:
        ok, msg = _run_workers(f"tcp://127.0.0.1:{_free_port()}")
    assert ok, msg


def main() -> None:
    addr, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    sys.path.insert(0, REPO)
    import numpy as np

    import cufhe_tpu_torch as T
    from cufhe_tpu_torch import golden as G
    from cufhe_tpu_torch.parallel import mesh as M
    from cufhe_tpu_torch.torus import from_u32, to_u32

    torch.set_num_threads(1)
    M.init_distributed(backend="gloo", init_method=addr, world_size=world,
                       rank=rank)
    try:
        sk = G.keygen(T.TINY, seed=7)
        ek = G.make_eval_key(sk, seed=8)
        rng = np.random.default_rng(9)        # the same stream on each rank
        bn = 16
        bits0, bits1 = rng.integers(2, size=bn), rng.integers(2, size=bn)
        c0 = G.encrypt_bit_batch(bits0, sk, rng)
        c1 = G.encrypt_bit_batch(bits1, sk, rng)
        # this rank feeds only its own rows, on a mesh of two CPU shards
        a, b = (T.Ctxt(M.local_rows(from_u32(c), rank, world), 0)
                for c in (c0, c1))
        ctx = T.Context(ek, mesh=M.data_mesh(["cpu"] * 2))
        out = ctx.nand(a, b)
        rows = bn // world
        want = np.stack([G.gate_lvl0("nand", x, y, ek) for x, y in
                         zip(c0[rank * rows:(rank + 1) * rows],
                             c1[rank * rows:(rank + 1) * rows])])
        assert np.array_equal(to_u32(out.data), want), \
            f"rank {rank}: rows disagree with golden"
        parts = [torch.empty_like(out.data) for _ in range(world)]
        torch.distributed.all_gather(parts, out.data)
        plain = T.Context(ek, device="cpu").nand(
            T.Ctxt(from_u32(c0), 0), T.Ctxt(from_u32(c1), 0))
        assert torch.equal(torch.cat(parts), plain.data), \
            f"rank {rank}: gathered batch differs from the unsharded run"
        assert T.decrypt_bits(T.Ctxt(torch.cat(parts), 0), sk).tolist() == \
            (1 - (bits0 & bits1)).tolist()
    finally:
        torch.distributed.destroy_process_group()
    print(f"DIST_OK rank={rank} world={world}", flush=True)


if __name__ == "__main__":
    main()
