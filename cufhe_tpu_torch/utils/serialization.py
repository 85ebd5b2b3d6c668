"""Key serialization — checkpoint/resume of evaluation keys.

The reference relies on TFHEpp+cereal for key files but never calls it
(SURVEY.md §5 "checkpoint/resume"); here it is first-class: a server process
can load an EvalKey (public material only) without ever seeing the secret key.
Format: plain npz with a params-name tag, so files are portable across hosts
and between this package and cufhe_tpu, of which this is a copy.
"""
from __future__ import annotations

import hashlib

import numpy as np

from .. import golden as G
from ..params import PRESETS, GateParams


def params_fingerprint(p: GateParams) -> str:
    """Stable hash of every numeric field in a parameter set. Stamped into
    key files so a preset whose gadget parameters change (l, Bgbit, ...)
    cannot silently reuse keys generated under the old values — the
    trap of a key cache keyed by preset NAME only."""
    return hashlib.sha256(repr(p).encode()).hexdigest()[:16]


def _check_fingerprint(z, what: str) -> GateParams:
    p = PRESETS[str(z["params"])]
    if "fingerprint" in z.files and str(z["fingerprint"]) != \
            params_fingerprint(p):
        raise ValueError(
            f"{what} file was generated under different parameter values "
            f"for preset {p.name!r} (fingerprint mismatch) — regenerate it")
    return p


def save_secret_key(path: str, sk: G.SecretKey) -> None:
    np.savez_compressed(path, kind="secret", params=sk.params.name,
                        fingerprint=params_fingerprint(sk.params),
                        lvl0=sk.lvl0, lvl1=sk.lvl1)


def load_secret_key(path: str) -> G.SecretKey:
    z = np.load(path, allow_pickle=False)
    assert str(z["kind"]) == "secret", "not a secret key file"
    return G.SecretKey(_check_fingerprint(z, "secret key"),
                       z["lvl0"], z["lvl1"])


def save_eval_key(path: str, ek: G.EvalKey) -> None:
    np.savez_compressed(path, kind="eval", params=ek.params.name,
                        fingerprint=params_fingerprint(ek.params),
                        bk=ek.bk, ksk=ek.ksk)


def load_eval_key(path: str) -> G.EvalKey:
    z = np.load(path, allow_pickle=False)
    assert str(z["kind"]) == "eval", "not an eval key file"
    return G.EvalKey(_check_fingerprint(z, "eval key"), z["bk"], z["ksk"])


def save_ciphertexts(path: str, data: np.ndarray, level: int) -> None:
    np.savez_compressed(path, kind="ctxt", level=level, data=data)


def load_ciphertexts(path: str):
    z = np.load(path, allow_pickle=False)
    assert str(z["kind"]) == "ctxt"
    return z["data"], int(z["level"])
