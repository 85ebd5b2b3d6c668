from .api import Context, Ctxt, decrypt_bits, encrypt_bits
from .gates import GATE_CONSTANTS, TWO_INPUT

__all__ = ["Context", "Ctxt", "decrypt_bits", "encrypt_bits",
           "GATE_CONSTANTS", "TWO_INPUT"]
