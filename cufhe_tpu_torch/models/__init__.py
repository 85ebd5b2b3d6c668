from .api import Context, Ctxt, TrlweCtxt, decrypt_bits, encrypt_bits
from .gates import GATE_CONSTANTS, TWO_INPUT

__all__ = ["Context", "Ctxt", "TrlweCtxt", "decrypt_bits", "encrypt_bits",
           "GATE_CONSTANTS", "TWO_INPUT"]
