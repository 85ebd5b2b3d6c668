"""User-facing model layer: the gate API, composite encrypted circuits,
encrypted integers and the TOY8 processor."""
from . import api, circuits, gates, integers, processor  # noqa: F401
from .api import Context, Ctxt, TrlweCtxt, decrypt_bits, encrypt_bits
from .gates import GATE_CONSTANTS, TWO_INPUT
from .integers import (IntCodec, IntContext, IntCtxt, decrypt_int,
                       decrypt_uint, encrypt_int, encrypt_uint)

__all__ = ["Context", "Ctxt", "TrlweCtxt", "decrypt_bits", "encrypt_bits",
           "GATE_CONSTANTS", "TWO_INPUT", "IntCodec", "IntContext",
           "IntCtxt", "decrypt_int", "decrypt_uint", "encrypt_int",
           "encrypt_uint", "circuits", "integers", "processor"]
