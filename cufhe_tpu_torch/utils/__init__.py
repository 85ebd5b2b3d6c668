"""Key and ciphertext files (serialization) and timing helpers (timing)."""
