"""Key and ciphertext files (serialization), timing helpers (timing), and
the program's spans and counters (spans)."""
