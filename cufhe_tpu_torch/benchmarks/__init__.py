"""Probes of the port on the card (run each with python -m)."""
