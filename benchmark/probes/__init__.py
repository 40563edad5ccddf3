"""Instruments of the traced stretch, one module a probe, found by name."""
