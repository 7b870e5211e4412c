"""Datasets of the port (synthetic stand-ins, as arrays)."""
