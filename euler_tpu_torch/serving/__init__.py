"""Serving of the port (the device engine in this slice)."""
