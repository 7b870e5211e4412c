"""The native graph engine of the port."""
