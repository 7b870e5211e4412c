"""Model contract of the port."""
