"""Layers, aggregators, encoders and metrics of the port."""
