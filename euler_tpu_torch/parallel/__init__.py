"""Device-resident tables of the port: features, labels, neighbors."""
