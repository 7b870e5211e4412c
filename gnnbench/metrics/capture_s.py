"""capture_s: host seconds, synchronised at both ends, of the warm-up:
the first K-step window run eagerly and the capture of the K-step CUDA
graph."""


def read(rec):
    return rec["capture_s"]
