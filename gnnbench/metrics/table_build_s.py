"""table_build_s: host seconds, synchronised, of the program's table
builds from the benchmark's arrays: the neighbor table (from_csr), the
feature store (from_arrays) and, where the model has one, the
negatives' node sampler."""


def read(rec):
    return rec["table_build_s"]
