"""sampler_ms_per_step: device ms of the model's own draw for one batch
(sample_rows, or sample for the unsupervised model), eager, after the
window, CUDA events around 32 calls on the cell's batches. None where
the run was not traced on a card."""


def read(rec):
    return rec.get("sampler_ms_per_step")
