"""The solution layer of the port (counterpart of euler_tpu/solution):
pipelines assembled from a root sampler, an encoder, a logits head and
a loss."""

from euler_tpu_torch.solution.base_solution import (  # noqa: F401
    CosineLogits,
    DenseLogits,
    PosNegLogits,
    PosNegSampler,
    SuperviseSolution,
    UnsuperviseSolution,
    sigmoid_loss,
    xent_loss,
)
