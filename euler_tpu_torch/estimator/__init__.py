"""Estimators of the port: BaseEstimator (base_estimator.py), the node,
edge, graph, GAE and sample estimators (estimators.py), the inference
sweep (infer.py) and the continuous-learning driver (streaming.py)."""

from euler_tpu_torch.estimator.streaming import StreamingDriver  # noqa: F401
