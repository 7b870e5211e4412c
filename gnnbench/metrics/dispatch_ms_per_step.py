"""dispatch_ms_per_step: the estimator's estimator_device_step_ms
histogram summed over the window, over the window's steps: host time
spent dispatching the steps (a K-step replay counts once for K
steps)."""


def read(rec):
    if not rec["window_steps"]:
        return None
    return rec["dispatch_ms"] / rec["window_steps"]
