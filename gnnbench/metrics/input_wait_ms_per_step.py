"""input_wait_ms_per_step: the estimator's estimator_input_wait_ms
histogram summed over the window, over the window's steps: host time a
step waited for its batch (the feed and the copy to the card)."""


def read(rec):
    if not rec["window_steps"]:
        return None
    return rec["input_wait_ms"] / rec["window_steps"]
