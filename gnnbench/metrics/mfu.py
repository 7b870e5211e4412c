"""mfu: the whole step's share of the card's float32 peak, in %: the
model's GEMM FLOPs a step (yardstick/counts.py: forward and backward,
nothing recomputed) times the window's steps, over the window's
seconds, over the published float32 rate. None on a card without a
published peak."""


def read(rec):
    peak = rec.get("peak")
    if not peak or not rec["window_steps"]:
        return None
    rate = rec["model_flops_per_step"] * rec["window_steps"] \
        / rec["window_s"]
    return 100.0 * rate / peak["f32_flops_per_s"]
