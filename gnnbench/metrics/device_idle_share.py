"""device_idle_share: 1 - (the union of the device's operation
intervals) / (the traced window's wall time), in %, over whole replays
under torch.profiler. None where the run was not traced on a card."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
