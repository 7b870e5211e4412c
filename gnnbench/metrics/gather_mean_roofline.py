"""gather_mean_roofline: gather_mean's byte bound (yardstick/counts.py,
at the rows its launches read, over the published HBM rate) over its
mean device time in the traced window, in %. None without a traced
launch or a bound."""


def read(rec):
    t = rec.get("trace") or {}
    ms, bound = t.get("gather_mean_ms"), rec.get("gather_mean_bound_ms")
    if not ms or bound is None:
        return None
    return 100.0 * bound / ms
