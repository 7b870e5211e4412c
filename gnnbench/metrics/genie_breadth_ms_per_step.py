"""genie_breadth_ms_per_step: device ms a step of the genie encoder's
`breadth` phase (obs/device.py): the projection of every hop, each
depth's attention pools and tanh transforms, and depth_fc. The
estimator_phase_device_ms{phase=breadth} histogram over the timed
window (models/geniepath.py's `phases`): its sum over the steps read.
None where the program marks no such phase."""


def read(rec):
    count, total = (rec.get("phases") or {}).get("breadth", (0, 0.0))
    return total / count if count else None
