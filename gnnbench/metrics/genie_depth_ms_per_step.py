"""genie_depth_ms_per_step: device ms a step of the genie encoder's
`depth` phase (obs/device.py): the LSTM over the roots' depth states.
The estimator_phase_device_ms{phase=depth} histogram over the timed
window (models/geniepath.py's `phases`): its sum over the steps read.
None where the program marks no such phase."""


def read(rec):
    count, total = (rec.get("phases") or {}).get("depth", (0, 0.0))
    return total / count if count else None
