"""genie_gather_ms_per_step: device ms a step of the genie encoder's
`gather` phase (obs/device.py): every hop's rows taken and dequantized,
from the end of the draw to the encoder's entry. The
estimator_phase_device_ms{phase=gather} histogram over the timed window
(models/geniepath.py's `phases`): its sum over the steps read. None
where the program marks no such phase."""


def read(rec):
    count, total = (rec.get("phases") or {}).get("gather", (0, 0.0))
    return total / count if count else None
