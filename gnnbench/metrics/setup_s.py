"""setup_s: host seconds from the process's start to the first timed
step: the graph drawn, the tables and the model built, the kernel built
or found built, the warm-up and the capture, and the checked replay."""


def read(rec):
    return rec["setup_s"]
