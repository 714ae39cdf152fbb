"""setup_s: seconds from the process's start to the first timed call:
imports, the kernel library's load (or, in a checkout's first run, its
build), the inputs made from the seed and the warm-up of the cell's own
shapes. Host clock."""


def read(rec: dict) -> float:
    return rec["setup_s"]
