"""Seconds from the process's start to the window's opening: imports,
the CUDA context, the kernels' load (and build, in a checkout's first run),
the traffic's draws, the program's set-up and the warm-up calls."""


def read(record):
    return record["setup_s"]
