"""Bin-pack Solves the solve service answered a second, by all clients
together, over the stretch of a traced run's window after the profiler
has stopped and processed its trace: the host-bound rate, which swings
with the host's speed between runs and machines."""

from portbench import readers


def read(record):
    return readers.quiet_rate(record)
