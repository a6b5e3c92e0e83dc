"""Share of the traced bin-pack window with no kernel, copy or memset on
the card."""

from portbench import readers


def read(record):
    return readers.idle_pct(record)
