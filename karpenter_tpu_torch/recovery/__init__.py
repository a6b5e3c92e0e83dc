"""The port's recovery package: so far journal.atomic_write, the
durable-write helper the tracer's export and the flight recorder's dumps
use, and the journal's key codec (key_str / key_tuple) that the
forecaster's checkpoint uses."""
