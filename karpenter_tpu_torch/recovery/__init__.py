"""The port's recovery package: so far only journal.atomic_write, the
durable-write helper the tracer's export and the flight recorder's dumps
use."""
