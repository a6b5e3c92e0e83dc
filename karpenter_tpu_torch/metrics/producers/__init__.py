"""Metrics producers of the port: the pending-capacity producer
(pendingcapacity/), whose solve runs the port's bin-pack on the card."""
