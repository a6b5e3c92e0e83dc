"""Metrics layer of the port: the gauge registry and the pending-capacity
producer (copies of karpenter_tpu/metrics/registry.py and
metrics/producers/pendingcapacity/)."""
