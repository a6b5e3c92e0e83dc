"""Parallel composition of the port's programs (counterpart of
karpenter_tpu/parallel)."""
