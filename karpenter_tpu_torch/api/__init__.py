"""API group autoscaling.karpenter.sh/v1alpha1: the core objects (Pod,
Node, ObjectMeta, selectors, affinity and spread shapes), conditions and
the MetricsProducer kind, copied from karpenter_tpu/api for the port's
reconcile path. The HorizontalAutoscaler and ScalableNodeGroup kinds are
not ported yet."""
