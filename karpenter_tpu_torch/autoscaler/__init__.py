"""The port's copy of karpenter_tpu/autoscaler/__init__.py, changed only in
its imports."""

from karpenter_tpu_torch.autoscaler.autoscaler import AutoscalerFactory, BatchAutoscaler

__all__ = ["AutoscalerFactory", "BatchAutoscaler"]

# arm the api layer's validation hooks at package import (webhook.py does
# the same): admission must reject unknown algorithm annotations in every
# process shape, including standalone mode where nothing else would import
# the algorithms package before the first reconcile
import karpenter_tpu_torch.autoscaler.algorithms  # noqa: E402,F401
