"""The in-memory watchable object store and its columnar pending-pod feed
(copies of karpenter_tpu/store/store.py and columnar.py; the durable
store is not ported)."""

from karpenter_tpu_torch.store.store import (
    ConflictError,
    NotFoundError,
    Scale,
    Store,
    register_scale_kind,
)

__all__ = [
    "Store",
    "Scale",
    "NotFoundError",
    "ConflictError",
    "register_scale_kind",
]
