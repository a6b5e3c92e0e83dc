"""The watchable object store, its columnar pending-pod feed and the
durable store (copies of karpenter_tpu/store/store.py, columnar.py and
persistence.py; the kube-apiserver store is not ported)."""

from karpenter_tpu_torch.store.store import (
    ConflictError,
    NotFoundError,
    Scale,
    Store,
    register_scale_kind,
)


def __getattr__(name):
    # lazy: persistence pulls in the serialization codec; keep plain Store
    # imports light
    if name in ("DurableStore", "open_store", "register_persistent_kind"):
        from karpenter_tpu_torch.store import persistence

        return getattr(persistence, name)
    raise AttributeError(name)


__all__ = [
    "Store",
    "Scale",
    "NotFoundError",
    "ConflictError",
    "register_scale_kind",
    "DurableStore",
    "open_store",
    "register_persistent_kind",
]
