"""The watchable object store, its columnar pending-pod feed, the
durable store and the kube-apiserver store (copies of
karpenter_tpu/store/store.py, columnar.py, persistence.py and kube.py).
KubeClient and KubeStore load from store/kube.py on first use."""

from karpenter_tpu_torch.store.store import (
    ConflictError,
    NotFoundError,
    Scale,
    Store,
    register_scale_kind,
)


def __getattr__(name):
    # lazy: persistence pulls in the serialization codec, kube the HTTP
    # client; keep plain Store imports light
    if name in ("DurableStore", "open_store", "register_persistent_kind"):
        from karpenter_tpu_torch.store import persistence

        return getattr(persistence, name)
    if name in ("KubeClient", "KubeStore"):
        from karpenter_tpu_torch.store import kube

        return getattr(kube, name)
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
    "KubeClient",
    "KubeStore",
]
