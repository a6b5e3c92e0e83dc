"""In-memory watchable object store — the coordination bus.

The reference's controllers never talk to each other in memory: all
cross-controller communication rides kube-apiserver CRD spec/status and the
scale subresource (reference: SURVEY.md §2.2; pkg/autoscaler/autoscaler.go:196-221).
This store is the TPU build's equivalent bus: namespaced objects keyed by
(kind, namespace, name) with resourceVersions, deep-copy isolation on every
read/write (nothing shares mutable state through the store), watch callbacks,
a pod spec.nodeName index (reference: pkg/controllers/manager.go:73-79), and
a pluggable scale subresource so any HorizontalAutoscaler can target any
registered scalable kind (reference: scalablenodegroup.go:51).

Copy discipline (the hottest host path at fleet scale): objects are cloned
with utils/clone.fast_clone on every intake and every read-out, and the
store is COPY-ON-WRITE internally — no stored object is ever mutated after
insertion (patch_status/update_scale replace the stored instance). That
lets watch callbacks receive the stored instance itself with NO copy; the
documented watcher contract (read-only) is what makes a 1%-churn tick over
100k pods affordable.

Durability mirrors the reference's checkpoint/resume story (SURVEY.md §5):
ALL durable state lives in object spec/status here; controllers and the
device solver are stateless and resume by re-listing.
"""

from __future__ import annotations

import threading

from karpenter_tpu_torch.utils.clone import fast_clone
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

ADDED = "Added"
MODIFIED = "Modified"
DELETED = "Deleted"


class NotFoundError(KeyError):
    pass


class ConflictError(RuntimeError):
    pass


@dataclass
class Scale:
    """The scale-subresource view (k8s autoscaling/v1 Scale analog)."""

    namespace: str
    name: str
    spec_replicas: Optional[int]
    status_replicas: int


@dataclass
class _ScaleHooks:
    get_spec: Callable
    set_spec: Callable
    get_status: Callable


_scale_kinds: Dict[str, _ScaleHooks] = {}


def register_scale_kind(kind: str, get_spec, set_spec, get_status) -> None:
    """Register a kind as implementing the scale subresource."""
    _scale_kinds[kind] = _ScaleHooks(get_spec, set_spec, get_status)


def _kind_of(obj) -> str:
    return getattr(obj, "KIND", type(obj).__name__)


def _key(obj) -> Tuple[str, str, str]:
    return (_kind_of(obj), obj.metadata.namespace, obj.metadata.name)


class Store:
    def __init__(self):
        self._lock = threading.RLock()
        self._objects: Dict[Tuple[str, str, str], object] = {}
        self._rv = 0
        self._watchers: List[Tuple[Optional[str], Callable]] = []
        # spec.nodeName index for Pods
        self._pods_by_node: Dict[str, set] = {}
        # kind -> insertion-ordered keys: list(kind)/keys(kind) must
        # never scan OTHER kinds (listing zero Namespaces used to walk
        # all 100k pods); dict-as-ordered-set keeps the iteration order
        # callers observed before the index existed
        self._by_kind: Dict[str, Dict[Tuple[str, str, str], None]] = {}

    # -- watch ------------------------------------------------------------

    def watch(self, kind: Optional[str], callback: Callable) -> None:
        """Subscribe to mutation events. kind=None watches everything.
        callback(event_type, obj) is invoked synchronously with the STORED
        object itself (zero copies: the store is copy-on-write, so the
        instance can never change after delivery) — treat it as strictly
        read-only."""
        with self._lock:
            self._watchers.append((kind, callback))

    def _notify(self, event: str, obj) -> None:
        # obj is the stored (immutable-after-insert) instance: no copy
        kind = _kind_of(obj)
        for want_kind, callback in list(self._watchers):
            if want_kind is None or want_kind == kind:
                callback(event, obj)

    # -- index maintenance ------------------------------------------------

    def _index_add(self, obj) -> None:
        self._by_kind.setdefault(_kind_of(obj), {})[_key(obj)] = None
        if _kind_of(obj) == "Pod" and obj.spec.node_name:
            self._pods_by_node.setdefault(obj.spec.node_name, set()).add(_key(obj))

    def _index_remove(self, obj) -> None:
        kind_keys = self._by_kind.get(_kind_of(obj))
        if kind_keys is not None:
            kind_keys.pop(_key(obj), None)
            if not kind_keys:
                del self._by_kind[_kind_of(obj)]
        self._node_index_remove(obj)

    def _node_index_remove(self, obj) -> None:
        if _kind_of(obj) == "Pod" and obj.spec.node_name:
            keys = self._pods_by_node.get(obj.spec.node_name)
            if keys is not None:
                keys.discard(_key(obj))
                if not keys:
                    del self._pods_by_node[obj.spec.node_name]

    def _index_replace(self, old, new) -> None:
        """Same-key replacement (update / watch echo): the kind index
        keeps the key's POSITION — remove-then-add would move every
        modified object to the end, churning list() order (and with it
        the oracle encoder's row order) on every status write. Only the
        nodeName index re-files (the binding may have changed)."""
        self._node_index_remove(old)
        if _kind_of(new) == "Pod" and new.spec.node_name:
            self._pods_by_node.setdefault(
                new.spec.node_name, set()
            ).add(_key(new))

    # -- CRUD -------------------------------------------------------------

    def create(self, obj):
        """Persist a copy of obj. Like controller-runtime's Create, the
        CALLER's object is stamped in place with the minted identity
        (uid, creationTimestamp, resourceVersion) and returned — one
        clone per create, on the watch-fan-out hot path."""
        with self._lock:
            key = _key(obj)
            if key in self._objects:
                raise ConflictError(f"{key} already exists")
            # ALWAYS mint a fresh incarnation (apiserver semantics: the
            # server assigns uid/creationTimestamp on create, whatever the
            # request carried) — a caller re-creating with an object from a
            # previous incarnation must not resurrect its uid. Recovered
            # objects keep theirs via the WAL restore path, never create().
            obj.metadata.uid = ""
            obj.metadata.creation_timestamp = 0.0
            obj.metadata.ensure_identity()
            self._rv += 1
            obj.metadata.resource_version = self._rv
            stored = fast_clone(obj)
            self._objects[key] = stored
            self._index_add(stored)
            self._notify(ADDED, stored)
            return obj

    def get(self, kind: str, namespace: str, name: str):
        with self._lock:
            obj = self._objects.get((kind, namespace, name))
            if obj is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            return fast_clone(obj)

    def try_get(self, kind: str, namespace: str, name: str):
        try:
            return self.get(kind, namespace, name)
        except NotFoundError:
            return None

    def update(self, obj):
        """Replace spec+metadata+status wholesale (like an apiserver UPDATE).
        Optimistic concurrency: a stale resource_version is rejected so a
        slow writer cannot silently clobber a concurrent change (e.g. the
        autoscaler's scale write)."""
        with self._lock:
            key = _key(obj)
            stored = self._objects.get(key)
            if stored is None:
                raise NotFoundError(f"{key} not found")
            if (
                obj.metadata.resource_version
                and obj.metadata.resource_version != stored.metadata.resource_version
            ):
                raise ConflictError(
                    f"{key}: stale resourceVersion "
                    f"{obj.metadata.resource_version} != "
                    f"{stored.metadata.resource_version}"
                )
            self._rv += 1
            obj.metadata.resource_version = self._rv
            obj.metadata.uid = stored.metadata.uid
            obj.metadata.creation_timestamp = stored.metadata.creation_timestamp
            new = fast_clone(obj)
            self._objects[key] = new
            self._index_replace(stored, new)
            self._notify(MODIFIED, new)
            return obj

    def patch_status(self, obj):
        """Merge-patch ONLY the status subtree onto the stored object,
        mirroring the reference's Status().Patch(MergeFrom(persisted))
        (reference: pkg/controllers/controller.go:93) — concurrent spec
        writes are never clobbered by a status update."""
        # injection point (faults/registry.py): a failed status write is
        # the apiserver-conflict/outage analog; the engine requeues the
        # reconcile with backoff instead of crashing the tick
        from karpenter_tpu_torch.faults import inject

        inject("store.patch_status")
        with self._lock:
            key = _key(obj)
            stored = self._objects.get(key)
            if stored is None:
                raise NotFoundError(f"{key} not found")
            # copy-on-write: watchers hold references to the previous
            # instance, which must never change after delivery
            new = fast_clone(stored)
            new.status = fast_clone(obj.status)
            self._rv += 1
            new.metadata.resource_version = self._rv
            self._objects[key] = new
            self._notify(MODIFIED, new)
            return fast_clone(new)

    def delete(self, obj_or_kind, namespace: Optional[str] = None, name=None):
        with self._lock:
            if isinstance(obj_or_kind, str):
                key = (obj_or_kind, namespace, name)
            else:
                key = _key(obj_or_kind)
            stored = self._objects.pop(key, None)
            if stored is None:
                raise NotFoundError(f"{key} not found")
            self._index_remove(stored)
            self._notify(DELETED, stored)

    def keys(self, kind: str) -> list:
        """(kind, namespace, name) keys of a kind, without copying objects."""
        with self._lock:
            return list(self._by_kind.get(kind, ()))

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> list:
        with self._lock:
            out = []
            for key in self._by_kind.get(kind, ()):
                obj = self._objects[key]
                if namespace is not None and key[1] != namespace:
                    continue
                if label_selector is not None and not all(
                    obj.metadata.labels.get(lk) == lv
                    for lk, lv in label_selector.items()
                ):
                    continue
                out.append(fast_clone(obj))
            return out

    def pods_on_node(self, node_name: str) -> list:
        """Pods indexed by spec.nodeName (reference: manager.go:54-55,73-79)."""
        with self._lock:
            return [
                fast_clone(self._objects[key])
                for key in sorted(self._pods_by_node.get(node_name, set()))
                if key in self._objects
            ]

    def apply_event(self, event: str, obj) -> None:
        """Apply an event from an EXTERNAL source of truth (an apiserver
        watch stream) verbatim: no identity minting, no resourceVersion
        bump or conflict check — the upstream's metadata IS the truth.
        Watchers observe it exactly like a local mutation."""
        with self._lock:
            key = _key(obj)
            stored = self._objects.get(key)
            if event == DELETED:
                if stored is None:
                    return
                del self._objects[key]
                self._index_remove(stored)
                self._notify(DELETED, stored)
                return
            if (
                stored is not None
                and stored.metadata.resource_version
                == obj.metadata.resource_version
            ):
                return  # relist echo of an unchanged object: no watcher spam
            obj = fast_clone(obj)
            self._objects[key] = obj
            if stored is not None:
                self._index_replace(stored, obj)
            else:
                self._index_add(obj)
            if isinstance(obj.metadata.resource_version, int):
                # externally-sourced rvs may be opaque non-numeric strings
                # (k8s API conventions); only numeric ones can advance the
                # local minting counter, and equality above never needs more
                self._rv = max(self._rv, obj.metadata.resource_version)
            self._notify(MODIFIED if stored is not None else ADDED, obj)

    # -- scale subresource -------------------------------------------------

    def _scale_hooks(self, kind: str, obj) -> _ScaleHooks:
        """Registered hooks, else the duck-typed fallback: any stored
        object shaped like a scalable workload (spec.replicas +
        status.replicas — Deployments, StatefulSets, and every
        kubebuilder scale-marker CRD use exactly this layout) implements
        scale without registration. The reference gets the same
        generality from discovery + scale.ScalesGetter
        (reference: autoscaler.go:196-237); in-memory mode derives it
        from the object shape."""
        hooks = _scale_kinds.get(kind)
        if hooks is not None:
            return hooks
        spec = getattr(obj, "spec", None)
        status = getattr(obj, "status", None)
        if hasattr(spec, "replicas") and hasattr(status, "replicas"):
            return _DUCK_SCALE_HOOKS
        raise NotFoundError(f"kind {kind} does not implement scale")

    def get_scale(
        self, kind: str, namespace: str, name: str, api_version: str = ""
    ) -> Scale:
        with self._lock:
            obj = self._objects.get((kind, namespace, name))
            if obj is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            hooks = self._scale_hooks(kind, obj)
            status = hooks.get_status(obj)
            return Scale(
                namespace=namespace,
                name=name,
                spec_replicas=hooks.get_spec(obj),
                status_replicas=int(status) if status is not None else 0,
            )

    def update_scale(
        self, kind: str, scale: Scale, api_version: str = ""
    ) -> None:
        with self._lock:
            obj = self._objects.get((kind, scale.namespace, scale.name))
            if obj is None:
                raise NotFoundError(
                    f"{kind} {scale.namespace}/{scale.name} not found"
                )
            hooks = self._scale_hooks(kind, obj)
            # copy-on-write (same contract as patch_status)
            new = fast_clone(obj)
            hooks.set_spec(new, scale.spec_replicas)
            self._rv += 1
            new.metadata.resource_version = self._rv
            self._objects[(kind, scale.namespace, scale.name)] = new
            self._notify(MODIFIED, new)


_DUCK_SCALE_HOOKS = _ScaleHooks(
    get_spec=lambda obj: obj.spec.replicas,
    set_spec=lambda obj, replicas: setattr(obj.spec, "replicas", replicas),
    get_status=lambda obj: obj.status.replicas,
)


def _register_builtin_scale_kinds():
    """ScalableNodeGroup implements scale at .spec.replicas/.status.replicas
    (reference: scalablenodegroup.go:51 kubebuilder scale marker)."""

    def get_spec(sng):
        return sng.spec.replicas

    def set_spec(sng, replicas):
        sng.spec.replicas = replicas

    def get_status(sng):
        return sng.status.replicas

    register_scale_kind("ScalableNodeGroup", get_spec, set_spec, get_status)


_register_builtin_scale_kinds()
