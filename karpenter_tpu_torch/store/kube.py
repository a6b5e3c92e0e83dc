"""Real-cluster mode: the store backed by a kube-apiserver.

The reference's coordination bus IS the apiserver (client-go informers +
writes; reference: SURVEY.md §2.2, pkg/controllers/manager.go). This module
gives the TPU build the same mode without any kubernetes client library:

- `KubeClient` — a minimal typed REST client over urllib (bearer token +
  CA, in-cluster defaults): list/watch streams, create/update/delete,
  merge-patch status, and the scale subresource.
- `KubeStore` — the Store facade the rest of the framework already
  programs against. Reads and watch callbacks ride an in-memory mirror
  kept current by apiserver watch streams (the informer pattern, which is
  also what makes PendingFeed/DurableStore-free operation correct here);
  writes go straight to the apiserver, whose echo updates the mirror.
  Write-then-read may briefly see the pre-write state — level-triggered
  reconciles recompute from scratch, so staleness only delays, never
  corrupts (the exact consistency model the reference runs under).

Lease operations (leader election) bypass the mirror: they are
read-modify-write against coordination.k8s.io directly, since a stale
lease read must lose the conflict, not win it.

The port's copy of karpenter_tpu/store/kube.py. What differs:

  * A status patch lands in the mirror on the writer's thread: the
    mirror's lock is held across the PATCH, and the apiserver's answer
    is applied before the lock is released, so watchers see the write
    synchronously, as the in-process Store delivers it. The watch
    stream's echo of the same resourceVersion then changes nothing. The
    reference applies only the echo, on the informer thread, where the
    Manager's own-patch guard (controllers/engine.py `_patching`) cannot
    see it: each status write re-dirties its object, so an event-driven
    plane re-reconciles every patched object forever.
  * A watch event older than the mirror's object (both resourceVersions
    numeric) is dropped, so the echo of a write that a later write has
    already replaced in the mirror cannot move it back.
  * `observed_version(kind)` is the resourceVersion of the last relist
    or watch event of the kind: a caller waits for quiescence against
    the apiserver's own version instead of sleeping.
"""

from __future__ import annotations

import datetime as _dt
import json
import os
import socket as _socket
import ssl
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from karpenter_tpu_torch.api.serialization import (
    _rfc3339_to_epoch,
    from_manifest,
    to_dict,
)

_socket_timeout = _socket.timeout
from karpenter_tpu_torch.leaderelection import Lease
from karpenter_tpu_torch.store.store import (
    ADDED,
    DELETED,
    MODIFIED,
    ConflictError,
    NotFoundError,
    Scale,
    Store,
)
from karpenter_tpu_torch.utils.log import logger

log = logger()

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# kind -> (api prefix, plural, namespaced)
RESOURCES: Dict[str, Tuple[str, str, bool]] = {
    "HorizontalAutoscaler": (
        "apis/autoscaling.karpenter.sh/v1alpha1",
        "horizontalautoscalers",
        True,
    ),
    "MetricsProducer": (
        "apis/autoscaling.karpenter.sh/v1alpha1",
        "metricsproducers",
        True,
    ),
    "ScalableNodeGroup": (
        "apis/autoscaling.karpenter.sh/v1alpha1",
        "scalablenodegroups",
        True,
    ),
    "Pod": ("api/v1", "pods", True),
    "Node": ("api/v1", "nodes", False),
    # labels resolve namespaceSelector terms in inter-pod affinity
    "Namespace": ("api/v1", "namespaces", False),
}

WATCHED_KINDS = tuple(RESOURCES)

# negative-cache lifetime for discovery misses (resolve_kind): long
# enough that a misconfigured HA costs one discovery walk per window
# instead of one per reconcile, short enough that installing the
# missing CRD is picked up without a restart
DISCOVERY_MISS_TTL = 30.0

_LEASE_API = "apis/coordination.k8s.io/v1"


def _epoch_to_rfc3339(ts: float) -> str:
    return (
        _dt.datetime.fromtimestamp(ts, _dt.timezone.utc)
        .isoformat(timespec="microseconds")
        .replace("+00:00", "Z")
    )


def encode_for_write(obj) -> dict:
    """Manifest for POST/PUT: user-facing codec + the concurrency token."""
    doc = to_dict(obj)
    meta = doc.setdefault("metadata", {})
    if obj.metadata.resource_version:
        meta["resourceVersion"] = str(obj.metadata.resource_version)
    return doc


def decode_from_read(doc: dict):
    """Apiserver object -> API object (lenient: unknown fields dropped,
    RFC3339 timestamps to epoch)."""
    obj = from_manifest(doc, lenient=True)
    meta = doc.get("metadata", {})
    rv = meta.get("resourceVersion")
    if rv is not None:
        # resourceVersions are opaque strings per the k8s API conventions
        # (etcd's happen to be numeric, but nothing guarantees it); keep
        # non-numeric ones as strings — the mirror only needs equality.
        try:
            obj.metadata.resource_version = int(rv)
        except ValueError:
            obj.metadata.resource_version = rv
    uid = meta.get("uid")
    if uid:
        obj.metadata.uid = uid
    return obj


def _null_vanished(old: dict, new: dict) -> dict:
    """JSON merge-patch body that also DELETES keys present in `old` but
    absent from `new` (RFC 7386: null means remove). Recurses into maps so
    nested deletions (condition fields, per-resource entries) propagate."""
    out = dict(new)
    for key, old_value in old.items():
        if key not in new:
            out[key] = None
        elif isinstance(old_value, dict) and isinstance(new[key], dict):
            out[key] = _null_vanished(old_value, new[key])
    return out


def _make_ssl_context(base_url: str, insecure: bool, ca_file):
    """SSL context for an https apiserver URL (None for plain http):
    CERT_NONE when insecure, else the given CA / the in-cluster
    serviceaccount CA / system defaults."""
    if not base_url.startswith("https"):
        return None
    if insecure:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        return ctx
    ca = ca_file or (
        os.path.join(_SA_DIR, "ca.crt")
        if os.path.exists(os.path.join(_SA_DIR, "ca.crt"))
        else None
    )
    return ssl.create_default_context(cafile=ca)


class KubeClient:
    """Minimal apiserver REST client; no client library, just urllib."""

    def __init__(
        self,
        base_url: Optional[str] = None,
        token: Optional[str] = None,
        token_file: Optional[str] = None,
        ca_file: Optional[str] = None,
        insecure: bool = False,
        timeout: float = 30.0,
    ):
        self.base_url = (
            base_url
            or os.environ.get("KUBERNETES_SERVICE_HOST")
            and (
                "https://"
                + os.environ["KUBERNETES_SERVICE_HOST"]
                + ":"
                + os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            )
            or "https://kubernetes.default.svc"
        ).rstrip("/")
        self._token = token
        self._token_file = token_file or (
            os.path.join(_SA_DIR, "token")
            if token is None and os.path.exists(os.path.join(_SA_DIR, "token"))
            else None
        )
        self.timeout = timeout
        self._ssl = _make_ssl_context(self.base_url, insecure, ca_file)
        # (kind, apiVersion) resolved via API discovery (resolve_kind),
        # memoized for the client's lifetime — discovery output only
        # changes on CRD install/uninstall, which warrants a process
        # restart anyway. Misses are cached with a TTL instead: a
        # misconfigured scaleTargetRef would otherwise re-walk the full
        # discovery surface every reconcile (every 10 s per bad HA),
        # while a short TTL still picks up a late-installed CRD.
        self._discovered: Dict[tuple, Tuple[str, str, bool]] = {}
        self._discovery_misses: Dict[tuple, float] = {}

    def _headers(self, content_type: Optional[str] = None) -> dict:
        headers = {"Accept": "application/json"}
        token = self._token
        if token is None and self._token_file:
            with open(self._token_file) as f:  # rotated by kubelet
                token = f.read().strip()
        if token:
            headers["Authorization"] = f"Bearer {token}"
        if content_type:
            headers["Content-Type"] = content_type
        return headers

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        content_type: str = "application/json",
        timeout: Optional[float] = None,
    ) -> dict:
        url = f"{self.base_url}/{path}"
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url,
            data=data,
            method=method,
            headers=self._headers(content_type if data is not None else None),
        )
        try:
            with urllib.request.urlopen(
                req, timeout=timeout or self.timeout, context=self._ssl
            ) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as err:
            detail = err.read().decode(errors="replace")[:300]
            if err.code == 404:
                raise NotFoundError(f"{method} {path}: {detail}") from None
            if err.code == 409:
                raise ConflictError(f"{method} {path}: {detail}") from None
            raise RuntimeError(
                f"apiserver {method} {path} -> {err.code}: {detail}"
            ) from None
        return json.loads(payload) if payload else {}

    # -- collection paths --------------------------------------------------

    # -- kind -> resource mapping (discovery) ------------------------------

    def resolve_kind(
        self, kind: str, api_version: str = ""
    ) -> Tuple[str, str, bool]:
        """(api prefix, plural, namespaced) for a kind. The framework's
        own kinds come from the static table; anything else — e.g. an
        HA's scaleTargetRef pointing at a Deployment — is resolved via
        API discovery and memoized, the RESTMapper-over-discovery
        pattern the reference leans on (reference:
        autoscaler.go:196-237 parseGroupResource + RESTMapping).

        Resolution (and the memo) is keyed by (kind, apiVersion): two
        CRDs may legally share a kind across API groups, and a
        kind-only cache would scale whichever group was discovered
        first. The static table only short-circuits when the requested
        apiVersion matches (or is unspecified)."""
        static = RESOURCES.get(kind)
        if static is not None and (
            not api_version or static[0] == self._api_prefix(api_version)
        ):
            return static
        key = (kind, api_version)
        entry = self._discovered.get(key)
        if entry is not None:
            return entry
        miss_until = self._discovery_misses.get(key)
        if miss_until is not None and time.monotonic() < miss_until:
            raise NotFoundError(
                f"kind {kind!r} (apiVersion {api_version!r}) is not served "
                "by the apiserver (cached discovery miss; retries after "
                f"{DISCOVERY_MISS_TTL:.0f}s in case the CRD was installed)"
            )
        entry, degraded = self._discover_kind(kind, api_version)
        if entry is None:
            # only a DEFINITIVE miss (every group-version answered and
            # none serves the kind) is cached: a walk that skipped a
            # broken group may have skipped exactly the serving one, and
            # caching that would turn a momentary aggregated-API hiccup
            # into a DISCOVERY_MISS_TTL resolution outage
            if not degraded:
                self._discovery_misses[key] = (
                    time.monotonic() + DISCOVERY_MISS_TTL
                )
            raise NotFoundError(
                f"kind {kind!r} (apiVersion {api_version!r}) is not served "
                "by the apiserver (discovery found no matching resource"
                + (
                    "; some group-versions failed and were skipped"
                    if degraded
                    else ""
                )
                + ")"
            )
        self._discovered[key] = entry
        self._discovery_misses.pop(key, None)
        return entry

    @staticmethod
    def _api_prefix(api_version: str) -> str:
        # core group ("v1") lives under /api; everything else /apis
        return (
            f"api/{api_version}"
            if "/" not in api_version
            else f"apis/{api_version}"
        )

    def _discover_kind(self, kind: str, api_version: str):
        """Find the (group-version, plural, namespaced) serving `kind`.
        With an apiVersion (the CrossVersionObjectReference always has
        one) only that group-version's APIResourceList is consulted;
        without, every served group-version is walked (preferred
        versions first), plus core /api/v1. Returns (entry or None,
        degraded) — degraded means some group-version failed and was
        skipped, so a None result is NOT a definitive miss."""
        if api_version:
            prefixes = [self._api_prefix(api_version)]
            lenient = False  # the target group itself failing is an error
        else:
            prefixes = self._discovery_prefixes()
            # the blind walk must tolerate partial discovery failure: a
            # stale APIService (e.g. metrics.k8s.io with its backend
            # down answers 503) must not poison resolution of a kind
            # served by a healthy group — the RESTMapper posture
            lenient = True
        degraded = False
        for prefix in prefixes:
            entry, skipped = self._find_kind_in(prefix, kind, lenient)
            degraded = degraded or skipped
            if entry is not None:
                return entry, degraded
        return None, degraded

    def _discovery_prefixes(self) -> list:
        """Every served group-version (preferred versions first), plus
        core /api/v1 — the blind-discovery walk order."""
        prefixes = ["api/v1"]
        for group in self._request("GET", "apis").get("groups", []):
            preferred = (group.get("preferredVersion") or {}).get(
                "groupVersion"
            )
            versions = [
                v.get("groupVersion") for v in group.get("versions", [])
            ]
            ordered = [preferred] + [v for v in versions if v != preferred]
            prefixes.extend(f"apis/{gv}" for gv in ordered if gv)
        return prefixes

    def _find_kind_in(self, prefix: str, kind: str, lenient: bool = False):
        """(entry or None, skipped): skipped marks a group-version whose
        APIResourceList FAILED (not one that answered without the kind)."""
        try:
            payload = self._request("GET", prefix)
        except NotFoundError:
            return None, False  # group-version not served: definitive
        except RuntimeError as e:  # incl. ConflictError; 404 handled above
            if lenient:
                log.warning("discovery: skipping %s: %s", prefix, e)
                return None, True
            raise
        for res in payload.get("resources", []):
            # subresources list as "deployments/scale" — the primary
            # resource is the entry without a slash
            if res.get("kind") == kind and "/" not in res.get("name", ""):
                return (prefix, res["name"], bool(res.get("namespaced"))), False
        return None, False

    def _collection(
        self, kind: str, namespace: Optional[str], api_version: str = ""
    ) -> str:
        api, plural, namespaced = self.resolve_kind(kind, api_version)
        if namespaced and namespace is not None:
            return f"{api}/namespaces/{namespace}/{plural}"
        return f"{api}/{plural}"  # all-namespaces (or cluster-scoped)

    def _object_path(
        self, kind: str, namespace: str, name: str, api_version: str = ""
    ) -> str:
        return f"{self._collection(kind, namespace, api_version)}/{name}"

    # -- typed operations --------------------------------------------------

    # relist chunk size: at 100k+ pods a single unchunked LIST makes the
    # apiserver serialize the whole collection into one response (memory
    # spike on both ends, APF penalty); chunked LISTs stream pages via
    # the k8s continue-token protocol instead
    list_chunk_size = 5000

    def list(self, kind: str) -> Tuple[list, str]:
        """Chunked LIST (limit + continue tokens). The FIRST page's
        resourceVersion is the collection version the informer resumes
        its watch from — the continue protocol serves all pages at that
        same version, so the (list, rv) pair stays coherent."""
        base = self._collection(kind, None)
        objs = []
        rv = "0"
        token = None
        while True:
            path = f"{base}?limit={self.list_chunk_size}"
            if token:
                path += f"&continue={urllib.parse.quote(token)}"
            payload = self._request("GET", path)
            for item in payload.get("items", []):
                item.setdefault("kind", kind)
                objs.append(decode_from_read(item))
            meta = payload.get("metadata", {})
            if token is None:
                rv = meta.get("resourceVersion", "0")
            next_token = meta.get("continue")
            if next_token and next_token == token:
                # a misbehaving endpoint echoing the same token forever
                # would otherwise loop unbounded inside the informer's
                # resync; raising routes into its retry-with-backoff path
                raise RuntimeError(
                    f"list {kind}: continue token did not advance"
                )
            token = next_token
            if not token:
                return objs, rv

    def watch(
        self,
        kind: str,
        resource_version: str,
        handler: Callable[[str, object], None],
        stopped: threading.Event,
    ) -> str:
        """Stream one watch connection; returns the last-seen
        resourceVersion on EOF/stop so the caller can RESUME from it
        without a relist (clean EOFs are routine — real apiservers close
        watches every few minutes). Raises ConflictError on 410 Gone /
        ERROR events (caller must relist)."""
        path = (
            f"{self._collection(kind, None)}?watch=1"
            f"&resourceVersion={resource_version}"
        )
        url = f"{self.base_url}/{path}"
        req = urllib.request.Request(url, headers=self._headers())
        last_rv = resource_version
        try:
            with urllib.request.urlopen(
                req, timeout=self.timeout, context=self._ssl
            ) as resp:
                for line in resp:
                    if stopped.is_set():
                        return last_rv
                    line = line.strip()
                    if not line:
                        continue
                    event = json.loads(line)
                    etype = event.get("type")
                    if etype == "ERROR":
                        raise ConflictError(
                            f"watch {kind}: {event['object']}"
                        )
                    if etype not in ("ADDED", "MODIFIED", "DELETED"):
                        continue  # BOOKMARK etc.
                    doc = event["object"]
                    doc.setdefault("kind", kind)
                    rv = doc.get("metadata", {}).get("resourceVersion")
                    if rv is not None:
                        last_rv = rv
                    handler(
                        {
                            "ADDED": ADDED,
                            "MODIFIED": MODIFIED,
                            "DELETED": DELETED,
                        }[etype],
                        decode_from_read(doc),
                    )
        except (TimeoutError, _socket_timeout):
            # idle stream: resume from the last event, no relist needed
            return last_rv
        return last_rv

    def create(self, obj):
        kind = type(obj).__name__
        payload = self._request(
            "POST",
            self._collection(kind, obj.metadata.namespace),
            encode_for_write(obj),
        )
        payload.setdefault("kind", kind)
        return decode_from_read(payload)

    def update(self, obj):
        kind = type(obj).__name__
        payload = self._request(
            "PUT",
            self._object_path(
                kind, obj.metadata.namespace, obj.metadata.name
            ),
            encode_for_write(obj),
        )
        payload.setdefault("kind", kind)
        return decode_from_read(payload)

    def get(self, kind: str, namespace: str, name: str):
        payload = self._request(
            "GET", self._object_path(kind, namespace, name)
        )
        payload.setdefault("kind", kind)
        return decode_from_read(payload)

    def patch_status(self, obj, previous_status: Optional[dict] = None):
        """Merge-patch the status subresource. merge-patch only *sets* keys,
        so map entries removed locally (e.g. a reservedCapacity resource that
        disappeared) would otherwise linger upstream forever — pass the
        last-known upstream status to have vanished keys patched to null
        (JSON merge-patch's deletion marker, RFC 7386)."""
        kind = type(obj).__name__
        status = to_dict(obj).get("status", {})
        if previous_status:
            status = _null_vanished(previous_status, status)
        payload = self._request(
            "PATCH",
            self._object_path(
                kind, obj.metadata.namespace, obj.metadata.name
            )
            + "/status",
            {"status": status},
            content_type="application/merge-patch+json",
        )
        payload.setdefault("kind", kind)
        return decode_from_read(payload)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self._request(
            "DELETE", self._object_path(kind, namespace, name)
        )

    def get_scale(
        self, kind: str, namespace: str, name: str, api_version: str = ""
    ) -> Scale:
        payload = self._request(
            "GET",
            self._object_path(kind, namespace, name, api_version) + "/scale",
        )
        return Scale(
            namespace=namespace,
            name=name,
            spec_replicas=payload.get("spec", {}).get("replicas"),
            status_replicas=payload.get("status", {}).get("replicas", 0) or 0,
        )

    def update_scale(
        self, kind: str, scale: Scale, api_version: str = ""
    ) -> None:
        self._request(
            "PUT",
            self._object_path(kind, scale.namespace, scale.name, api_version)
            + "/scale",
            {
                "apiVersion": "autoscaling/v1",
                "kind": "Scale",
                "metadata": {
                    "name": scale.name,
                    "namespace": scale.namespace,
                },
                "spec": {"replicas": scale.spec_replicas},
            },
        )

    # -- leases (coordination.k8s.io) --------------------------------------

    def _lease_path(self, namespace: str, name: Optional[str] = None) -> str:
        path = f"{_LEASE_API}/namespaces/{namespace}/leases"
        return f"{path}/{name}" if name else path

    def get_lease(self, namespace: str, name: str) -> Lease:
        return self._decode_lease(
            self._request("GET", self._lease_path(namespace, name))
        )

    def create_lease(self, lease: Lease) -> Lease:
        return self._decode_lease(
            self._request(
                "POST",
                self._lease_path(lease.metadata.namespace),
                self._encode_lease(lease),
            )
        )

    def update_lease(self, lease: Lease) -> Lease:
        return self._decode_lease(
            self._request(
                "PUT",
                self._lease_path(
                    lease.metadata.namespace, lease.metadata.name
                ),
                self._encode_lease(lease),
            )
        )

    @staticmethod
    def _encode_lease(lease: Lease) -> dict:
        meta = {
            "name": lease.metadata.name,
            "namespace": lease.metadata.namespace,
        }
        if lease.metadata.resource_version:
            meta["resourceVersion"] = str(lease.metadata.resource_version)
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": meta,
            "spec": {
                "holderIdentity": lease.holder,
                "renewTime": _epoch_to_rfc3339(lease.renew_time),
                "leaseDurationSeconds": int(lease.lease_duration),
            },
        }

    @staticmethod
    def _decode_lease(doc: dict) -> Lease:
        from karpenter_tpu_torch.api.core import ObjectMeta

        meta = doc.get("metadata", {})
        spec = doc.get("spec", {})
        renew = spec.get("renewTime")
        rv = meta.get("resourceVersion", 0) or 0
        try:
            rv = int(rv)
        except ValueError:  # opaque string rv — equality is all leases need
            pass
        return Lease(
            metadata=ObjectMeta(
                name=meta.get("name", ""),
                namespace=meta.get("namespace", "default"),
                uid=meta.get("uid", ""),
                resource_version=rv,
            ),
            holder=spec.get("holderIdentity", "") or "",
            renew_time=_rfc3339_to_epoch(renew) if renew else 0.0,
            lease_duration=float(
                spec.get("leaseDurationSeconds", 15) or 15
            ),
        )


class KubeStore:
    """Store facade over a kube-apiserver: informer mirror for reads and
    watches, REST for writes. Drop-in for Store across the framework."""

    def __init__(
        self,
        client: KubeClient,
        watch_kinds: Tuple[str, ...] = WATCHED_KINDS,
        resync_backoff: float = 2.0,
    ):
        self.client = client
        self._mirror = Store()
        self._lock = self._mirror._lock  # caches adopt under the same lock
        self._stopped = threading.Event()
        self._resync_backoff = resync_backoff
        self._threads: List[threading.Thread] = []
        self._observed: Dict[str, str] = {}
        for kind in watch_kinds:
            rv = self._resync(kind)
            thread = threading.Thread(
                target=self._watch_loop, args=(kind, rv), daemon=True
            )
            thread.start()
            self._threads.append(thread)

    # -- informer machinery ------------------------------------------------

    def _resync(self, kind: str) -> str:
        """Full relist: reconcile the mirror to the apiserver's current
        truth (apply changes, delete vanished objects)."""
        objs, rv = self.client.list(kind)
        seen = set()
        for obj in objs:
            seen.add((kind, obj.metadata.namespace, obj.metadata.name))
            self._mirror.apply_event(MODIFIED, obj)
        for key in self._mirror.keys(kind):
            if key not in seen:
                vanished = self._mirror.try_get(*key)
                if vanished is not None:
                    self._mirror.apply_event(DELETED, vanished)
        self._observed[kind] = rv
        return rv

    def _apply(self, kind: str, event: str, obj) -> None:
        """One watch event into the mirror, unless the mirror already
        holds a newer version of the object (module docstring)."""
        with self._lock:
            stored = self._mirror.try_get(
                kind, obj.metadata.namespace, obj.metadata.name
            )
            rv = obj.metadata.resource_version
            if not (
                stored is not None
                and isinstance(rv, int)
                and isinstance(stored.metadata.resource_version, int)
                and rv < stored.metadata.resource_version
            ):
                self._mirror.apply_event(event, obj)
            self._observed[kind] = str(rv)

    def observed_version(self, kind: str) -> str:
        """The resourceVersion of the last relist or watch event of
        `kind` the informer took in."""
        return self._observed.get(kind, "")

    def _watch_loop(self, kind: str, rv: str) -> None:
        """Keep one informer stream alive forever. Clean EOF / idle
        timeout resumes from the last-seen resourceVersion with NO relist
        (relists notify every object and would defeat the incremental
        feed); only a 410 Gone window expiry or a transport error forces
        a full resync — and a failed resync retries with backoff rather
        than ever letting the thread die on a stale mirror."""
        while not self._stopped.is_set():
            needs_resync = False
            try:
                rv = self.client.watch(
                    kind, rv,
                    lambda event, obj, kind=kind: self._apply(
                        kind, event, obj),
                    self._stopped,
                )
            except ConflictError:
                needs_resync = True  # 410 Gone: watch window expired
            except Exception as err:  # noqa: BLE001 — keep the informer up
                if self._stopped.is_set():
                    return
                log.warning("watch %s: %s; resyncing", kind, err)
                needs_resync = True
            while needs_resync and not self._stopped.is_set():
                try:
                    rv = self._resync(kind)
                    needs_resync = False
                except Exception:  # noqa: BLE001
                    time.sleep(self._resync_backoff)

    def close(self) -> None:
        self._stopped.set()

    # -- reads: the mirror --------------------------------------------------

    def get(self, kind: str, namespace: str, name: str):
        if kind == "Lease":
            return self.client.get_lease(namespace, name)
        return self._mirror.get(kind, namespace, name)

    def try_get(self, kind: str, namespace: str, name: str):
        try:
            return self.get(kind, namespace, name)
        except NotFoundError:
            return None

    def list(self, kind: str, namespace=None, label_selector=None) -> list:
        return self._mirror.list(kind, namespace, label_selector)

    def keys(self, kind: str) -> list:
        return self._mirror.keys(kind)

    def pods_on_node(self, node_name: str) -> list:
        return self._mirror.pods_on_node(node_name)

    def watch(self, kind: Optional[str], callback: Callable) -> None:
        self._mirror.watch(kind, callback)

    # -- writes: the apiserver ----------------------------------------------

    @staticmethod
    def _stamp(obj, written):
        """Mirror the local Store's contract (store.py create/update): the
        CALLER's object is stamped with the server-assigned identity, so
        code that ignores the return value behaves identically against the
        in-memory store and a real apiserver."""
        obj.metadata.uid = written.metadata.uid
        obj.metadata.resource_version = written.metadata.resource_version
        obj.metadata.creation_timestamp = written.metadata.creation_timestamp
        return written

    def create(self, obj):
        if isinstance(obj, Lease):
            return self.client.create_lease(obj)
        return self._stamp(obj, self.client.create(obj))

    def update(self, obj):
        if isinstance(obj, Lease):
            return self.client.update_lease(obj)
        return self._stamp(obj, self.client.update(obj))

    def patch_status(self, obj):
        # the mirror holds the last-known upstream status: keys it has that
        # the local object dropped get explicit nulls so merge-patch deletes
        # them. A stale mirror at worst delays a deletion one tick —
        # level-triggered reconciles recompute the full status every time.
        with self._lock:
            mirrored = self._mirror.try_get(
                type(obj).__name__, obj.metadata.namespace,
                obj.metadata.name,
            )
            previous = to_dict(mirrored).get("status") if mirrored else None
            written = self.client.patch_status(
                obj, previous_status=previous
            )
            # the write reaches the watchers here, on this thread (module
            # docstring); the stream's echo of it is then a no-op
            self._mirror.apply_event(MODIFIED, written)
            return written

    def delete(self, obj_or_kind, namespace=None, name=None) -> None:
        if isinstance(obj_or_kind, str):
            kind = obj_or_kind
        else:
            kind = type(obj_or_kind).__name__
            namespace = obj_or_kind.metadata.namespace
            name = obj_or_kind.metadata.name
        self.client.delete(kind, namespace, name)

    def get_scale(
        self, kind: str, namespace: str, name: str, api_version: str = ""
    ) -> Scale:
        return self.client.get_scale(kind, namespace, name, api_version)

    def update_scale(
        self, kind: str, scale: Scale, api_version: str = ""
    ) -> None:
        self.client.update_scale(kind, scale, api_version)
