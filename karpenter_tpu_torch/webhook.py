"""Admission webhook server: AdmissionReview v1 validate + mutate endpoints.

The reference registers a Validator/Defaulter admission webhook per CRD on
the manager's webhook server, port 9443 with cert-manager-injected certs
(reference: pkg/controllers/manager.go:61-68; cmd/controller/main.go:50;
config/webhook/). In the TPU build the in-process store already validates
on write, so this server exists for *real-cluster mode*: when the CRDs are
installed on an actual kube-apiserver (config/ manifests), this process
serves the same ValidatingWebhookConfiguration / MutatingWebhookConfiguration
endpoints the reference does, reusing the exact validate()/default() methods
the store path uses — one source of truth for admission rules.

Wire shape is upstream admission.k8s.io/v1: POST an AdmissionReview whose
.request.object is the manifest; the response carries allowed/status for
validation and a base64 JSONPatch for defaulting.

The port's copy of karpenter_tpu/webhook.py: the same rules (the port's
API kinds and the port's autoscaler algorithm registry) and the same
wire answers.
"""

from __future__ import annotations

import base64
import json
import ssl
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import urlsplit

from karpenter_tpu_torch.api.serialization import from_manifest, to_dict

# arm upper-layer validation hooks (e.g. the algorithm-annotation check the
# autoscaler's registry contributes): an admission server must enforce the
# same rules regardless of which process hosts it
import karpenter_tpu_torch.autoscaler.algorithms  # noqa: F401
from karpenter_tpu_torch.utils.log import logger

log = logger()

ADMISSION_API_VERSION = "admission.k8s.io/v1"


def json_patch(before: dict, after: dict, path: str = "") -> List[dict]:
    """RFC 6902 ops transforming `before` into `after` (add/replace/remove).

    Defaulting only ever fills absent fields, but UPDATE-time mutation can
    in principle rewrite any subtree, so all three ops are produced.
    """
    ops: List[dict] = []
    for key in before:
        escaped = str(key).replace("~", "~0").replace("/", "~1")
        p = f"{path}/{escaped}"
        if key not in after:
            ops.append({"op": "remove", "path": p})
        elif isinstance(before[key], dict) and isinstance(after[key], dict):
            ops.extend(json_patch(before[key], after[key], p))
        elif before[key] != after[key]:
            ops.append({"op": "replace", "path": p, "value": after[key]})
    for key in after:
        if key not in before:
            escaped = str(key).replace("~", "~0").replace("/", "~1")
            ops.append({"op": "add", "path": f"{path}/{escaped}", "value": after[key]})
    return ops


# metadata keys the user writes; everything else in metadata is populated
# by the apiserver (generation, managedFields, uid, creationTimestamp,
# resourceVersion, ownerReferences, ...) and must not trip strict decode —
# but the SPEC stays strict: silently dropping a typo'd spec key is
# misconfig that "works" (see serialization.from_dict docstring).
_USER_METADATA_KEYS = ("name", "namespace", "labels", "annotations")


def admission_decode(manifest: dict):
    """Decode a .request.object for admission: strip the server-populated
    parts (metadata bookkeeping, status — which carries RFC3339 condition
    timestamps on UPDATE), then decode the user-authored remainder
    STRICTLY so unknown spec fields are still denied, not dropped."""
    doc = dict(manifest)
    meta = doc.get("metadata")
    if isinstance(meta, dict):
        doc["metadata"] = {
            k: v for k, v in meta.items() if k in _USER_METADATA_KEYS
        }
    doc.pop("status", None)  # status writes don't go through admission
    return from_manifest(doc)


def review_validate(review: dict) -> dict:
    """AdmissionReview request -> AdmissionReview response (validation)."""
    request = review.get("request") or {}
    uid = request.get("uid", "")
    try:
        obj = admission_decode(request.get("object") or {})
        obj.validate()
    except Exception as err:  # any admission failure -> denied, message out
        return _response(uid, allowed=False, message=str(err))
    return _response(uid, allowed=True)


def review_mutate(review: dict) -> dict:
    """AdmissionReview request -> response carrying the defaulting patch."""
    request = review.get("request") or {}
    uid = request.get("uid", "")
    manifest = request.get("object") or {}
    try:
        # the patch is computed between two admission_decode round-trips,
        # so server-populated fields absent from both sides never appear
        # in the JSONPatch.
        obj = admission_decode(manifest)
        before = to_dict(obj)
        obj.default()
        after = to_dict(obj)
    except Exception as err:
        return _response(uid, allowed=False, message=str(err))
    ops = json_patch(before, after)
    response = _response(uid, allowed=True)
    if ops:
        response["response"]["patchType"] = "JSONPatch"
        response["response"]["patch"] = base64.b64encode(
            json.dumps(ops).encode()
        ).decode()
    return response


def _response(uid: str, allowed: bool, message: str = "") -> dict:
    response = {"uid": uid, "allowed": allowed}
    if message:
        response["status"] = {"message": message, "code": 400}
    return {
        "apiVersion": ADMISSION_API_VERSION,
        "kind": "AdmissionReview",
        "response": response,
    }


class WebhookServer:
    """Serves /validate and /mutate (reference webhook port: 9443).

    TLS is required by real apiservers; pass cert_file/key_file (the
    config/ manifests mount a cert-manager secret at /tmp/k8s-webhook-server
    exactly like the reference's Deployment does). Without certs the server
    speaks plain HTTP — test and local-dev mode.
    port=0 binds an ephemeral port; the bound port is returned by start().
    """

    def __init__(
        self,
        port: int = 9443,
        host: str = "0.0.0.0",
        cert_file: Optional[str] = None,
        key_file: Optional[str] = None,
    ):
        self.port = port
        self.host = host
        self.cert_file = cert_file
        self.key_file = key_file
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                path = urlsplit(self.path).path.rstrip("/")
                if path in ("", "/healthz", "/readyz"):
                    self._send(200, b"ok", "text/plain")
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):  # noqa: N802
                path = urlsplit(self.path).path.rstrip("/")
                handler = {
                    "/validate": review_validate,
                    "/mutate": review_mutate,
                    # reference-compatible aliases (controller-runtime style)
                    "/validate-autoscaling-karpenter-sh-v1alpha1": review_validate,
                    "/default-autoscaling-karpenter-sh-v1alpha1": review_mutate,
                }.get(path)
                if handler is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    review = json.loads(self.rfile.read(length))
                    body = json.dumps(handler(review)).encode()
                except Exception as err:
                    log.warning("webhook: malformed AdmissionReview: %s", err)
                    self._send(400, str(err).encode(), "text/plain")
                    return
                self._send(200, body, "application/json")

            def _send(self, code: int, body: bytes, content_type: str):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        if self.cert_file and self.key_file:
            context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            context.load_cert_chain(self.cert_file, self.key_file)
            self._server.socket = context.wrap_socket(
                self._server.socket, server_side=True
            )
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
