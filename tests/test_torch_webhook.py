"""The port's admission webhook (karpenter_tpu_torch/webhook.py) on the
CPU: the reference's tests/test_webhook.py run against the port (the TLS
case keeps its openssl skip), and the port's review_validate,
review_mutate and json_patch equal the reference's over every manifest in
docs/examples/*.yaml and over a seeded set of invalid ones (bad cron
fields, min > max, a two-label selector, unknown spec keys and kinds).
"""

import base64
import copy
import importlib
import json
import pathlib
import shutil
import ssl
import subprocess
import urllib.request

import pytest

from karpenter_tpu_torch.webhook import (
    WebhookServer,
    json_patch,
    review_mutate,
    review_validate,
)


def review(manifest, uid="test-uid"):
    return {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "request": {"uid": uid, "operation": "CREATE", "object": manifest},
    }


def ha_manifest(min_replicas=1, max_replicas=10):
    return {
        "apiVersion": "autoscaling.karpenter.sh/v1alpha1",
        "kind": "HorizontalAutoscaler",
        "metadata": {"name": "ha", "namespace": "default"},
        "spec": {
            "scaleTargetRef": {
                "apiVersion": "autoscaling.karpenter.sh/v1alpha1",
                "kind": "ScalableNodeGroup",
                "name": "group",
            },
            "minReplicas": min_replicas,
            "maxReplicas": max_replicas,
        },
    }


def schedule_manifest(weekday="Monday"):
    return {
        "apiVersion": "autoscaling.karpenter.sh/v1alpha1",
        "kind": "MetricsProducer",
        "metadata": {"name": "mp", "namespace": "default"},
        "spec": {
            "scheduleSpec": {
                "timezone": "America/Los_Angeles",
                "defaultReplicas": 1,
                "behaviors": [
                    {
                        "replicas": 5,
                        "start": {"weekdays": [weekday], "hours": ["9"]},
                        "end": {"weekdays": [weekday], "hours": ["17"]},
                    }
                ],
            }
        },
    }


class TestReviewHandlers:
    def test_validate_allows_good_object(self):
        out = review_validate(review(ha_manifest()))
        assert out["response"] == {"uid": "test-uid", "allowed": True}
        assert out["kind"] == "AdmissionReview"

    def test_validate_denies_min_over_max(self):
        out = review_validate(review(ha_manifest(min_replicas=9, max_replicas=2)))
        assert out["response"]["allowed"] is False
        assert "maxReplicas" in out["response"]["status"]["message"]

    def test_validate_denies_bad_cron_field(self):
        out = review_validate(review(schedule_manifest(weekday="Blursday")))
        assert out["response"]["allowed"] is False

    def test_validate_denies_unknown_kind(self):
        out = review_validate(
            review({"kind": "Gadget", "apiVersion": "v1", "metadata": {}})
        )
        assert out["response"]["allowed"] is False

    def test_mutate_noop_defaults_produce_no_patch(self):
        # reference defaulting for these kinds is a no-op at admission time
        # (behavior defaults merge at decision time, GetScalingRules)
        out = review_mutate(review(ha_manifest()))
        assert out["response"]["allowed"] is True
        assert "patch" not in out["response"]

    def test_mutate_denies_undecodable_object(self):
        out = review_mutate(review({"kind": "HorizontalAutoscaler"}))
        assert out["response"]["allowed"] is False


def with_apiserver_metadata(manifest):
    """What .request.object actually looks like on a real cluster: the
    apiserver has already populated metadata the model doesn't track
    (generation, managedFields, uid, RFC3339 creationTimestamp). A strict
    decode denies every CREATE/UPDATE of the CRDs once the webhook is
    installed — the round-1 advisor's high-severity finding."""
    manifest["metadata"].update(
        {
            "uid": "0b1e5e2e-3f74-4a1c-9d8f-2b8a4c7d6e5f",
            "resourceVersion": "8675309",
            "generation": 1,
            "creationTimestamp": "2026-07-29T12:00:00Z",
            "managedFields": [
                {
                    "manager": "kubectl-client-side-apply",
                    "operation": "Update",
                    "apiVersion": "autoscaling.karpenter.sh/v1alpha1",
                    "time": "2026-07-29T12:00:00Z",
                    "fieldsType": "FieldsV1",
                    "fieldsV1": {"f:spec": {}},
                }
            ],
        }
    )
    return manifest


class TestApiserverPopulatedObjects:
    def test_validate_allows_server_populated_metadata(self):
        out = review_validate(review(with_apiserver_metadata(ha_manifest())))
        assert out["response"]["allowed"] is True, out["response"]

    def test_validate_still_enforces_rules_on_server_objects(self):
        out = review_validate(
            review(
                with_apiserver_metadata(
                    ha_manifest(min_replicas=9, max_replicas=2)
                )
            )
        )
        assert out["response"]["allowed"] is False

    def test_validate_still_denies_typoed_spec_key(self):
        """Leniency is scoped to server-populated metadata/status — a
        typo'd SPEC key must stay a hard deny, not silently-dropped
        misconfig that 'works'."""
        manifest = with_apiserver_metadata(ha_manifest())
        manifest["spec"]["minReplica"] = manifest["spec"].pop("minReplicas")
        out = review_validate(review(manifest))
        assert out["response"]["allowed"] is False
        assert "minReplica" in out["response"]["status"]["message"]

    def test_validate_allows_status_with_server_timestamps(self):
        """UPDATE admission objects carry status whose condition timestamps
        are RFC3339 strings; status is dropped before decode (status writes
        don't go through admission)."""
        manifest = with_apiserver_metadata(ha_manifest())
        manifest["status"] = {
            "currentReplicas": 3,
            "conditions": [
                {
                    "type": "Active",
                    "status": "True",
                    "lastTransitionTime": "2026-07-29T12:00:00Z",
                }
            ],
        }
        out = review_validate(review(manifest))
        assert out["response"]["allowed"] is True, out["response"]

    def test_mutate_allows_and_never_patches_server_metadata(self):
        out = review_mutate(review(with_apiserver_metadata(ha_manifest())))
        assert out["response"]["allowed"] is True, out["response"]
        if "patch" in out["response"]:
            ops = json.loads(base64.b64decode(out["response"]["patch"]))
            # server-populated fields are absent from both round-trips, so
            # the defaulting patch must never add/remove/replace them
            assert not any(op["path"].startswith("/metadata") for op in ops)


class TestJsonPatch:
    def test_add_replace_remove(self):
        before = {"a": 1, "b": {"c": 2, "gone": 3}}
        after = {"a": 9, "b": {"c": 2, "new": 4}}
        ops = json_patch(before, after)
        assert {"op": "replace", "path": "/a", "value": 9} in ops
        assert {"op": "remove", "path": "/b/gone"} in ops
        assert {"op": "add", "path": "/b/new", "value": 4} in ops
        assert len(ops) == 3

    def test_path_escaping(self):
        ops = json_patch({}, {"a/b": {"c~d": 1}})
        assert ops == [{"op": "add", "path": "/a~1b", "value": {"c~d": 1}}]

    def test_patch_is_base64_json_when_present(self):
        # force a patch through the wire shape by defaulting a dict diff
        out = review_mutate(review(ha_manifest()))
        if "patch" in out["response"]:  # defensive: decode must round-trip
            json.loads(base64.b64decode(out["response"]["patch"]))


def _post(url, body, context=None):
    req = urllib.request.Request(
        url,
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=5, context=context) as resp:
        return resp.status, json.loads(resp.read())


class TestServer:
    def test_http_validate_and_mutate(self):
        server = WebhookServer(port=0, host="127.0.0.1")
        port = server.start()
        try:
            status, out = _post(
                f"http://127.0.0.1:{port}/validate", review(ha_manifest())
            )
            assert status == 200 and out["response"]["allowed"] is True
            status, out = _post(
                f"http://127.0.0.1:{port}/validate",
                review(ha_manifest(min_replicas=5, max_replicas=1)),
            )
            assert status == 200 and out["response"]["allowed"] is False
            status, out = _post(
                f"http://127.0.0.1:{port}/mutate", review(ha_manifest())
            )
            assert status == 200 and out["response"]["allowed"] is True
        finally:
            server.stop()

    def test_http_malformed_body_400(self):
        server = WebhookServer(port=0, host="127.0.0.1")
        port = server.start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/validate",
                data=b"{not json",
                headers={"Content-Type": "application/json"},
            )
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=5)
            assert err.value.code == 400
        finally:
            server.stop()

    def test_http_unknown_path_404(self):
        server = WebhookServer(port=0, host="127.0.0.1")
        port = server.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(f"http://127.0.0.1:{port}/nope", review(ha_manifest()))
            assert err.value.code == 404
        finally:
            server.stop()

    @pytest.mark.skipif(
        shutil.which("openssl") is None, reason="openssl not available"
    )
    def test_tls_serving(self, tmp_path):
        """Real apiservers require TLS on the webhook (reference: 9443 +
        cert-manager certs); assert the server actually speaks it."""
        crt, key = str(tmp_path / "tls.crt"), str(tmp_path / "tls.key")
        subprocess.run(
            [
                "openssl", "req", "-x509", "-newkey", "rsa:2048",
                "-keyout", key, "-out", crt, "-days", "1", "-nodes",
                "-subj", "/CN=127.0.0.1",
            ],
            check=True,
            capture_output=True,
        )
        server = WebhookServer(
            port=0, host="127.0.0.1", cert_file=crt, key_file=key
        )
        port = server.start()
        try:
            context = ssl.create_default_context()
            context.check_hostname = False
            context.verify_mode = ssl.CERT_NONE
            status, out = _post(
                f"https://127.0.0.1:{port}/validate",
                review(ha_manifest()),
                context=context,
            )
            assert status == 200 and out["response"]["allowed"] is True
        finally:
            server.stop()


# -- parity with the reference ------------------------------------------------

REPO = pathlib.Path(__file__).resolve().parent.parent


def example_manifests():
    import yaml

    out = []
    for path in sorted((REPO / "docs" / "examples").glob("*.yaml")):
        for i, doc in enumerate(yaml.safe_load_all(path.read_text())):
            if doc:
                out.append(pytest.param(doc, id=f"{path.stem}-{i}"))
    return out


def invalid_manifests():
    """A seeded draw of manifests each admission rule must deny: bad cron
    fields, min > max, a two-label selector, an unknown spec key, an
    unknown kind, a bad timezone."""
    import random

    rng = random.Random(10)
    out = []
    for i in range(4):
        weekday = rng.choice(["Blursday", "Mon-Blur", "8", "Sundae"])
        hours = rng.choice(["9", "25", "nine"])
        doc = schedule_manifest()
        behavior = doc["spec"]["scheduleSpec"]["behaviors"][0]
        behavior["start"] = {"weekdays": weekday, "hours": hours}
        behavior["end"] = {"weekdays": "Fri", "hours": "17"}
        out.append(("bad_cron", doc))
        hi = rng.randint(1, 50)
        out.append(("min_over_max",
                    ha_manifest(min_replicas=hi + rng.randint(1, 9),
                                max_replicas=hi)))
    for i in range(3):
        doc = {
            "apiVersion": "autoscaling.karpenter.sh/v1alpha1",
            "kind": "MetricsProducer",
            "metadata": {"name": f"mp{i}", "namespace": "default"},
            "spec": {"reservedCapacity": {"nodeSelector": {
                f"k{j}": f"v{rng.randint(0, 9)}" for j in range(2 + i)}}},
        }
        out.append(("multi_label_selector", doc))
    typo = ha_manifest()
    typo["spec"]["maxReplica"] = typo["spec"].pop("maxReplicas")
    out.append(("typoed_spec_key", typo))
    out.append(("unknown_kind", {"kind": "Gadget", "apiVersion": "v1",
                                 "metadata": {"name": "g"}}))
    bad_zone = schedule_manifest()
    bad_zone["spec"]["scheduleSpec"]["timezone"] = "Mars/Olympus_Mons"
    out.append(("bad_timezone", bad_zone))
    valid = schedule_manifest()
    behavior = valid["spec"]["scheduleSpec"]["behaviors"][0]
    behavior["start"] = {"weekdays": "Mon,Tue", "hours": "9"}
    behavior["end"] = {"weekdays": "Mon,Tue", "hours": "17"}
    assert review_validate(review(valid))["response"]["allowed"] is True
    return [pytest.param(doc, id=f"{name}-{i}")
            for i, (name, doc) in enumerate(out)]


def both(fn_name, manifest):
    from karpenter_tpu import webhook as ref

    from karpenter_tpu_torch import webhook as port

    request = review(copy.deepcopy(manifest))
    return (getattr(port, fn_name)(copy.deepcopy(request)),
            getattr(ref, fn_name)(copy.deepcopy(request)))


class TestParityWithReference:
    @pytest.mark.parametrize("manifest", example_manifests())
    @pytest.mark.parametrize("fn", ["review_validate", "review_mutate"])
    def test_examples(self, fn, manifest):
        # the examples' node groups name the AWS and TPU providers'
        # types, whose validators their modules register when imported,
        # in both packages: once they are, the port answers as the
        # reference does, allowing or denying alike
        for package in ("karpenter_tpu", "karpenter_tpu_torch"):
            for provider in ("aws", "tpu"):
                importlib.import_module(f"{package}.cloudprovider.{provider}")
        from karpenter_tpu_torch.api.scalablenodegroup import _validators

        got, want = both(fn, manifest)
        node_type = (manifest.get("spec") or {}).get("type")
        if manifest["kind"] == "ScalableNodeGroup":
            assert node_type in _validators
        assert got == want

    @pytest.mark.parametrize("manifest", invalid_manifests())
    @pytest.mark.parametrize("fn", ["review_validate", "review_mutate"])
    def test_invalid(self, fn, manifest):
        got, want = both(fn, manifest)
        assert got == want
        if fn == "review_validate":
            assert got["response"]["allowed"] is False, got

    @pytest.mark.parametrize("manifest", example_manifests())
    def test_json_patch_of_defaulting(self, manifest):
        """json_patch between the decoded manifest and its defaulted form,
        and between the manifest and an edited copy, equal the
        reference's."""
        from karpenter_tpu import webhook as ref
        from karpenter_tpu.api.serialization import to_dict as ref_to_dict

        from karpenter_tpu_torch import webhook as port
        from karpenter_tpu_torch.api.serialization import to_dict

        obj = port.admission_decode(copy.deepcopy(manifest))
        before = to_dict(obj)
        obj.default()
        ref_obj = ref.admission_decode(copy.deepcopy(manifest))
        ref_before = ref_to_dict(ref_obj)
        ref_obj.default()
        assert before == ref_before
        assert port.json_patch(before, to_dict(obj)) == ref.json_patch(
            ref_before, ref_to_dict(ref_obj))
        edited = copy.deepcopy(manifest)
        edited.setdefault("metadata", {})["labels"] = {"a/b": "c~d"}
        edited.get("spec", {}).pop(next(iter(edited.get("spec") or {"": 0})),
                                    None)
        assert port.json_patch(manifest, edited) == ref.json_patch(
            manifest, edited)
