"""The port's shipped Deployment: config/torch (a kustomize overlay over
the root tree) and Dockerfile.torch, on the CPU.

There is no kustomize here: hack/render_overlay.py renders the overlay
(resources, and JSON 6902 patches with a target; anything else fails
loudly), and where `kubectl` is at hand its `kubectl kustomize` output
is held to the same documents. The rendered Deployment runs the port's
sidecar on one GPU of an H100 node, its containers' args parse with the
port's own parsers, every other document is the root tree's, and the
overlay and the image agree on where the kernels load from: the image
prebuilds them into the package, and no cache directory asks a runtime
layer without nvcc to build them. chip_smoke.py's phase 16 (b) runs
the same rendered command lines on the card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import yaml

import chip_smoke
from karpenter_tpu_torch import kernels
from karpenter_tpu_torch import prebuild as PB
from karpenter_tpu_torch.__main__ import parse_args as controller_args
from karpenter_tpu_torch.sidecar.server import parse_args as sidecar_args

REPO = pathlib.Path(__file__).resolve().parents[1]
OVERLAY = REPO / "config" / "torch"
DOCKERFILE = REPO / "Dockerfile.torch"


def _renderer():
    spec = importlib.util.spec_from_file_location(
        "render_overlay", REPO / "hack" / "render_overlay.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


R = _renderer()


def _is_deployment(doc) -> bool:
    return (doc.get("kind") == "Deployment"
            and doc["metadata"]["name"] == "karpenter-tpu")


@pytest.fixture(scope="module")
def rendered():
    return R.render(OVERLAY)


@pytest.fixture(scope="module")
def containers(rendered):
    (deployment,) = [d for d in rendered if _is_deployment(d)]
    return {c["name"]: c
            for c in deployment["spec"]["template"]["spec"]["containers"]}


def _stages(text: str) -> list:
    """Dockerfile stages: [(FROM line, [instructions])]."""
    stages = []
    for line in text.splitlines():
        if line.startswith("FROM "):
            stages.append((line, []))
        elif stages and re.match(r"^[A-Z]+ ", line):
            stages[-1][1].append(line)
    return stages


def build_dir_conflict(solver: dict, dockerfile: str):
    """Why a solver container and an image cannot both stand, or None.
    The port's --compile-cache-dir (and KARPENTER_COMPILE_CACHE) names the
    directory the CUDA kernels load from and build into; a fresh pod's
    emptyDir there is empty, so the sidecar runs nvcc, which a runtime
    stage built on a CUDA image without the toolkit lacks: the sidecar
    then exits 1."""
    args = " ".join(solver.get("args") or [])
    env = {e["name"] for e in solver.get("env") or []}
    names_cache = ("--compile-cache-dir" in args
                   or "KARPENTER_COMPILE_CACHE" in env)
    runtime = _stages(dockerfile)[-1][0]
    if names_cache and "-devel" not in runtime:
        return (f"the solver names a kernel cache directory and the image's "
                f"runtime stage ({runtime}) has no nvcc")
    return None


class TestRenderedDeployment:
    def test_solver_runs_the_port_sidecar(self, containers):
        assert containers["solver"]["command"] == [
            "python", "-m", "karpenter_tpu_torch.sidecar"]
        assert "command" not in containers["controller"]  # the entry point

    def test_args_parse_with_the_ports_parsers(self, containers):
        solver = sidecar_args(containers["solver"]["args"])
        assert solver.port == 9090 and solver.device == "cuda"
        assert solver.compile_cache_dir in ("", os.environ.get(
            "KARPENTER_COMPILE_CACHE", ""))
        controller = controller_args(containers["controller"]["args"])
        assert controller.solver_uri == "127.0.0.1:9090"
        assert controller.cloud_provider == "tpu"
        assert controller.device == "cuda"

    def test_no_container_passes_device_cpu(self, containers):
        for container in containers.values():
            args = " ".join(container.get("args") or [])
            assert "--device" not in args, container["name"]

    def test_gpu_on_the_solver_only_and_no_tpu(self, rendered, containers):
        resources = containers["solver"]["resources"]
        assert resources["requests"]["nvidia.com/gpu"] == 1
        assert resources["limits"]["nvidia.com/gpu"] == 1
        assert "nvidia.com/gpu" not in json.dumps(
            containers["controller"]["resources"])
        assert "google.com/tpu" not in yaml.safe_dump_all(rendered)
        assert "gke-tpu-accelerator" not in yaml.safe_dump_all(rendered)

    def test_h100_node_pool_and_gpu_taint(self, rendered):
        (deployment,) = [d for d in rendered if _is_deployment(d)]
        spec = deployment["spec"]["template"]["spec"]
        assert spec["nodeSelector"] == {
            "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
        assert {"key": "nvidia.com/gpu", "operator": "Exists",
                "effect": "NoSchedule"} in spec["tolerations"]

    def test_both_images_are_the_ports(self, containers):
        images = {c["image"] for c in containers.values()}
        assert images == {"karpenter-tpu-torch:latest"}

    def test_controller_keeps_the_reference_flags(self, containers):
        root = R.render(REPO / "config")
        (deployment,) = [d for d in root if _is_deployment(d)]
        (reference,) = [c for c in deployment["spec"]["template"]["spec"]
                        ["containers"] if c["name"] == "controller"]
        assert containers["controller"]["args"] == reference["args"]

    def test_every_other_document_is_the_root_trees(self, rendered):
        root = R.render(REPO / "config")
        assert len(root) == len(rendered)
        for ours, theirs in zip(rendered, root):
            if _is_deployment(ours):
                assert _is_deployment(theirs)
                continue
            assert yaml.safe_dump(ours) == yaml.safe_dump(theirs)

    def test_no_cache_volume_is_left(self, rendered, containers):
        (deployment,) = [d for d in rendered if _is_deployment(d)]
        volumes = [v["name"] for v in deployment["spec"]["template"]["spec"]
                   ["volumes"]]
        assert volumes == ["cert"]
        assert "volumeMounts" not in containers["solver"]

    def test_kubectl_kustomize_renders_the_same(self, rendered):
        kubectl = shutil.which("kubectl")
        if kubectl is None:
            pytest.skip("kubectl is not installed: the repo's renderer alone")
        out = subprocess.run([kubectl, "kustomize", str(OVERLAY)],
                             capture_output=True, text=True, timeout=120,
                             check=True).stdout

        def key(doc):
            return (doc["kind"], doc["metadata"]["name"])

        theirs = sorted(yaml.safe_load_all(out), key=key)
        assert [yaml.safe_dump(d) for d in theirs] == [
            yaml.safe_dump(d) for d in sorted(rendered, key=key)]


class TestImageFile:
    def test_two_stages_the_port_only(self):
        text = DOCKERFILE.read_text()
        (build, steps), (runtime, final) = _stages(text)
        assert "-devel-" in build and " AS build" in build
        assert "-base-" in runtime
        assert "COPY karpenter_tpu_torch ./karpenter_tpu_torch" in steps
        assert not re.search(r"COPY karpenter_tpu\s", text)
        assert "download.pytorch.org/whl/cu128" in text
        assert final[-1] == 'ENTRYPOINT ["karpenter-tpu-torch"]'
        assert "USER 65532" in final

    def test_build_stage_prebuilds_into_the_installed_package(self):
        text = DOCKERFILE.read_text()
        build_stage = text.split("\nFROM ", 2)[1]
        assert "from karpenter_tpu_torch.prebuild import prebuild" in \
            build_stage
        assert '"site-packages" in karpenter_tpu_torch.__file__' in \
            build_stage
        assert "WORKDIR /\nRUN python" in build_stage
        runtime_stage = text.split("\nFROM ", 2)[2]
        assert "kernels.build()" in runtime_stage  # loads, never nvcc

    def test_entry_point_and_sidecar_module_exist(self):
        scripts = pathlib.Path(REPO / "pyproject.toml").read_text()
        assert ('karpenter-tpu-torch = "karpenter_tpu_torch.__main__:main"'
                in scripts)
        assert importlib.util.find_spec("karpenter_tpu_torch.sidecar")

    def test_torch_extra(self):
        import tomllib

        with open(REPO / "pyproject.toml", "rb") as fh:
            project = tomllib.load(fh)["project"]
        assert any(r.startswith("torch") for r in
                   project["optional-dependencies"]["torch"])
        assert not any("torch" in r for r in project["dependencies"])


class TestBuildDirectory:
    def test_shipped_overlay_and_image_agree(self, containers):
        assert build_dir_conflict(containers["solver"],
                                  DOCKERFILE.read_text()) is None

    @pytest.mark.parametrize("named", [
        {"args": ["--port=9090", "--compile-cache-dir=/var/cache/kernels"]},
        {"args": ["--port=9090"],
         "env": [{"name": "KARPENTER_COMPILE_CACHE", "value": "/cache"}]},
    ], ids=["flag", "env"])
    def test_a_cache_dir_and_a_runtime_without_nvcc_cannot_both_stand(
        self, containers, named
    ):
        solver = dict(containers["solver"], **named)
        text = DOCKERFILE.read_text()
        assert "no nvcc" in build_dir_conflict(solver, text)
        devel = text.replace("nvidia/cuda:12.8.1-base-ubuntu24.04",
                             "nvidia/cuda:12.8.1-devel-ubuntu24.04")
        assert build_dir_conflict(solver, devel) is None

    def test_build_over_a_full_directory_calls_no_nvcc(self, tmp_path,
                                                       monkeypatch):
        monkeypatch.setattr(kernels, "BUILD", tmp_path)

        def no_nvcc():
            raise AssertionError("nvcc called")

        monkeypatch.setattr(kernels, "nvcc", no_nvcc)
        for name in kernels.SOURCES:
            kernels._target(name).write_bytes(b"prebuilt")
        assert kernels.build() == {
            name: tmp_path / kernels._target(name).name
            for name in kernels.SOURCES}
        kernels._target(kernels.SOURCES[0]).unlink()
        with pytest.raises(AssertionError, match="nvcc called"):
            kernels.build()

    def test_target_is_keyed_by_source_and_flags(self, monkeypatch):
        name = kernels.SOURCES[0]
        before = kernels._target(name)
        assert kernels._target(name) == before  # a rebuilt image matches
        monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-G",))
        assert kernels._target(name) != before

    def test_prebuild_main_names_every_library(self, tmp_path, monkeypatch,
                                               capsys):
        """The C helpers build here; the CUDA kernels need nvcc, so their
        build is stood in for by the targets it would return."""
        monkeypatch.setattr(kernels, "BUILD", kernels.BUILD)
        monkeypatch.setattr(kernels, "build", lambda: {})
        assert PB.main([str(tmp_path)]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["build"] == str(tmp_path.resolve())
        assert set(line["libraries"]) == {"kbinpack", "kquantity"}
        assert all(os.path.exists(p) for p in line["libraries"].values())
        assert PB.main(["a", "b"]) == 2


class TestRenderer:
    def test_unrendered_features_fail_loudly(self, tmp_path):
        (tmp_path / "kustomization.yaml").write_text(
            "resources: [x.yaml]\nimages: [{name: a, newName: b}]\n")
        with pytest.raises(R.Unsupported, match="images"):
            R.render(tmp_path)
        (tmp_path / "kustomization.yaml").write_text(
            "resources: [x.yaml]\npatches:\n- path: p.yaml\n")
        (tmp_path / "x.yaml").write_text("kind: A\nmetadata: {name: a}\n")
        with pytest.raises(R.Unsupported, match="inline JSON 6902"):
            R.render(tmp_path)
        (tmp_path / "kustomization.yaml").write_text(
            "resources: [x.yaml]\npatches:\n- target: {kind: A}\n"
            "  patch: 'metadata: {name: b}'\n")
        with pytest.raises(R.Unsupported, match="strategic-merge"):
            R.render(tmp_path)

    def test_json6902_ops(self):
        doc = {"a": {"b/c": [1, 2]}, "d": 1}
        R.apply_op(doc, {"op": "test", "path": "/a/b~1c/1", "value": 2})
        R.apply_op(doc, {"op": "add", "path": "/a/b~1c/-", "value": 3})
        R.apply_op(doc, {"op": "add", "path": "/a/b~1c/0", "value": 0})
        R.apply_op(doc, {"op": "replace", "path": "/d", "value": [4]})
        R.apply_op(doc, {"op": "remove", "path": "/a/b~1c/1"})
        assert doc == {"a": {"b/c": [0, 2, 3]}, "d": [4]}
        with pytest.raises(ValueError, match="test /d"):
            R.apply_op(doc, {"op": "test", "path": "/d", "value": 4})
        with pytest.raises(ValueError, match="no such member"):
            R.apply_op(doc, {"op": "remove", "path": "/e"})
        with pytest.raises(R.Unsupported):
            R.apply_op(doc, {"op": "move", "path": "/d", "from": "/a"})

    def test_a_reordered_root_fails_the_render(self, tmp_path):
        """The overlay's `test` ops pin the container and volume at each
        index it patches."""
        (tmp_path / "config").mkdir()
        shutil.copytree(REPO / "config" / "torch", tmp_path / "config" / "torch")
        for rel in yaml.safe_load((REPO / "config" / "kustomization.yaml")
                                    .read_text())["resources"]:
            target = tmp_path / "config" / rel
            target.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(REPO / "config" / rel, target)
        shutil.copy(REPO / "config" / "kustomization.yaml",
                    tmp_path / "config" / "kustomization.yaml")
        manager = tmp_path / "config" / "manager" / "manager.yaml"
        docs = list(yaml.safe_load_all(manager.read_text()))
        spec = docs[2]["spec"]["template"]["spec"]
        spec["containers"].reverse()
        manager.write_text(yaml.safe_dump_all(docs))
        with pytest.raises(ValueError, match="test /spec/template/spec/"
                                             "containers/0/name"):
            R.render(tmp_path / "config" / "torch")

    def test_cli_prints_the_documents(self):
        out = subprocess.run(
            [sys.executable, str(REPO / "hack" / "render_overlay.py"),
             str(OVERLAY)], capture_output=True, text=True, timeout=60,
            check=True).stdout
        assert list(yaml.safe_load_all(out)) == R.render(OVERLAY)


class TestSmokeCommandLines:
    """chip_smoke.py phase 16 (b)'s substitutions on the rendered
    overlay: the endpoints only."""

    def test_sidecar_endpoints_substituted(self, containers, tmp_path):
        module, args, names_cache = chip_smoke._overlay_sidecar(
            containers["solver"], str(tmp_path))
        assert module == "karpenter_tpu_torch.sidecar"
        assert args == ["--port=0", "--host=127.0.0.1"]
        assert not names_cache
        cached = dict(containers["solver"], args=[
            "--port", "9090", "--compile-cache-dir=/var/cache/k",
            "--warmup-pods=64"])
        _, args, names_cache = chip_smoke._overlay_sidecar(cached,
                                                           str(tmp_path))
        assert args == ["--port=0", f"--compile-cache-dir={tmp_path}",
                        "--warmup-pods=64", "--host=127.0.0.1"]
        assert names_cache
        parsed = sidecar_args(args)
        assert (parsed.port, parsed.host, parsed.warmup_pods) == (
            0, "127.0.0.1", 64)

    def test_controller_keeps_the_flags_that_name_no_endpoint(self,
                                                             containers):
        flags = chip_smoke._overlay_controller_flags(containers["controller"])
        assert flags == ["--cloud-provider=tpu"]
        extra = dict(containers["controller"], args=containers["controller"]
                     ["args"] + ["--fused-tick", "--tick=2"])
        assert chip_smoke._overlay_controller_flags(extra) == [
            "--cloud-provider=tpu", "--fused-tick", "--tick=2"]

    def test_overlay_sidecar_serves_and_closes_with_its_counts(self,
                                                               containers,
                                                               tmp_path):
        """The solver container's command line, as phase 16 (b) runs it,
        on the CPU (`--device cpu` appended, as the phase's rehearsal
        does): it serves, and SIGTERM ends it with 0 and a closing line
        of the RPCs it answered, the kernels it launched and its peak
        resident memory."""
        module, args, _ = chip_smoke._overlay_sidecar(containers["solver"],
                                                      str(tmp_path))
        sidecar = chip_smoke._Sidecar(
            args + ["--device", "cpu"], module=module,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                     NO_GCE_CHECK="true"))
        try:
            assert sidecar.wait_serving(timeout=120) > 0
        finally:
            rc = sidecar.stop()
        assert rc == 0
        assert sidecar.summary["stopped"] == f"127.0.0.1:{sidecar.port}"
        assert sidecar.summary["rpcs"]["Solve"] == [0, 0]
        assert sidecar.summary["launches"] == {
            "fused_assign": 0, "shelf_bfd": 0, "demand_reduce": 0,
            "pack_bits": 0}
        assert sidecar.summary["peak_rss_mib"] > 0
