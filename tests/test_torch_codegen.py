"""The port's CRD generator (karpenter_tpu_torch/codegen.py) against the
reference's (karpenter_tpu/codegen.py) and the committed files, on the
CPU.

The port reflects its own api/ dataclasses. Its CRDs (config/crd/), the
chart's copies (charts/karpenter-tpu/crds/) and the API reference
(docs/API.md) must equal the reference's output and the committed files
byte for byte: that is the check `--apiserver` needs, since the port's
types must match the schema a cluster has installed. Every write goes
under tmp_path; no committed file is rewritten.
"""

from __future__ import annotations

import filecmp
import os
import shutil

import pytest

import karpenter_tpu.codegen as R
import karpenter_tpu_torch.codegen as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = sorted(R.CRD_KINDS)


def committed(*parts) -> str:
    with open(os.path.join(REPO, *parts)) as f:
        return f.read()


class TestOutputsEqual:
    @pytest.mark.parametrize("kind", KINDS)
    def test_crd_equals_the_reference_and_the_committed_file(self, kind):
        name = f"{P.GROUP}_{P.CRD_KINDS[kind]['plural']}.yaml"
        text = P.crd_yaml(kind)
        assert text == R.crd_yaml(kind)
        assert text == committed("config", "crd", name)
        assert text == committed("charts", "karpenter-tpu", "crds", name)

    @pytest.mark.parametrize("kind", KINDS)
    def test_manifest_equals_the_reference(self, kind):
        assert P.crd_manifest(kind) == R.crd_manifest(kind)

    def test_api_docs_equal_the_reference_and_the_committed_file(self):
        text = P.api_docs_markdown()
        assert text == R.api_docs_markdown()
        assert text == committed("docs", "API.md")

    def test_same_kinds_group_and_version(self):
        assert sorted(P.CRD_KINDS) == KINDS
        assert (P.GROUP, P.VERSION) == (R.GROUP, R.VERSION)
        for kind in KINDS:
            port, ref = dict(P.CRD_KINDS[kind]), dict(R.CRD_KINDS[kind])
            # the classes are each package's own; everything else equal
            assert port.pop("cls").__name__ == ref.pop("cls").__name__
            assert port == ref

    def test_type_labels_name_no_port_path(self):
        """The rendered type labels and defaults print the reference's
        names: nothing of the port's module paths leaks into the docs."""
        assert "karpenter_tpu_torch" not in P.api_docs_markdown()
        for kind in KINDS:
            assert "karpenter_tpu_torch" not in P.crd_yaml(kind)


class TestWriters:
    def test_write_crds_regenerates_the_committed_tree(self, tmp_path):
        """`python -m karpenter_tpu_torch.codegen DIR` into a copy of the
        repo layout: config/crd/ and the chart's crds/ come out byte for
        byte the committed files."""
        shutil.copytree(os.path.join(REPO, "charts"), tmp_path / "charts")
        for name in os.listdir(tmp_path / "charts" / "karpenter-tpu" / "crds"):
            os.remove(tmp_path / "charts" / "karpenter-tpu" / "crds" / name)
        assert P.main([str(tmp_path / "config")]) == 0
        for sub in (("config", "crd"), ("charts", "karpenter-tpu", "crds")):
            names = sorted(os.listdir(os.path.join(REPO, *sub)))
            assert sorted(os.listdir(tmp_path.joinpath(*sub))) == names
            match, mismatch, errors = filecmp.cmpfiles(
                os.path.join(REPO, *sub), tmp_path.joinpath(*sub), names,
                shallow=False,
            )
            assert (mismatch, errors) == ([], []), sub

    def test_without_a_chart_only_config_is_written(self, tmp_path):
        written = P.write_crds(str(tmp_path / "config"))
        assert len(written) == len(KINDS)
        assert not (tmp_path / "charts").exists()

    def test_docs_flag_writes_the_api_reference(self, tmp_path, capsys):
        path = tmp_path / "API.md"
        assert P.main(["--docs", str(path)]) == 0
        assert path.read_text() == committed("docs", "API.md")
        assert f"wrote {path}" in capsys.readouterr().out
