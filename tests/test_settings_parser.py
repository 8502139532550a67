"""The settings reader against PyYAML's reading of the same files."""

import glob
import os
import re

import numpy as np
import pytest

from orb_slam2_refactored_tpu.config import Settings, _load_opencv_yaml

yaml = pytest.importorskip("yaml")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pyyaml(path):
    text = open(path).read()
    text = re.sub(r"^%YAML[:\s][^\n]*\n", "", text)
    return yaml.safe_load(text.replace("!!opencv-matrix", "")) or {}


def _euroc_file(tmp_path):
    from orb_slam2_refactored_tpu.io.synthetic import (
        euroc_settings_yaml, make_euroc_rig,
    )

    p = tmp_path / "euroc.yaml"
    p.write_text(euroc_settings_yaml(make_euroc_rig()))
    return str(p)


@pytest.mark.parametrize(
    "name", sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(REPO, "configs", "*.yaml")))
    + ["euroc"])
def test_matches_pyyaml(name, tmp_path):
    path = (_euroc_file(tmp_path) if name == "euroc"
            else os.path.join(REPO, "configs", name))
    assert _load_opencv_yaml(path) == _pyyaml(path)


def test_multiline_matrix_and_comments(tmp_path):
    p = tmp_path / "s.yaml"
    p.write_text("%YAML:1.0\n# a comment\nCamera.fx: 458.654  # inline\n"
                 "Camera.name: \"cam0\"\nCam.K: !!opencv-matrix\n"
                 "   rows: 2\n   cols: 2\n   dt: d\n"
                 "   data: [ 1., 2.5,\n           -3, 4e-05 ]\n")
    d = _load_opencv_yaml(str(p))
    assert d == _pyyaml(str(p))
    assert d["Camera.fx"] == 458.654 and d["Camera.name"] == "cam0"
    st = Settings.from_yaml(str(p))
    assert st.camera.fx == 458.654
    assert st.raw["Cam.K"]["rows"] == 2
    np.testing.assert_array_equal(
        np.asarray(st.raw["Cam.K"]["data"][:3], np.float64), [1.0, 2.5, -3])
