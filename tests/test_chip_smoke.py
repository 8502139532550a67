"""chip_smoke.py's contract where there is no GPU: refuse, and say why."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_exits_nonzero_on_cpu_without_ok_line():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


@pytest.mark.parametrize("line,name,limit", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n", "NVIDIA H100 80GB HBM3", "700.00 W"),
    ("NVIDIA H100, 450.00 W", "NVIDIA H100", "450.00 W"),
])
def test_parses_nvidia_smi_line(line, name, limit):
    assert chip_smoke.parse_smi_line(line) == (name, limit)


def test_rejects_malformed_nvidia_smi_line():
    with pytest.raises(ValueError):
        chip_smoke.parse_smi_line("NVIDIA H100 80GB HBM3")


def test_four_cards_selects_only_the_sharded_phase():
    assert chip_smoke.phase_names(four_cards=True) == ["four-cards"]
    default = chip_smoke.phase_names(four_cards=False)
    assert "four-cards" not in default
    assert default == ["device", "rgbd", "stereo", "mono", "parity"]


def test_popcount_oracle_small():
    import numpy as np

    a = np.array([[0] * 8, [0xFFFFFFFF] * 8], np.uint32)
    np.testing.assert_array_equal(chip_smoke.popcount_oracle(a, a),
                                  [[0, 256], [256, 0]])


def test_main_path_imports_without_yaml_cv2_matplotlib():
    """The system and the smoke need none of PyYAML, OpenCV or matplotlib
    (the card's machine is not sure to have them)."""
    code = (
        "import sys\n"
        "for m in ('yaml', 'cv2', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import chip_smoke\n"
        "import orb_slam2_refactored_tpu.drivers\n"
        "import orb_slam2_refactored_tpu.slam.system\n"
        "import orb_slam2_refactored_tpu.io.synthetic\n"
        "from orb_slam2_refactored_tpu.config import Settings\n"
        "Settings.from_yaml('configs/synthetic_rgbd_vga.yaml')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
