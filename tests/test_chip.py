"""On-card checks: the phases of chip_smoke.py as tests. They need the
GPU backend and skip elsewhere; run them on the card with

    JAX_PLATFORMS=cuda python -m pytest -m chip tests/test_chip.py
"""

import pathlib
import sys

import jax
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


@pytest.fixture
def smoke():
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU backend")
    import bench
    import chip_smoke
    return chip_smoke, bench


@pytest.mark.chip
def test_headline_on_card(smoke):
    chip_smoke, bench = smoke
    chip_smoke.phase_headline(bench)


@pytest.mark.chip
def test_rods2d_gap_on_card(smoke):
    chip_smoke, bench = smoke
    chip_smoke.phase_rods2d(bench)


@pytest.mark.chip
def test_f64_on_card(smoke, tmp_path):
    chip_smoke, _ = smoke
    chip_smoke.phase_f64(tmp_path)
