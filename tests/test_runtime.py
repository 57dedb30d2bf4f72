"""Process set-up shared by the entry points (utils/runtime.py), the
device description in bench.py's JSON line, the CLI's f64 path, and
chip_smoke.py's refusal to run without a GPU."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from bravais_tpu.utils import runtime

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import bench  # noqa: E402


@pytest.fixture
def cache_config(monkeypatch):
    """Record compile-cache config updates without applying them."""
    calls = {}
    real = jax.config.update

    def update(name, value):
        if name.startswith("jax_") and "cache" in name:
            calls[name] = value
        else:
            real(name, value)

    monkeypatch.setattr(jax.config, "update", update)
    return calls


def test_compile_cache_env_set(cache_config, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.setup_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in cache_config


def test_compile_cache_env_unset(cache_config, monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)            # independent of the cwd
    path = runtime.setup_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert cache_config["jax_compilation_cache_dir"] == path


@pytest.mark.parametrize("kind,peak", [("NVIDIA H100 80GB HBM3", 67.0),
                                       ("NVIDIA H100 PCIe", 51.0)])
def test_peak_known_kind(kind, peak):
    got, note = runtime.peak_f32_tflops(kind)
    assert got == peak and kind in note


def test_peak_unknown_kind():
    got, note = runtime.peak_f32_tflops("Imaginary Accelerator 9")
    assert got is None and "Imaginary Accelerator 9" in note


def test_device_info_names_the_platform():
    info = runtime.device_info()
    assert info["platform"] == "cpu"
    assert info["device_count"] == len(jax.devices())
    assert set(info) == {"platform", "device_kind", "device_count",
                         "nvidia_smi"}


def test_bench_line_names_the_device(capsys):
    bench.main(["--cpu", "--problem", "scalar", "--n", "3", "--p", "2",
                "--nk", "4", "--nev", "4", "--repeats", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    d = line["detail"]
    assert d["platform"] == "cpu" and d["device_kind"] == "cpu"
    assert d["pct_of_f32_peak"] is None and "cpu" in d["peak_note"]
    assert d["hbm_peak_source"] == "memory_analysis(program)"
    assert not any("bf16" in key for key in d)


def test_bench_eig_errors_empty_lattice():
    """make_cell + eig_errors: the analytic oracle of the headline cell
    at a toy size (Γ is nudged; the lowest FCC band pair is |k|²)."""
    cell = bench.make_cell(bench.parse_args(["--n", "3", "--p", "2",
                                             "--nk", "4"]))
    assert np.linalg.norm(cell.kc[0]) > 0          # nudged Γ
    ex = np.stack([bench.exact_bands(cell.lat, k, 4, cell.mmax, cell.mult)
                   for k in cell.kc])
    np.testing.assert_allclose(ex[:, 0], np.sum(cell.kc ** 2, axis=1))
    assert max(bench.eig_errors(cell, ex)) == 0.0


def test_cli_f64_stays_on_the_present_backend(monkeypatch, tmp_path):
    """--precision f64 turns x64 on and never re-pins the platform."""
    from bravais_tpu.cli.bands_app import main
    seen = []
    real = jax.config.update
    monkeypatch.setattr(jax.config, "update",
                        lambda n, v: (seen.append(n), real(n, v)))
    main(["--lattice", "SQR", "--problem", "tm", "--eps-in", "4",
          "--radius", "0.3", "--n", "3", "--p", "1", "--nk", "4",
          "--nev", "2", "--precision", "f64", "--out", str(tmp_path)])
    assert "jax_platforms" not in seen
    assert "jax_enable_x64" in seen
    ev = np.load(tmp_path / "bands.npz")["eigenvalues"]
    assert np.all(np.isfinite(ev)) and ev.shape == (4, 2)


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_the_cpu():
    r = _run_smoke(REPO, REPO / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "not 'gpu'" in r.stdout + r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the
    repo, the script fails without a result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
