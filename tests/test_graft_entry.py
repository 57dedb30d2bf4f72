"""The driver-facing entry points in __graft_entry__.py.

``dryrun_multichip`` must pass in the DRIVER's environment, where only
one real device may be visible: it has to self-provision the virtual
CPU mesh.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_direct_path():
    # conftest gives 8 virtual CPU devices -> direct (no-subprocess) path.
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as g
        g.dryrun_multichip(8)
    finally:
        sys.path.remove(REPO)


def test_dryrun_self_provisions_when_underprovisioned():
    # A child with ONE visible device must still succeed at n=2 by
    # re-execing itself with a 2-device virtual CPU mesh.
    env = os.environ.copy()
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    code = (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import __graft_entry__ as g\n"
        "assert len(jax.devices()) == 1\n"
        "g.dryrun_multichip(2)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "dryrun_multichip(2): OK" in r.stdout
