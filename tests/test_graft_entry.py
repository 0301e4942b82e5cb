"""The driver's entry points must work no matter how they are invoked.

The dry run is called directly in a fresh process where no JAX platform
and no host-device-count flag is set. The function itself must force a
CPU mesh before any JAX backend initialization.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def test_dryrun_multichip_inprocess():
    # Direct call with jax already initialized on the 8-device CPU mesh
    # (conftest.py): should take the in-process path.
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_dryrun_multichip_driverlike_env():
    # A fresh process with JAX_PLATFORMS unset and no
    # xla_force_host_platform_device_count: the dry run must still pin
    # itself to a CPU mesh and pass.
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    parts = [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p and p != REPO]
    env["PYTHONPATH"] = os.pathsep.join(parts)
    r = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8); print('OK')"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, f"rc={r.returncode}\n{r.stdout}\n{r.stderr}"
    assert "OK" in r.stdout


def test_dryrun_multichip_subprocess_fallback():
    # Asking for more devices than this (already-initialized) process has
    # must route through the clean-subprocess fallback and still pass.
    import __graft_entry__ as g

    g.dryrun_multichip(16)
