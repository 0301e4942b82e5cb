"""``chip_smoke.py``'s contract, checked on the CPU: it refuses a device
that is not a GPU, prints no result then, and its last line carries
exactly the keys the contract names. Its float64 top-k comparison
accepts only ties at the k-th place."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_device_gate_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.device_gate(jax.devices("cpu"))
    assert e.value.code not in (0, None)


def test_result_line_has_exactly_the_contract_keys():
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = json.loads(chip_smoke.result_line([dev]))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_main_on_cpu_fails_without_result(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails_without_result(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repository, the script exits non-zero and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("got,ok", [
    (["a", "b", "c"], True),          # the reference order
    (["a", "b", "t"], True),          # "t" ties "c" at the k-th place
    (["a", "b", "d"], False),         # "d" is farther than the k-th
    (["a", "b", "x"], False),         # not a candidate at all
])
def test_check_topk_accepts_only_kth_ties(got, ok):
    ids = ["a", "b", "c", "t", "d"]
    keys = np.array([1.0, 2.0, 3.0, 3.0 + 1e-7, 4.0])
    key_of = dict(zip(ids, keys))
    dists = [key_of.get(g, 3.0) for g in got]
    if ok:
        chip_smoke.check_topk("t", got, dists, ids, keys, 3, atol=0.0)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_topk("t", got, dists, ids, keys, 3, atol=0.0)
