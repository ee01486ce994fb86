"""The port stands alone: every module of motionpriorcmax_tpu_torch, with
each card tool (chip_smoke.py, card_cases.py, kernel_ab.py), imports in a
process where neither JAX nor the JAX package can be imported, as on the
GPU machine, and pulls in nothing of perfbench/; card_cases.py's inline
copy of config/dsec_inference.yaml equals the file."""

import subprocess
import sys

import pytest
import yaml

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax",
             "motionpriorcmax_tpu"):
    sys.modules[name] = None          # any import of them raises
import motionpriorcmax_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith(".__main__")]     # runs the CLI
for name in names:
    importlib.import_module(name)
importlib.import_module(sys.argv[1])
leaked = sorted(n for n, m in sys.modules.items() if m is not None and (
    n.split(".")[0] in ("jax", "jaxlib", "flax", "motionpriorcmax_tpu",
                        "perfbench")))
assert not leaked, leaked
print(len(names))
"""


@pytest.mark.parametrize("tool", ["chip_smoke", "card_cases", "kernel_ab"])
def test_port_and_chip_smoke_import_without_jax(tool):
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL, tool],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 40


def test_chip_smoke_carries_dsec_inference_yaml():
    import card_cases

    with open("config/dsec_inference.yaml") as fh:
        assert card_cases.DSEC_INFERENCE_CONFIG == yaml.safe_load(fh)
