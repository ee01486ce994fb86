"""The import guard: names compared whole, the port allowed, JAX and the
JAX package refused; and no result without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.run import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("modules, found", [
    (["torch", "numpy", "motionpriorcmax_tpu_torch.ops.cuda"], []),
    (["jax"], ["jax"]),
    (["jax._src.core", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen", "optax"], ["flax", "optax"]),
    (["motionpriorcmax_tpu.ops.events", "motionpriorcmax_tpu_torch"],
     ["motionpriorcmax_tpu"]),
    (["jaxtyping", "flaxen", "motionpriorcmax_tpu_torchvision"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(modules, found):
    assert forbidden_modules(modules) == found


def test_a_run_of_the_benchmark_loads_no_jax():
    # Import everything a run imports, in a fresh process, then look.
    code = ("import perfbench.run, perfbench.harness, perfbench.control;"
            "import perfbench.generators.flow_train,"
            " perfbench.generators.traj_train,"
            " perfbench.generators.traj_eval;"
            "import motionpriorcmax_tpu_torch.training.trajectory_net,"
            " motionpriorcmax_tpu_torch.training.raft_spline,"
            " motionpriorcmax_tpu_torch.training.loop,"
            " motionpriorcmax_tpu_torch.cli.main;"
            "from perfbench.run import forbidden_modules;"
            "import json; print(json.dumps(forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs none")
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "dsec-unet.train-softmax", "--seed", "3000000001", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr
