"""Entry point of the port (JAX: motionpriorcmax_tpu/cli/).

  python -m motionpriorcmax_tpu_torch.cli flow-train --config ... \
      [--workdir ...] [--ckp_path ...] [--event-capacity N] \
      [--log-every N] [--device cuda|cpu]
  python -m motionpriorcmax_tpu_torch.cli traj-val --config-dir ... \
      [--device cuda|cpu] [overrides]
"""

from .main import main

__all__ = ["main"]
