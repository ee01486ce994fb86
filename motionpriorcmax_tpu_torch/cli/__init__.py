"""Entry point of the port (JAX: motionpriorcmax_tpu/cli/).

  python -m motionpriorcmax_tpu_torch.cli flow-train --config ... \
      [--workdir ...] [--ckp_path ...] [--event-capacity N] \
      [--event-capacity-buckets N1,N2,...] [--log-every N] \
      [--device-voxelize] [--device cuda|cpu]
  python -m motionpriorcmax_tpu_torch.cli dsec-infer --config ... \
      [--timestamp-dir ...] [--ckpt-step N] [--device cuda|cpu]
  python -m motionpriorcmax_tpu_torch.cli extract-weights CKPT OUT.npz
  python -m motionpriorcmax_tpu_torch.cli traj-val --config-dir ... \
      [--device cuda|cpu] [overrides]
  python -m motionpriorcmax_tpu_torch.cli traj-train --config-dir ... \
      [--workdir ...] [--max-steps N] [--loss selfsup|supervised] \
      [--val-every N] [--device cuda|cpu] [overrides]
"""

from .main import main

__all__ = ["main"]
