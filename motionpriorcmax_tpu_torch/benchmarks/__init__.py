"""Benchmark harnesses of the port (JAX: benchmarks/): component
microbenchmarks (`components`), RAFT-Spline steps (`raft`), the sharded
flow step over worlds of 1, 2, 4, ... processes (`scaling`) and the
multi-process training path's parity at N processes (`scaling_hosts`).

Each runs on the card unless given `--device cpu`, exits with a message
when the card is absent, and prints as its first line a JSON object naming
the device (on a card, with `nvidia-smi`'s name and power limit).
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Sequence

import torch

# The directory that holds the package: the ranks of a world import it.
_ROOT = str(Path(__file__).resolve().parents[2])


def bench_device(device: str, prog: str) -> torch.device:
    """The device of `--device` (cuda or cpu); exits with a message when
    CUDA is asked for and absent (no fallback to the CPU)."""
    from ..device import resolve_device

    try:
        return resolve_device(device)
    except (RuntimeError, ValueError) as exc:
        raise SystemExit(f"{prog}: {exc}") from None


def nvidia_smi(index: int = 0) -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of card `index`, as it
    prints it ('NVIDIA H100 80GB HBM3, 700.00 W')."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return out.strip()


def device_line(dev: torch.device) -> str:
    """The first line of a benchmark's output: the device and, on a card,
    its name and nvidia-smi's name and power limit."""
    rec = {"device": str(dev)}
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        rec["kind"] = torch.cuda.get_device_name(index)
        rec["nvidia_smi"] = nvidia_smi(index)
    return json.dumps(rec)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(module: str, world: int, args: Sequence[str],
              timeout_s: float) -> List[str]:
    """Start `world` processes of `python -m module --rank R --world N
    --port P *args` on this host and wait for them; returns each rank's
    output.  Exits with every rank's output when one fails or the world
    outlasts `timeout_s`; no rank outlives the call."""
    port = str(free_port())
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    # Every rank is on this host: NCCL bootstraps over the loopback.
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with contextlib.ExitStack() as stack:
        # Files, not pipes: a rank blocked on a full pipe would hold the
        # others in a collective.
        logs = [stack.enter_context(tempfile.TemporaryFile("w+"))
                for _ in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", module, "--rank", str(r), "--world",
             str(world), "--port", port, *args], stdout=logs[r],
            stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(world)]
        deadline = time.monotonic() + timeout_s
        note = ""
        try:
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            note = f"(the world outlasted {timeout_s:.0f} s)\n"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
    if note or any(p.returncode for p in procs):
        raise SystemExit(f"{module}: a world of {world} failed\n{note}"
                         + "\n".join(
                             f"--- rank {r} (rc {p.returncode}) ---\n"
                             f"{o[-4000:]}"
                             for r, (p, o) in enumerate(zip(procs, outs))))
    return outs


def world_backend(device: str, world: int) -> str:
    """NCCL with a card per rank, gloo when the ranks share a card (NCCL
    refuses that) or run on the CPU."""
    if device == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"
