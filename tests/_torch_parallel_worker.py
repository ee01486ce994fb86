"""One rank of a gloo world on the CPU for tests/test_torch_parallel.py.

    python tests/_torch_parallel_worker.py <world> <rank> <size> <port> <dir>

<world> names the cases this world runs:
  events  (4 ranks) the event-sharded focus loss, mesh (1, 4), on every
          case of <dir>/inputs.pt's 'events'; the sharded flow step at
          (2, 2); make_mesh refusing meshes that leave the world uncovered
  steps   (2 ranks) the sharded flow step at (2, 1) and (1, 2); the
          sharded RAFT-Spline steps (self-supervised and supervised) at
          (2, 1) and (1, 2); train_traj with a validation every step at
          (2, 1) and (1, 2), each rank with its own workdir;
          MetricBank.reduce_across_processes
  cli     (2 ranks) `flow-train --mesh 2,1` on <dir>/cfg.yaml, each rank
          with its own workdir <dir>/rank<r>, counting the validation
          samples each rank's metric bank holds before the reduction;
          `traj-train --mesh 2,1` on the EVIMO2 tree <dir>/evimo2 at
          TRAJ_HW (workdir <dir>/traj_rank<r>); then, the process group
          gone, rank 1 runs the same traj-train in one process, --mesh
          1,1 (<dir>/traj_single)

Inputs come from <dir>/inputs.pt (written by the test); each rank writes
its results to <dir>/out<r>.pt.  No JAX here: the test process holds the
JAX side.
"""

import os
import sys

import torch

TRAJ_HW = (64, 128)                # the cli world's traj-train geometry


def flow_state(inp):
    from motionpriorcmax_tpu_torch.training import trajectory_net as ttn

    state = ttn.create_train_state(ttn.TrajectoryNetConfig(**inp["flow_cfg"]),
                                   "cpu")
    state.model.unet.load_state_dict(inp["flow_init"])
    state.optimizer = torch.optim.SGD(state.model.parameters(),
                                      lr=inp["lr"])
    return state


def flow_cases(mesh, inp, tag, out):
    from motionpriorcmax_tpu_torch.losses import FocusLossConfig
    from motionpriorcmax_tpu_torch.parallel import replicate, shard_batch
    from motionpriorcmax_tpu_torch.training import trajectory_net as ttn
    from motionpriorcmax_tpu_torch.training.loop import to_device

    for name, case in inp["flow"].items():
        state = replicate(mesh, flow_state(inp))
        npos = case["batch"]["num_pos_events"]
        local = to_device(shard_batch(mesh, case["batch"], npos),
                          torch.device("cpu"))
        logs = ttn.train_step(state, local, None, state.model.cfg,
                              FocusLossConfig(**case["loss"]), npos,
                              times=case["times"], mesh=mesh)
        out[f"flow/{name}/{tag}"] = {
            "loss": float(logs["train_losses/total"]),
            "unet": {k: v.clone() for k, v in
                     state.model.unet.state_dict().items()}}


def event_cases(mesh, inp, out):
    from motionpriorcmax_tpu_torch.losses import FocusLossConfig
    from motionpriorcmax_tpu_torch.parallel import focus_loss_event_sharded

    for name, case in inp["events"].items():
        traj = case["traj"].clone().requires_grad_(True)
        loss, _, misc = focus_loss_event_sharded(
            FocusLossConfig(**case["loss"]), traj, case["times"],
            case["events"], mesh, num_pos_events=case["npos"],
            cell_ends=case["ends"])
        loss.backward()
        mesh.average_gradients([traj])
        out[f"events/{name}"] = {"loss": float(loss), "iwes": misc["iwes"],
                                 "grad": traj.grad}


def raft_state(inp):
    from motionpriorcmax_tpu_torch.models.raft_spline import RAFTSplineConfig
    from motionpriorcmax_tpu_torch.training import raft_spline as trs

    state = trs.create_raft_train_state(
        RAFTSplineConfig(**inp["raft_cfg"]),
        trs.RAFTTrainConfig(use_scheduler=False), "cpu")
    state.model.load_state_dict(inp["raft_init"], strict=True)
    state.optimizer = torch.optim.SGD(state.model.parameters(), lr=inp["lr"])
    return state


def raft_cases(mesh, inp, tag, out):
    from motionpriorcmax_tpu_torch.losses import FocusLossConfig
    from motionpriorcmax_tpu_torch.parallel import replicate, shard_batch
    from motionpriorcmax_tpu_torch.training import raft_spline as trs
    from motionpriorcmax_tpu_torch.training.loop import to_device

    for name, case in inp["raft"].items():
        state = replicate(mesh, raft_state(inp))
        npos = case.get("npos", -1)
        local = to_device(shard_batch(mesh, case["batch"], npos),
                          torch.device("cpu"))
        if name == "supervised":
            logs = trs.raft_supervised_train_step(state, local, mesh=mesh)
        else:
            logs = trs.raft_train_step(state, local, None,
                                       FocusLossConfig(**case["loss"]),
                                       npos, times=case["times"], mesh=mesh)
        out[f"raft/{name}/{tag}"] = {
            "loss": float(logs["train_losses/total"]),
            "state": {k: v.clone() for k, v in
                      state.model.state_dict().items()}}


def traj_loop_case(mesh, inp, tag, out_dir, out):
    """train_traj on the rank's data rows of inp['traj_loop']'s batches,
    validating every step on the rank's share of its samples; what it
    returns, each validation's metrics, the final weights and the files
    under the rank's workdir."""
    from motionpriorcmax_tpu_torch.cli.main import run_traj_validation
    from motionpriorcmax_tpu_torch.losses import FocusLossConfig
    from motionpriorcmax_tpu_torch.parallel import process_batch_slice
    from motionpriorcmax_tpu_torch.training.loop import train_traj

    case = inp["traj_loop"]
    loader = [{k: v[process_batch_slice(len(v), mesh)] for k, v in b.items()}
              for b in case["batches"]]
    vals = []

    def validate(model):
        vals.append(run_traj_validation(model, case["val"], 1, case["val_ts"],
                                        shard=(mesh.rank, mesh.world)))
        return vals[-1]

    workdir = os.path.join(out_dir, f"traj_{tag}", f"rank{mesh.rank}")
    res = train_traj(raft_state(inp), loader, workdir,
                     max_steps=len(loader),
                     loss_cfg=FocusLossConfig(**inp["raft"]["selfsup"]["loss"]),
                     log_every=1, val_every=1, validate=validate,
                     seed=case["seed"], mesh=mesh)
    out[f"traj_loop/{tag}"] = {
        "result": res, "val": vals,
        "written": sorted(os.path.relpath(os.path.join(d, f), workdir)
                          for d, _, files in os.walk(workdir)
                          for f in files)}


def traj_train_argv(out_dir, workdir):
    """traj-train on <out_dir>/evimo2, one step of the global batch of 2
    and a validation pass, cut to one iteration and Bezier degree 2."""
    return ["traj-train", "--device", "cpu",
            "--config-dir", "config/trajectory_inference",
            "--workdir", os.path.join(out_dir, workdir), "--max-steps", "1",
            "--log-every", "1", "--event-capacity", "4096",
            "--val-every", "1", "--val-batch-size", "1",
            "experiment=raft-spline_evimo2-300ms_ours-selfsup",
            "checkpoint=/unused",
            f"dataset.path={os.path.join(out_dir, 'evimo2')}",
            "training.batch_size=2", "model.num_iter.train=1",
            "model.num_iter.test=1", "model.bezier_degree=2",
            "loss.lut_superpixel_size=16", "loss.num_knn=4"]


def cli_world(rank, size, port, out_dir):
    """The cli world's runs; what each rank returns and, per run, the
    metric counts of the rank's validation shard, as its MetricBank holds
    them before reduce_across_processes sums them over the ranks."""
    from motionpriorcmax_tpu_torch.cli.main import main as cli
    from motionpriorcmax_tpu_torch.data.evimo2 import Evimo2Datasubset
    from motionpriorcmax_tpu_torch.metrics import MetricBank

    # The EVIMO2 reader's 384 x 512 cut to TRAJ_HW: the model and the
    # loss take the data's resolution, so both runs are cut alike.
    init = Evimo2Datasubset.__init__

    def small_init(self, *args, **kw):
        init(self, *args, **kw)
        self.resize_hw = TRAJ_HW

    Evimo2Datasubset.__init__ = small_init
    counts = []
    reduce = MetricBank.reduce_across_processes

    def counting(bank):
        counts.append({k: float(c) for k, (_, c) in bank.state.items()})
        return reduce(bank)

    MetricBank.reduce_across_processes = counting
    group = ["--coordinator", f"127.0.0.1:{port}", "--num-processes",
             str(size), "--process-id", str(rank)]
    out = {"rc": cli([
        "flow-train", "--config", os.path.join(out_dir, "cfg.yaml"),
        "--workdir", os.path.join(out_dir, f"rank{rank}"),
        "--event-capacity", "4096", "--log-every", "1", "--device",
        "cpu", "--mesh", "2,1", *group])}
    out["flow_val_counts"], counts[:] = list(counts), []
    # Each command ends its process group; the next one meets at another
    # port (rank 0 may still hold the first group's store when rank 1
    # starts it).
    traj_port = torch.load(os.path.join(out_dir, "inputs.pt"))["traj_port"]
    group[1] = f"127.0.0.1:{traj_port}"
    out["traj_rc"] = cli(traj_train_argv(out_dir, f"traj_rank{rank}")
                         + ["--mesh", "2,1", *group])
    out["traj_val_counts"] = list(counts)
    if rank == 1:
        out["traj_single_rc"] = cli(traj_train_argv(out_dir, "traj_single")
                                    + ["--mesh", "1,1"])
    return out


def main():
    world, rank, size, port, out_dir = sys.argv[1:6]
    rank, size = int(rank), int(size)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    torch.set_num_threads(1)
    torch.manual_seed(0)
    inp_path = os.path.join(out_dir, "inputs.pt")
    out = {}
    # TensorBoard's import (TensorFlow's) takes longer than the runs.
    sys.modules["torch.utils.tensorboard"] = None
    if world == "cli":
        out.update(cli_world(rank, size, port, out_dir))
        torch.save(out, os.path.join(out_dir, f"out{rank}.pt"))
        return

    from motionpriorcmax_tpu_torch.parallel import (initialize_distributed,
                                                    make_mesh)

    initialize_distributed(f"127.0.0.1:{port}", size, rank, device="cpu",
                           timeout_s=100)
    inp = torch.load(inp_path, weights_only=False)
    if world == "events":
        event_cases(make_mesh(1, 4), inp, out)
        flow_cases(make_mesh(2, 2), inp, "2x2", out)
        refused = []
        for shape in ((3, 1), (2, 1), (4, 2)):
            try:
                make_mesh(*shape)
            except ValueError:
                refused.append(shape)
        out["refused"] = refused
    elif world == "steps":
        from motionpriorcmax_tpu_torch.metrics import MetricBank

        for shape in ((2, 1), (1, 2)):
            mesh = make_mesh(*shape)
            tag = f"{shape[0]}x{shape[1]}"
            flow_cases(mesh, inp, tag, out)
            raft_cases(mesh, inp, tag, out)
            traj_loop_case(mesh, inp, tag, out_dir, out)
        bank = MetricBank()
        bank.update_device({"epe": torch.tensor(float(rank + 1))})
        if rank == 0:
            bank.update_device({"only_rank0": torch.tensor(4.0)})
        out["bank"] = bank.reduce_across_processes().compute()
    torch.save(out, os.path.join(out_dir, f"out{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
