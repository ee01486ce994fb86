"""Weights across frameworks and the port's own checkpoints
(JAX: training/checkpoint.py).

UNet (the flow model): `flax_unet_to_torch` turns JAX UNet variables into
the port's state_dict, the inverse of JAX `torch_unet_to_flax`;
`save_checkpoint` / `restore_checkpoint` keep the port's training state in
torch.save format with best-k retention on a monitored metric (orbax
checkpoints of the JAX package are not read).  `load_flow_model_weights`
fills a TrajectoryModel from any of the four sources that dsec-infer
takes (a reference .pth / .ckpt, an .npz in the JAX package's
'params/...' layout or in the torch-key layout, a flow-train checkpoint
directory); `flow_model_torch_keys` gives the torch-key layout that
extract-weights writes.

RAFT-Spline (JAX: training/checkpoint.py:134-295):

The port's modules carry the canonical RAFT / E-RAFT state-dict names
(conv1/norm1/layer{1-3}/conv2 encoders; encoder.convc*/gru.conv*/flow_head/
mask update block) under the top-level names fnet_ev / fnet_img / cnet /
update_block.  `raft_spline_torch_key` maps a flax parameter path onto that
name; `flax_raft_spline_to_torch` turns JAX variables into the port's
state_dict; `load_raft_spline_weights` loads a reference Lightning
checkpoint.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_ENC_LAYER = {f"layer{l}.{j}": f"ResidualBlock_{2 * (l - 1) + j}"
              for l in (1, 2, 3) for j in (0, 1)}
_ENC_CONV = {"conv1": "Conv_0", "conv2": "Conv_1"}
_BLOCK_CONV = {"conv1": "Conv_0", "conv2": "Conv_1", "downsample.0": "Conv_2"}
_BLOCK_NORM = {"norm1": "BatchNorm_0", "norm2": "BatchNorm_1",
               "norm3": "BatchNorm_2"}
_UPD_CONV = {
    "encoder.convc1": ("BasicMotionEncoder_0", "Conv_0"),
    "encoder.convc2": ("BasicMotionEncoder_0", "Conv_1"),
    "encoder.convf1": ("BasicMotionEncoder_0", "Conv_2"),
    "encoder.convf2": ("BasicMotionEncoder_0", "Conv_3"),
    "encoder.conv": ("BasicMotionEncoder_0", "Conv_4"),
    "gru.convz1": ("SepConvGRU_0", "Conv_0"),
    "gru.convr1": ("SepConvGRU_0", "Conv_1"),
    "gru.convq1": ("SepConvGRU_0", "Conv_2"),
    "gru.convz2": ("SepConvGRU_0", "Conv_3"),
    "gru.convr2": ("SepConvGRU_0", "Conv_4"),
    "gru.convq2": ("SepConvGRU_0", "Conv_5"),
    "flow_head.conv1": ("DeltaHead_0", "Conv_0"),
    "flow_head.conv2": ("DeltaHead_0", "Conv_1"),
    "mask.0": ("Conv_0",),
    "mask.2": ("Conv_1",),
}
_SUFFIX = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var"}


def raft_spline_torch_key(path: Tuple[str, ...], leaf: str) -> Optional[str]:
    """flax param path -> torch state-dict key (None = no torch analog, e.g.
    the non-affine instance norms)."""
    top = path[0]
    suffix = _SUFFIX[leaf]
    if top == "basis_mlp":
        # LEARNED curves: BasisMLP's Dense_i -> basis_mlp.layers.i
        return f"basis_mlp.layers.{int(path[1].split('_')[1])}.{suffix}"
    if top not in ("fnet_ev", "fnet_img", "cnet", "update_block"):
        return None
    if top == "update_block":
        for torch_mid, flax_mid in _UPD_CONV.items():
            if tuple(path[1:]) == flax_mid:
                return f"update_block.{torch_mid}.{suffix}"
        return None
    rest = path[1:]
    if len(rest) == 1:
        name = rest[0]
        for torch_name, flax_name in _ENC_CONV.items():
            if name == flax_name:
                return f"{top}.{torch_name}.{suffix}"
        if name == "BatchNorm_0":
            return f"{top}.norm1.{suffix}"
        return None
    block, name = rest[0], rest[1]
    for torch_blk, flax_blk in _ENC_LAYER.items():
        if block == flax_blk:
            for table in (_BLOCK_CONV, _BLOCK_NORM):
                for torch_name, flax_name in table.items():
                    if name == flax_name:
                        return f"{top}.{torch_blk}.{torch_name}.{suffix}"
    return None


def _torch_key_aliases(torch_key: str) -> Tuple[str, ...]:
    """The third residual-block norm is registered both as `norm3` and as
    `downsample.1`, so a checkpoint carries it under either or both names."""
    if ".norm3." in torch_key:
        return (torch_key, torch_key.replace(".norm3.", ".downsample.1."))
    return (torch_key,)


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


def flax_raft_spline_to_torch(variables: Mapping[str, Any]
                              ) -> "OrderedDict[str, torch.Tensor]":
    """JAX RAFTSpline variables ({'params', 'batch_stats'} of arrays) -> the
    port's state_dict, for `RAFTSpline.load_state_dict(strict=True)`.

    Conv kernels go HWIO -> OIHW, Dense kernels [in, out] -> [out, in];
    `norm3` is written under both of its names; instance norms (no
    parameters) are skipped; every batch norm gets a `num_batches_tracked`
    of 0 (flax keeps no such counter).
    """
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for coll in ("params", "batch_stats"):
        for path, val in _flatten(variables.get(coll) or {}):
            key = raft_spline_torch_key(path[:-1], path[-1])
            if key is None:
                continue
            arr = np.array(val, dtype=np.float32)
            if path[-1] == "kernel":
                arr = (np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4
                       else arr.T)
            for k in _torch_key_aliases(key):
                sd[k] = torch.from_numpy(np.ascontiguousarray(arr))
                if k.endswith(".running_mean"):
                    sd[k[:-len("running_mean")] + "num_batches_tracked"] = (
                        torch.zeros((), dtype=torch.long))
    return sd


def extract_model_weights(ckpt_path: str, prefix: str = "model."
                          ) -> Dict[str, torch.Tensor]:
    """Lightning .ckpt / .pth -> {key without prefix: tensor}; a bare
    state_dict (no 'state_dict' wrapper) works too."""
    blob = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    state_dict = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {(k[len(prefix):] if k.startswith(prefix) else k): v.detach()
            for k, v in state_dict.items()}


def load_raft_spline_weights(model: torch.nn.Module,
                             state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load a canonical RAFT-named state_dict into `model`, strictly.

    Fills the second name of each `norm3` / `downsample.1` pair from the
    first, and a missing `num_batches_tracked` with 0; any other missing or
    unexpected key raises (load_state_dict strict=True).
    """
    sd = dict(state_dict)
    for key in model.state_dict():
        if key in sd:
            continue
        for alt in (key.replace(".downsample.1.", ".norm3."),
                    key.replace(".norm3.", ".downsample.1.")):
            if alt != key and alt in sd:
                sd[key] = sd[alt]
                break
        else:
            if key.endswith("num_batches_tracked"):
                sd[key] = torch.zeros((), dtype=torch.long)
    model.load_state_dict(sd, strict=True)


# -- UNet -------------------------------------------------------------------

def _double_conv_keys(src: str, dst: str):
    """(torch key, flax path) pairs of one DoubleConv."""
    for j, idx in enumerate((0, 3)):
        yield f"{src}.{idx}.weight", ("params", f"{dst}/Conv_{j}", "kernel")
    for j, idx in enumerate((1, 4)):
        bn = f"{dst}/BatchNorm_{j}"
        yield f"{src}.{idx}.weight", ("params", bn, "scale")
        yield f"{src}.{idx}.bias", ("params", bn, "bias")
        yield f"{src}.{idx}.running_mean", ("batch_stats", bn, "mean")
        yield f"{src}.{idx}.running_var", ("batch_stats", bn, "var")


def unet_key_map():
    """(torch state-dict key, (collection, module path, leaf)) of every UNet
    tensor; '/' joins the nested flax module names."""
    yield from _double_conv_keys("inc.double_conv", "DoubleConv_0")
    for i in range(1, 5):
        yield from _double_conv_keys(f"down{i}.maxpool_conv.1.double_conv",
                                     f"Down_{i - 1}/DoubleConv_0")
    for i in range(1, 5):
        yield f"up{i}.up.weight", ("params", f"Up_{i - 1}/ConvTranspose_0",
                                   "kernel")
        yield f"up{i}.up.bias", ("params", f"Up_{i - 1}/ConvTranspose_0",
                                 "bias")
        yield from _double_conv_keys(f"up{i}.conv.double_conv",
                                     f"Up_{i - 1}/DoubleConv_0")
    yield "outc.conv.weight", ("params", "Conv_0", "kernel")
    yield "outc.conv.bias", ("params", "Conv_0", "bias")


def flax_unet_to_torch(params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any]
                       ) -> "OrderedDict[str, torch.Tensor]":
    """JAX UNet (params, batch_stats) trees of arrays -> the port's UNet
    state_dict, for `UNet.load_state_dict(strict=True)`.

    Conv kernels go HWIO -> OIHW.  Transposed-conv kernels [kh, kw, in,
    out] go to torch's [in, out, kh, kw] with the taps flipped back (JAX
    `_tconv` flips them: torch's transposed conv is the conv gradient).
    Every batch norm gets a `num_batches_tracked` of 0.
    """
    trees = {"params": params, "batch_stats": batch_stats}
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for key, (coll, module, leaf) in unet_key_map():
        node = trees[coll]
        for part in module.split("/"):
            node = node[part]
        arr = np.array(node[leaf], dtype=np.float32)
        if key.endswith(".up.weight"):
            arr = np.transpose(arr[::-1, ::-1], (2, 3, 0, 1))
        elif leaf == "kernel":
            arr = np.transpose(arr, (3, 2, 0, 1))
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
        if key.endswith(".running_var"):
            sd[key[:-len("running_var")] + "num_batches_tracked"] = (
                torch.zeros((), dtype=torch.long))
    return sd


def unflatten_model_weights(flat: Mapping[str, np.ndarray]
                            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """{'params/a/b': array, 'batch_stats/...': array} (JAX
    `flatten_model_weights`, as its extract-weights writes them) ->
    (params, batch_stats) nested dicts."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = {"params": params, "batch_stats": stats}[parts[0]]
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return params, stats


def flax_basis_mlp_to_torch(params: Mapping[str, Any]
                            ) -> "OrderedDict[str, torch.Tensor]":
    """JAX BasisMLP params (Dense_i kernel [in, out], bias) -> the port's
    BasisMLP state_dict (layers.i.weight [out, in], bias)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for i in range(len(params)):
        dense = params[f"Dense_{i}"]
        sd[f"layers.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.array(dense["kernel"], np.float32).T))
        sd[f"layers.{i}.bias"] = torch.from_numpy(
            np.array(dense["bias"], np.float32))
    return sd


_MLP = "basis_mlp."


def flow_model_torch_keys(model_state: Mapping[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """A TrajectoryModel state_dict in the torch-key layout: the UNet under
    the reference's names ('unet.' dropped, as the reference Lightning
    checkpoint has them after 'model.' is stripped), the learned basis MLP
    under 'basis_mlp.'."""
    return {(k[len("unet."):] if k.startswith("unet.") else k): v
            for k, v in model_state.items()}


def _load_torch_keys(model: torch.nn.Module,
                     state: Mapping[str, torch.Tensor]) -> None:
    """Load the torch-key layout into a TrajectoryModel strictly; a missing
    BatchNorm `num_batches_tracked` counts as 0 (flax keeps none)."""
    unet = {k: v for k, v in state.items() if not k.startswith(_MLP)}
    mlp = {k[len(_MLP):]: v for k, v in state.items() if k.startswith(_MLP)}
    for key in model.unet.state_dict():
        if key.endswith("num_batches_tracked") and key not in unet:
            unet[key] = torch.zeros((), dtype=torch.long)
    model.unet.load_state_dict(unet, strict=True)
    if model.basis_mlp is not None:
        model.basis_mlp.load_state_dict(mlp, strict=True)
    elif mlp:
        raise ValueError("the weights carry a learned basis MLP; the "
                         "config's basis_type is not 'learned'")


def load_flow_model_weights(model: torch.nn.Module, ckpt_path: str,
                            step: Optional[int] = None) -> str:
    """Fill a TrajectoryModel (UNet and, for the learned basis, its MLP)
    from `ckpt_path`, strictly; returns what was loaded.

      *.pth / *.ckpt: a reference checkpoint, 'model.' stripped
        (`extract_model_weights`): the UNet under the reference's names;
      *.npz, every key under 'params/' or 'batch_stats/': JAX-trained
        weights (JAX `flatten_model_weights`, its extract-weights), through
        `unflatten_model_weights` and `flax_unet_to_torch`;
      *.npz otherwise: the torch-key layout (`flow_model_torch_keys`, this
        package's extract-weights, or a Lightning checkpoint's);
      a directory: a checkpoint of this package's flow-train, the workdir
        or its checkpoints/: `step`, else the best-metric one, else the
        latest.

    Raises ValueError for any other path, and FileNotFoundError for a
    directory without a checkpoint.
    """
    path = str(ckpt_path)
    if path.endswith((".pth", ".ckpt")):
        _load_torch_keys(model, extract_model_weights(path))
        return f"reference weights {path}"
    if path.endswith(".npz"):
        with np.load(path) as npz:
            flat = {k: npz[k] for k in npz.files}
        if all(k.split("/")[0] in ("params", "batch_stats") for k in flat):
            params, stats = unflatten_model_weights(flat)
            state = dict(flax_unet_to_torch(params["unet"], stats["unet"]))
            for k, v in flax_basis_mlp_to_torch(
                    params.get("basis_mlp", {})).items():
                state[_MLP + k] = v
            _load_torch_keys(model, state)
            return f"JAX weights {path}"
        _load_torch_keys(model, {k: torch.from_numpy(v)
                                 for k, v in flat.items()})
        return f"torch-key weights {path}"
    if Path(path).is_dir():
        ckpt_dir = find_checkpoint_dir(path)
        if ckpt_dir is None:
            raise FileNotFoundError(
                f"{path!r}: no index.json and step_*.pt of flow-train here "
                "or in its checkpoints/ (orbax checkpoints of the JAX "
                "package are not read: use its extract-weights)")
        step = restore_model_weights(str(ckpt_dir), model, step, best=True)
        return f"checkpoint {ckpt_dir} @ step {step}"
    raise ValueError(f"{path!r} is not a .pth/.ckpt, .npz, or a flow-train "
                     "checkpoint directory")


# -- the port's checkpoints ----------------------------------------------------

_INDEX = "index.json"


def save_checkpoint(ckpt_dir: str, state, step: int, keep: int = 5,
                    metric: Optional[float] = None, mesh=None
                    ) -> Optional[Path]:
    """Write `state` (model, optimizer, the learning-rate schedule when the
    state has one, step) to <ckpt_dir>/step_<step>.pt.

    With `metric`, retention keeps the `keep` checkpoints of lowest metric
    (the reference's ModelCheckpoint(save_top_k=5) on val_losses/EPE, or
    val/masked_TEPE for traj-train); without, the `keep` latest.  The index
    of retained steps and their metrics is <ckpt_dir>/index.json.

    With a mesh (parallel.Mesh; the state is the same on every rank) only
    rank 0 writes, and every rank returns after it has (a barrier); the
    other ranks return None.
    """
    if mesh is not None:
        out = (save_checkpoint(ckpt_dir, state, step, keep, metric)
               if mesh.is_main else None)
        mesh.barrier()
        return out
    path = Path(ckpt_dir)
    path.mkdir(parents=True, exist_ok=True)
    index_path = path / _INDEX
    index = (json.loads(index_path.read_text()) if index_path.is_file()
             else [])
    out = path / f"step_{step}.pt"
    blob = {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": step, "metric": metric}
    scheduler = getattr(state, "scheduler", None)
    if scheduler is not None:
        blob["scheduler"] = scheduler.state_dict()
    torch.save(blob, out)
    index = [e for e in index if e["step"] != step]
    index.append({"step": step, "metric": metric, "file": out.name})
    if metric is not None:      # best first; unscored and ties: latest first
        index.sort(key=lambda e: (e["metric"] is None, e["metric"] or 0.0,
                                  -e["step"]))
    else:
        index.sort(key=lambda e: -e["step"])
    for e in index[keep:]:
        (path / e["file"]).unlink(missing_ok=True)
    index_path.write_text(json.dumps(index[:keep], indent=1))
    return out


def _pick_step(path: Path, step: Optional[int], best: bool) -> int:
    """The step to restore from <path>/index.json: `step` itself, else the
    best-metric one with `best`, else the latest retained."""
    index_path = path / _INDEX
    if not index_path.is_file():
        raise FileNotFoundError(f"no checkpoint index under {path}")
    index = json.loads(index_path.read_text())
    if step is not None:
        return step
    if not index:
        raise FileNotFoundError(f"no checkpoints under {path}")
    scored = [e for e in index if e["metric"] is not None]
    if best and scored:
        return min(scored, key=lambda e: e["metric"])["step"]
    return max(e["step"] for e in index)


def find_checkpoint_dir(path: str) -> Optional[Path]:
    """The directory of `save_checkpoint` at `path` or at its
    `checkpoints/` (a workdir of flow-train or traj-train); None when
    neither holds an index and a step_*.pt."""
    for cand in (Path(path), Path(path) / "checkpoints"):
        if (cand / _INDEX).is_file() and any(cand.glob("step_*.pt")):
            return cand
    return None


def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None,
                       best: bool = False) -> Tuple[Any, int]:
    """Load a checkpoint of `save_checkpoint` into `state` in place.

    `step` picks one; else the best-metric one with `best`, else the
    latest.  Returns (state, step)."""
    path = Path(ckpt_dir)
    step = _pick_step(path, step, best)
    device = next(state.model.parameters()).device
    blob = torch.load(path / f"step_{step}.pt", map_location=device,
                      weights_only=True)
    state.model.load_state_dict(blob["model"])
    state.optimizer.load_state_dict(blob["optimizer"])
    if "scheduler" in blob:
        state.scheduler.load_state_dict(blob["scheduler"])
    state.step = int(blob["step"])
    return state, step


def checkpoint_model_state(ckpt_dir: str, step: Optional[int] = None,
                           best: bool = False, map_location="cpu"
                           ) -> Tuple[Dict[str, torch.Tensor], int]:
    """The model state_dict of a `save_checkpoint` checkpoint and its step:
    the latest step unless `step` or `best` says otherwise, as
    `restore_checkpoint`."""
    path = Path(ckpt_dir)
    step = _pick_step(path, step, best)
    blob = torch.load(path / f"step_{step}.pt", map_location=map_location,
                      weights_only=True)
    return blob["model"], step


def restore_model_weights(ckpt_dir: str, model: torch.nn.Module,
                          step: Optional[int] = None, best: bool = False
                          ) -> int:
    """Load only the model of a `save_checkpoint` checkpoint, strictly (the
    step as `checkpoint_model_state` picks it).  Returns the step."""
    state, step = checkpoint_model_state(
        ckpt_dir, step, best, map_location=next(model.parameters()).device)
    model.load_state_dict(state, strict=True)
    return step
