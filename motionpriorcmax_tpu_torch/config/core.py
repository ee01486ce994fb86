"""YAML loading, common-section propagation and defaults-list composition
(JAX: config/core.py).

A copy of the JAX package's composer; `yaml` is imported only when a file is
read or an override parsed.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

MISSING = "???"


def load_yaml(path: Union[str, Path]) -> Dict[str, Any]:
    import yaml

    with open(path) as fh:
        return yaml.safe_load(fh) or {}


def propagate_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Copy common.* into the model / loss / data sections, in place:
    image_shape, num_bins, polarity_aware_batching and patch_size."""
    common = config["common"]
    image_shape = (common["height"], common["width"])
    config["model"]["image_shape"] = image_shape
    if "loss" in config:
        config["loss"]["image_shape"] = image_shape
    num_bins = common["num_bins"]
    config["model"]["num_bins"] = num_bins
    if "data" in config:
        config["data"]["num_bins"] = num_bins
    if "loss" in config and config["loss"].get("loss_name") == "FOCUS":
        config["loss"]["num_bins"] = num_bins
    if "polarity_aware_batching" in common:
        pab = common["polarity_aware_batching"]
        if "data" in config:
            config["data"]["polarity_aware_batching"] = pab
        if "loss" in config:
            config["loss"]["polarity_aware_batching"] = pab
    config["model"]["patch_size"] = common["patch_size"]
    return config


def deep_merge(base: Dict[str, Any], overlay: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive dict merge; overlay wins on conflicts."""
    out = dict(base)
    for key, val in overlay.items():
        if key in out and isinstance(out[key], dict) and isinstance(val, dict):
            out[key] = deep_merge(out[key], val)
        else:
            out[key] = val
    return out


def _parse_value(raw: str) -> Any:
    import yaml

    return yaml.safe_load(raw)


def apply_overrides(config: Dict[str, Any], overrides: List[str]
                    ) -> Dict[str, Any]:
    """Dotted CLI overrides 'a.b.c=value' (a leading '+' is accepted)."""
    config = copy.deepcopy(config)
    for ov in overrides:
        if ov.startswith("+"):
            ov = ov[1:]
        key, _, raw = ov.partition("=")
        if raw == "":
            raise ValueError(f"override {ov!r} needs key=value")
        node = config
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(raw)
    return config


def compose(config_dir: Union[str, Path], name: str,
            overrides: Optional[List[str]] = None) -> Dict[str, Any]:
    """Minimal Hydra-1.3-style composition.

      * a `defaults:` list of `group: option` entries loading
        `<config_dir>/<group>/<option>.yaml` into key `group` (after the
        group file's own defaults)
      * `_self_` ordering
      * `experiment=<name>` composing `<config_dir>/experiment/<name>.yaml`
        at the global package
      * `group=option` selections, dotted overrides and `???` required-field
        checking
    """
    config_dir = Path(config_dir)
    overrides = list(overrides or [])

    def load_group(group: str, option: str) -> Dict[str, Any]:
        node = load_yaml(config_dir / group / f"{option}.yaml")
        defaults = node.pop("defaults", [])
        base: Dict[str, Any] = {}
        for entry in defaults:
            if entry == "_self_":
                continue
            if isinstance(entry, str):
                base = deep_merge(base, load_group(group, entry))
            else:
                (g, o), = entry.items()
                base = deep_merge(base, load_group(g, o))
        return deep_merge(base, node)

    group_over: Dict[str, str] = {}
    dotted: List[str] = []
    experiment = None
    for ov in overrides:
        key, _, val = ov.partition("=")
        key = key.lstrip("+")
        if key == "experiment":
            experiment = val
        elif "." not in key and (config_dir / key).is_dir():
            group_over[key] = val
        else:
            dotted.append(ov)

    root = load_yaml(config_dir / f"{name}.yaml")
    defaults = root.pop("defaults", [])
    cfg: Dict[str, Any] = {}
    self_done = False
    for entry in defaults:
        if entry == "_self_":
            cfg = deep_merge(cfg, root)
            self_done = True
            continue
        (group, option), = entry.items()
        option = group_over.get(group, option)
        cfg = deep_merge(cfg, {group: load_group(group, option)})
    if not self_done:
        cfg = deep_merge(cfg, root)

    if experiment is not None:
        overlay = load_yaml(config_dir / "experiment" / f"{experiment}.yaml")
        cfg = deep_merge(cfg, overlay)

    cfg = apply_overrides(cfg, dotted)
    _check_missing(cfg, [])
    return cfg


def _check_missing(node: Any, path: List[str]) -> None:
    if isinstance(node, dict):
        for k, v in node.items():
            _check_missing(v, path + [str(k)])
    elif node == MISSING:
        raise ValueError(f"required config field not set: {'.'.join(path)}")
