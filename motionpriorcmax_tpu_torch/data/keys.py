"""Batch-key vocabulary (JAX: data/keys.py)."""

from __future__ import annotations

import enum


class DataSetType(enum.Enum):
    DSEC = enum.auto()
    MULTIFLOW2D = enum.auto()
    EVIMO2 = enum.auto()


class BatchKeys(str, enum.Enum):
    """String-valued so batches remain plain dicts of arrays."""

    FLOW = "flow"
    FLOW_VALID = "flow_valid"
    FLOW_TIMESTAMPS = "flow_timestamps"
    EV_REPR = "ev_repr"
    BIN_META = "bin_meta"
    EVENTS = "events"
    POS_EVENTS = "pos_events"
    NEG_EVENTS = "neg_events"
    NUM_POS_EVENTS = "num_pos_events"
    ID_MASK = "id_mask"
    X_SCALE = "x_scale"
    Y_SCALE = "y_scale"
    IMG = "img"
    DATASET_TYPE = "dataset_type"
    VOXEL = "voxel"
    GT_FLOW = "gt_flow"
    TIMESTAMP = "timestamp"
    FILE_INDEX = "file_index"
    NAME = "name"
