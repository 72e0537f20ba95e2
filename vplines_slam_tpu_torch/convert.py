"""Convert state between the JAX reference and the port.

``to_torch`` takes any of the reference's state NamedTuples (``WindowState``,
``TrackData`` with its ``Preintegration`` and ``Prior``, ``TrackerState``,
``LineTrackerState``, ``ImuParams``, ``CameraModel``, loop closure's
``KeyframeDB``, ``PoseGraphConfig`` and ``LoopResult``) or a plain tuple such
as the IMU batch ``(dts, accs, gyrs, mask, has_imu)``, with leaves given as
numpy arrays (or anything ``np.asarray`` accepts), and returns the port's
NamedTuple of the same name with tensors on ``device``.  Integer arrays
(ids, slots, counters) become int64, the index type torch wants, except the
database's uint32 descriptors (``desc``, ``wdesc``), which become int32 bit
for bit; floats keep their dtype unless ``dtype`` is given (frame stamps
become f64 and signatures stay f32 whatever ``dtype`` says).  A
``PoseGraphConfig`` holds Python numbers and crosses as it is.
``from_torch`` goes back: numpy leaves, int64 -> int32 and the descriptors
-> uint32, as the reference stores them.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .estimator.window import TrackData, WindowState
from .models.camera import CameraModel
from .models.feature_tracker import TrackerState
from .models.imu import ImuParams, Preintegration
from .models.line_tracker import LineTrackerState
from .models.pose_graph import KeyframeDB, LoopResult, PoseGraphConfig
from .solver.marginalization import Prior

PORT_TYPES = {cls.__name__: cls for cls in (
    WindowState, TrackData, Preintegration, Prior, TrackerState, LineTrackerState, ImuParams,
    CameraModel, KeyframeDB, LoopResult, PoseGraphConfig)}
# NamedTuples of Python numbers, crossing as they are
_CONFIG_TYPES = {"PoseGraphConfig"}
# NamedTuple fields that are static Python ints, not arrays
_STATIC_FIELDS = {"kind", "width", "height"}
# frame stamps, f64 in the port whatever the engine dtype
_STAMP_FIELDS = {"frame_t", "relo_stamp"}
# the keyframe database's uint32 descriptor words, int32 bit patterns here
_U32_FIELDS = {"desc", "wdesc"}
# float32 whatever dtype says
_F32_FIELDS = {"sig"}


def _leaf_to_torch(x, device, dtype):
    a = np.asarray(x)
    if a.dtype == np.bool_:
        t = torch.from_numpy(a.copy())
    elif np.issubdtype(a.dtype, np.integer):
        t = torch.from_numpy(a.astype(np.int64))
    else:
        t = torch.from_numpy(a.copy())
        if dtype is not None:
            t = t.to(dtype)
    return t.to(device)


def to_torch(obj, device=torch.device("cuda"), dtype=None):
    """Reference state (numpy leaves) -> the port's tensors."""
    if isinstance(obj, tuple):
        if hasattr(obj, "_fields"):
            name = type(obj).__name__
            if name not in PORT_TYPES:
                raise TypeError(f"no port counterpart for {name}")
            cls = PORT_TYPES[name]
            if tuple(cls._fields) != tuple(obj._fields):
                raise TypeError(f"{name}: fields differ from the port's")
            if name in _CONFIG_TYPES:
                return cls(*obj)
            kids = [int(np.asarray(v)) if f in _STATIC_FIELDS
                    else _u32_to_torch(v, device) if name == "KeyframeDB" and f in _U32_FIELDS
                    else to_torch(v, device, torch.float64 if f in _STAMP_FIELDS
                                  else torch.float32 if f in _F32_FIELDS else dtype)
                    for f, v in zip(obj._fields, obj)]
            return cls(*kids)
        return tuple(to_torch(v, device, dtype) for v in obj)
    return _leaf_to_torch(obj, device, dtype)


def _u32_to_torch(x, device):
    return torch.from_numpy(np.asarray(x).astype(np.uint32).view(np.int32).copy()).to(device)


def from_torch(obj):
    """The port's tensors -> numpy leaves in the reference's dtypes (int32
    ids/slots, uint32 descriptors), same NamedTuple types."""
    if isinstance(obj, tuple):
        if type(obj).__name__ in _CONFIG_TYPES:
            return obj
        db = type(obj).__name__ == "KeyframeDB"
        kids = [from_torch(v).astype(np.int32).view(np.uint32) if db and f in _U32_FIELDS
                else from_torch(v)
                for f, v in zip(getattr(obj, "_fields", [None] * len(obj)), obj)]
        return type(obj)(*kids) if hasattr(obj, "_fields") else tuple(kids)
    if isinstance(obj, torch.Tensor):
        a = obj.detach().cpu().numpy()
        return a.astype(np.int32) if a.dtype == np.int64 else a
    return obj
