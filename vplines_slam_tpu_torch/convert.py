"""Convert state between the JAX reference and the port.

``to_torch`` takes any of the reference's state NamedTuples (``WindowState``,
``TrackData`` with its ``Preintegration`` and ``Prior``, ``TrackerState``,
``LineTrackerState``, ``ImuParams``, ``CameraModel``) or a plain tuple such as the IMU batch
``(dts, accs, gyrs, mask, has_imu)``, with leaves given as numpy arrays (or
anything ``np.asarray`` accepts), and returns the port's NamedTuple of the
same name with tensors on ``device``.  Integer arrays (ids, slots, counters)
become int64, the index type torch wants; floats keep their dtype unless
``dtype`` is given.  ``from_torch`` goes back: numpy leaves, int64 -> int32
as the reference stores them.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .estimator.window import TrackData, WindowState
from .models.camera import CameraModel
from .models.feature_tracker import TrackerState
from .models.imu import ImuParams, Preintegration
from .models.line_tracker import LineTrackerState
from .solver.marginalization import Prior

PORT_TYPES = {cls.__name__: cls for cls in (
    WindowState, TrackData, Preintegration, Prior, TrackerState, LineTrackerState, ImuParams,
    CameraModel)}
# NamedTuple fields that are static Python ints, not arrays
_STATIC_FIELDS = {"kind", "width", "height"}


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
            kids = [int(np.asarray(v)) if f in _STATIC_FIELDS
                    else to_torch(v, device, dtype)
                    for f, v in zip(obj._fields, obj)]
            return cls(*kids)
        return tuple(to_torch(v, device, dtype) for v in obj)
    return _leaf_to_torch(obj, device, dtype)


def from_torch(obj):
    """The port's tensors -> numpy leaves in the reference's dtypes (int32
    ids/slots), same NamedTuple types."""
    if isinstance(obj, tuple):
        kids = [from_torch(v) for v in obj]
        return type(obj)(*kids) if hasattr(obj, "_fields") else tuple(kids)
    if isinstance(obj, torch.Tensor):
        a = obj.detach().cpu().numpy()
        return a.astype(np.int32) if a.dtype == np.int64 else a
    return obj
