"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

All ``csrc/*.cu`` files compile with ``nvcc`` (one process per source, all
started together) and link into ONE shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), loaded with ``ctypes``.  The build happens at first use, into ``_build/`` beside this
file, named by a hash of the sources so an edited source rebuilds.  Nothing
is built or imported at module import time: the CPU test suite imports every
module of the package on machines without ``nvcc`` or a GPU.

Each C entry point launches on the stream it is given, allocates nothing and
returns ``cudaGetLastError()``; ``Kernel.__call__`` raises on a nonzero code
and counts the launch, inside a ``utils.stats.SPANS`` span named after the
kernel (a no-op unless spans are recording).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .utils.stats import SPANS

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

# calls of the plain twins of K15-K19 on any device, by name ("fast", "nms",
# "brief", "match", "signature", "pnp", "pgo4"); a run on the card reads 0 for
# each (the twins of K11-K14 count in solver/lm.TWIN_CALLS)
TWIN_CALLS = collections.Counter()

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


class _Library:
    """The loaded kernel library plus how long its build took."""

    def __init__(self):
        self.cdll = None
        self.path = None
        self.build_seconds = None
        self.nvcc_output = ""


_LIB = _Library()


def _nvcc():
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for c in cands:
        p = Path(c) / "bin" / "nvcc"
        if c and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build():
    """Compile ``csrc/*.cu`` (once per source hash) and load the library.
    The compiler's output (``-Xptxas -v``) stays in ``nvcc_output``."""
    if _LIB.cdll is not None:
        return _LIB
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256()
    for s in sources + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libvplines_kernels_{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
        nvcc = _nvcc()
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(o),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, o in zip(sources, objs)]
        outs = [p.communicate()[0] for p in procs]
        _LIB.nvcc_output = "".join(outs)
        failed = [src.name for src, p in zip(sources, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{_LIB.nvcc_output}")
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        for o in objs:
            o.unlink()
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp, so)
    _LIB.build_seconds = time.perf_counter() - t0
    _LIB.cdll = ctypes.CDLL(str(so))
    _LIB.path = so
    return _LIB


class Kernel:
    """One C entry point of the kernel library, with its launch count.

    ``launches`` counts successful launches only; a wrapper calls the kernel
    exactly where the CUDA path launches it, so a run that leaves a count at
    0 never went through that kernel."""

    def __init__(self, name, source, replaces, argtypes):
        self.name = name
        self.source = source  # path in the repo
        self.replaces = replaces  # file:line of the JAX op it replaces
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args):
        if self._fn is None:
            fn = getattr(build().cdll, self.name)
            fn.argtypes = self.argtypes + [P]  # + stream
            fn.restype = I
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        with SPANS.span(self.name):
            err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: error {err}")
        self.launches += 1


def args_struct(name, pointers, ints=(), doubles=()):
    """A ctypes Structure of void pointers, then C ints, then doubles: the
    field order of the argument struct a kernel's C entry takes by pointer."""
    fields = ([(n, P) for n in pointers] + [(n, I) for n in ints]
              + [(n, ctypes.c_double) for n in doubles])
    return type(name, (ctypes.Structure,), {"_fields_": fields})


def check(t, name, dtype=torch.float32, ndim=None, shape=None):
    """Validate a tensor handed to a kernel: CUDA, dtype, rank or exact shape,
    contiguity.  Returns its data pointer."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    return t.data_ptr()


def all_kernels():
    """Every kernel of the package: the point front-end's (K1-K4), the line
    front-end's (K5-K8), then CLAHE (K9, both trackers with equalize), IMU
    preintegration (K10), the estimator's window linearization, block
    assembly, Schur solve and marginalization (K11-K14), then loop
    closure's FAST (K15), BRIEF (K16), Hamming match and SimHash signature
    (K17), PnP hypotheses (K18) and 4-DoF pose graph (K19)."""
    from .estimator import linearize
    from .models import imu, pose_graph
    from .ops import brief, corners, image, klt, line_match, lines, mvg, vp
    from .solver import lm, marginalization

    return [image.PYR_DOWN, klt.KLT_TRACK_LEVEL, corners.CORNER_RESPONSE,
            corners.CORNER_SELECT, mvg.SAMPSON_SCORE, image.REMAP_STATIC,
            lines.LINE_ANCHORS, lines.LINE_GROW, line_match.LINE_VOTE, vp.VP_GRID,
            vp.VP_SCORE, image.CLAHE_LUT, image.CLAHE_APPLY, imu.PREINTEGRATE,
            linearize.WINDOW_LIN, lm.WINDOW_BLOCKS, lm.SCHUR_SOLVE,
            marginalization.MARG_WINDOW, brief.FAST, brief.BRIEF, brief.HAMMING_MATCH,
            brief.SIMHASH, mvg.PNP_HYPOTHESES, pose_graph.PGO4]
