"""The launch path that every kernel wrapper of the port shares.

The wrappers of ``ops/cuda_rhs``, ``ops/cuda_cg``, ``ops/cuda_stats`` and
``ops/cuda_tutorial`` call the kernels' plain C entry points
(``csrc/*.cu``, built by ``ops/cuda_build``) through ctypes.  At 512^2 a
small kernel takes ~2 µs on the card and its wrapper tens of µs on the
host, so the per-call host cost is the wrappers' time (PERF.md §5).  Here
it is paid once for all of them:

  * **Bound once.**  Each module declares its entry points in a table of
    argument types (``register``); they are bound when the library is
    loaded, and ``fn(name, dtype)`` is one dict read: no f-string, no
    ``getattr`` per call.  A wrong prototype would pass garbage silently,
    so ``tests/test_torch_launch.py`` holds every table to the ``extern
    "C"`` definitions of ``csrc/*.cu``.
  * **Cheap checks.**  ``fields_ok`` is one pass of attribute reads; only a
    call that fails it takes the wrappers' detailed checks, which raise
    with their messages.
  * **The device context only when needed.**  ``launch`` enters
    ``torch.cuda.device`` only when the tensors' device is not the current
    one.
  * **The stream handle without a Stream object**
    (``torch._C._cuda_getCurrentRawStream``, the raw handle PyTorch's own
    generated code launches on).
  * **Scratch reused, results not.**  ``scratch`` hands out per-launch
    scratch (the per-block partials of a reduction, and K8's ticket
    counter) from a cache keyed by (what, size, dtype, device, stream),
    zeroed once: a launch on one stream is ordered after the last one that
    used the buffer.  Results are always new
    tensors: a 0-dim dot product of one CG iteration is read again in the
    next.

Nothing here is imported from PyTorch's CUDA build at import time: the CPU
tests import every module.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import cuda_build

PTR = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong
FLOAT = ctypes.c_float


# Argument kinds resolved per field dtype when an entry is bound: the field
# type's scalar (c_float or c_double) and a pointer to its PhysParams.
REAL = object()
PHYS_PTR = object()

SUFFIX = {torch.float32: ("f32", ctypes.c_float), torch.float64: ("f64", ctypes.c_double)}
BOTH = tuple(SUFFIX)
UNSUFFIXED = (None,)

# (table, dtypes, PhysParams struct per dtype) of every module, bound when
# the library is loaded
_TABLES = []
_FNS: Dict[Tuple[str, Optional[torch.dtype]], object] = {}
_LIB: Optional[ctypes.CDLL] = None
_SCRATCH: Dict[tuple, torch.Tensor] = {}
_HOOKS = None


def c_name(name: str, dtype: Optional[torch.dtype]) -> str:
    """``bt_<name>_f32``, ``bt_<name>_f64``, or ``bt_<name>`` without a dtype."""
    return f"bt_{name}" if dtype is None else f"bt_{name}_{SUFFIX[dtype][0]}"


def _bind(lib: ctypes.CDLL, table, dtypes, phys) -> None:
    for name, args in table.items():
        for dtype in dtypes:
            f = getattr(lib, c_name(name, dtype))
            f.argtypes = [SUFFIX[dtype][1] if a is REAL else
                          ctypes.POINTER(phys[dtype]) if a is PHYS_PTR else a for a in args]
            f.restype = INT
            _FNS[name, dtype] = f


def register(table, dtypes=BOTH, phys=None) -> None:
    """Declare the C entry points of ``table`` ({name: argument kinds}) at
    each of ``dtypes`` (``UNSUFFIXED`` for ``bt_<name>`` itself), bound when
    the library is loaded; ``phys`` maps a dtype to its PhysParams
    struct."""
    _TABLES.append((table, dtypes, phys))
    if _LIB is not None:
        _bind(_LIB, table, dtypes, phys)


def lib() -> ctypes.CDLL:
    """The kernels' library, built if needed and loaded, every registered
    table bound."""
    global _LIB
    if _LIB is None:
        loaded = cuda_build.load()
        for table, dtypes, phys in _TABLES:
            _bind(loaded, table, dtypes, phys)
        _LIB = loaded
    return _LIB


def fn(name: str, dtype: Optional[torch.dtype] = None):
    """The bound C function of entry ``name`` at ``dtype`` (None: the
    unsuffixed helper)."""
    f = _FNS.get((name, dtype))
    if f is None:
        lib()
        f = _FNS[name, dtype]
    return f


def _hooks():
    """(current device index, raw current stream of a device), PyTorch's
    own C functions behind ``torch.cuda.current_device`` and its generated
    code's stream handle."""
    global _HOOKS
    if _HOOKS is None:
        _HOOKS = (torch._C._cuda_getDevice, torch._C._cuda_getCurrentRawStream)
    return _HOOKS


def launch(counts: Dict[str, int], what: str, f, index: int, *args) -> None:
    """Call the bound entry ``f`` with ``args`` and the current stream of
    CUDA device ``index``, inside that device's context only when it is not
    the current one; raise on the CUDA error the entry returns, else add
    one to ``counts[what]``."""
    current, stream = _HOOKS or _hooks()
    if current() == index:
        rc = f(*args, stream(index))
    else:
        with torch.cuda.device(index):
            rc = f(*args, stream(index))
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
    counts[what] += 1


def scratch(size: str, args: tuple, dtype: torch.dtype, index: int,
            per: int = 1) -> torch.Tensor:
    """Scratch of ``per * bt_<size>(*args)`` values of ``dtype`` on CUDA
    device ``index``, one buffer per (size, args, dtype, device, stream),
    reused by every launch on that stream: stream order puts each launch
    after the last one that read it.  Zeroed when it is allocated, once: K8
    keeps a ticket counter there that each launch leaves at 0.  Never hand
    out a result from here."""
    stream = (_HOOKS or _hooks())[1](index)
    key = (size, args, dtype, index, stream)
    buf = _SCRATCH.get(key)
    if buf is None:
        buf = _SCRATCH[key] = torch.zeros(per * fn(size)(*args), dtype=dtype,
                                          device=torch.device("cuda", index))
    return buf


def fields_ok(tensors, shape=None):
    """(dtype, device index) of tensors that share a float32 or float64
    dtype, a device and a 2-D shape (``shape`` when given) and are
    contiguous, in one pass of attribute reads; None sends a wrapper to its
    detailed checks, which raise with their messages."""
    t = tensors[0]
    dtype, index, first = t.dtype, t.get_device(), t.shape
    if (dtype not in SUFFIX or len(first) != 2 or (shape is not None and first != shape)
            or not t.is_contiguous()):
        return None
    for t in tensors[1:]:
        if (t.dtype is not dtype or t.get_device() != index or t.shape != first
                or not t.is_contiguous()):
            return None
    return dtype, index


def scalars_ok(scalars, dtype: torch.dtype, index: int) -> bool:
    """Every scalar a 0-dim tensor of ``dtype`` on device ``index``."""
    try:
        for t in scalars:
            if t.dtype is not dtype or t.get_device() != index or t.dim() != 0:
                return False
    except AttributeError:  # not a tensor
        return False
    return True
