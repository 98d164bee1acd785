"""Binary snapshot format + run folders + resume.

Writes the reference's exact ``.bin`` layout (`main.cpp:703-735`) so the
reference's offline tooling (``plot.py:26-76``) loads our frames unchanged:

    i32 magic = 0x11223344
    i32 map_count
    i32 nx, i32 ny
    f64 dx, f64 dy
    f64 time, i64 iter
    map_count x char[32] names
    map_count x f64[nx*ny] payloads (row-major, y*nx + x)

Resume (``load_bin_maps`` + ``SimConfig.init_path``) is the feature the
reference declared but never implemented (`config.h:20`).
"""
from __future__ import annotations

import dataclasses
import os
import struct
import time as time_mod
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.logging import get_logger

log = get_logger("snapshot")

BIN_MAGIC = 0x11223344
_HEADER = struct.Struct("<iiii d d d q")


def save_bin_maps(path: str, maps: Dict[str, np.ndarray], nx: int, ny: int,
                  dx: float, dy: float, t: float, it: int) -> None:
    names = []
    payloads = []
    for name, data in maps.items():
        arr = np.ascontiguousarray(np.asarray(data, dtype=np.float64))
        if arr.shape != (ny, nx):
            raise ValueError(f"map {name!r} has shape {arr.shape}, expected {(ny, nx)}")
        names.append(name)
        payloads.append(arr)

    with open(path, "wb") as f:
        f.write(_HEADER.pack(BIN_MAGIC, len(names), nx, ny, dx, dy, t, it))
        for name in names:
            raw = name.encode()[:31]
            f.write(raw + b"\x00" * (32 - len(raw)))
        for arr in payloads:
            f.write(arr.tobytes())


@dataclasses.dataclass
class BinSnapshot:
    nx: int
    ny: int
    dx: float
    dy: float
    time: float
    iter: int
    maps: Dict[str, np.ndarray]


def load_bin_maps(path: str) -> BinSnapshot:
    with open(path, "rb") as f:
        head = f.read(_HEADER.size)
        magic, count, nx, ny, dx, dy, t, it = _HEADER.unpack(head)
        if magic != BIN_MAGIC:
            raise ValueError(f"{path}: bad magic {magic:#x}")
        names = []
        for _ in range(count):
            raw = f.read(32)
            names.append(raw.split(b"\x00", 1)[0].decode())
        maps = {}
        for name in names:
            data = np.fromfile(f, dtype=np.float64, count=nx * ny)
            maps[name] = data.reshape(ny, nx)
    return BinSnapshot(nx=nx, ny=ny, dx=dx, dy=dy, time=t, iter=it, maps=maps)


def make_save_folder(folder: str, prefix: str, postfix: str, solver_name: str,
                     init_time: Optional[float] = None, create: bool = True) -> str:
    """Timestamped run folder (`main.cpp:760-780`).

    Deviation from the reference: the month is 1-based (the reference prints
    C's 0-based ``tm_mon`` directly).
    """
    t = time_mod.localtime(init_time if init_time is not None else time_mod.time())
    name = (f"{prefix}{t.tm_year:04d}-{t.tm_mon:02d}-{t.tm_mday:02d}__"
            f"{t.tm_hour:02d}-{t.tm_min:02d}-{t.tm_sec:02d}__{solver_name}{postfix}")
    path = os.path.join(folder, name) if folder else name
    if create:
        os.makedirs(path, exist_ok=True)
    return path
