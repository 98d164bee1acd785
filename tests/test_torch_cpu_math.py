"""The plain path's first transcendentals on the CPU.

torch computes cos, sqrt and exp on the CPU with MKL's vector math, in
chunks of 2048 values spread over the intra-op threads, and the first such
call of a process can run one thread's chunk through a low-accuracy kernel:
in fresh processes with two intra-op threads, under load, the first
``torch.cos`` of a float64 64x128 field came back up to 7e-9 relative off in
its second half now and then (MKL's EP-accuracy AVX2 cos, bit for bit).  In
whole tier-1 runs that broke the float64 parity of the first RK4 or Euler
test file of a worker (ROADMAP §3).  The port therefore warms the library
(``core.device.warm_cpu_math``) before its plain path computes: the first
call of each function in a process is a single chunk, then one over every
thread, and only then the fields' own.  A fresh process shows the order.
"""
import json
import os
import subprocess
import sys
import textwrap

import torch

from bachelors_tpu_torch.core import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIRST_CALLS = textwrap.dedent("""
    import json, sys
    sys.modules["jax"] = None
    import numpy as np
    import torch
    torch.set_num_threads(2)
    calls = []
    for name in ("cos", "sqrt", "exp"):
        def wrap(x, *a, _fn=getattr(torch, name), _name=name, **k):
            calls.append([_name, x.numel()])
            return _fn(x, *a, **k)
        setattr(torch, name, wrap)
    from bachelors_tpu_torch.core.params import BoundaryType, SimParams
    from bachelors_tpu_torch.solvers import explicit
    p = SimParams(ny=64, nx=128, S=0.3, m0=6.0, theta0=0.1, dtype="float64",
                  f32_transcendentals=False, Phi_boundary=BoundaryType.PERIODIC,
                  T_boundary=BoundaryType.PERIODIC)
    F = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 128)))
    explicit.rk4_step(F, F.clone(), p, 0.03)
    print(json.dumps(calls))
""")


def test_plain_path_warms_the_cpu_math_before_its_first_cos():
    """In a fresh process, the plain RK4 step's transcendentals: the first
    call of each is one chunk's worth, and a call over every intra-op thread
    comes before the first call on the 64x128 field."""
    out = subprocess.run([sys.executable, "-c", FIRST_CALLS], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    calls = json.loads(out.stdout.strip().splitlines()[-1])
    field = 64 * 128
    for name in ("cos", "sqrt"):
        sizes = [n for f, n in calls if f == name]
        assert sizes and sizes[0] <= 1024, (name, sizes[:4])
        first_field = sizes.index(field)
        assert any(n > 4096 * 2 for n in sizes[:first_field]), (name, sizes[:first_field])


def test_warm_cpu_math_runs_once_per_thread_count(monkeypatch):
    calls = []
    cos = torch.cos
    monkeypatch.setattr(torch, "cos", lambda x: calls.append(x.numel()) or cos(x))
    threads = torch.get_num_threads()
    monkeypatch.setattr(device, "_WARMED_FOR_THREADS", None)
    device.warm_cpu_math()
    assert calls == [1000, 4096 * threads + 1000] * 2  # float32, then float64
    device.warm_cpu_math()
    assert len(calls) == 4
    monkeypatch.setattr(device, "_WARMED_FOR_THREADS", threads + 1)  # a new count
    device.warm_cpu_math()
    assert len(calls) == 8 and device._WARMED_FOR_THREADS == threads
