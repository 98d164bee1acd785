"""K11 (``ops/cuda_stats``), the reduction microbench (``bench/microbench``),
its timing harness (``utils/timing``) and the driver's ``run_benchmarks``
hook.

On the CPU ``cuda_field_stats`` runs its plain version, which is held to
the JAX package's Pallas stats kernel in interpret mode on the JAX test's
own input (tests/test_pallas.py:597-610, rtol 2e-5, atol 2e-4) and to the
port's plain stats pass.  K11 itself is held to the plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bachelors_tpu.ops.pallas_stats import pallas_field_stats
from bachelors_tpu_torch.app.driver import run_config_file
from bachelors_tpu_torch.bench import microbench
from bachelors_tpu_torch.ops import cuda_stats, reductions
from bachelors_tpu_torch.utils import timing

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config.ini")
KEYS = ("sum", "L1", "L2", "min", "max")
JAX_RESULT_KEYS = {"n", "max_gbps", "fused_stats_gbps", "pallas_stats_gbps"}


def _jax_input(rng):
    return rng.normal(size=(256 * 1024,)).astype(np.float32) * 3.7


def test_plain_stats_match_pallas_interpret(rng):
    x = _jax_input(rng)
    got = cuda_stats.cuda_field_stats(torch.from_numpy(x))
    want = pallas_field_stats(jnp.asarray(x), interpret=True)
    for k in KEYS:
        np.testing.assert_allclose(float(getattr(got, k)), float(getattr(want, k)),
                                   rtol=2e-5, atol=2e-4, err_msg=k)
        assert getattr(got, k).dtype == torch.float32 and getattr(got, k).dim() == 0


def test_plain_stats_match_the_stats_pass(rng):
    """The port's plain stats pass (``reductions.field_stats``, which has
    no sum) on the same input, and float64 numpy for the sum."""
    x = torch.from_numpy(_jax_input(rng)).reshape(256, 1024)
    got = cuda_stats.field_stats_plain(x)
    want = reductions.field_stats(x)
    for k in ("L1", "L2", "min", "max"):
        np.testing.assert_allclose(float(getattr(got, k)), float(getattr(want, k)),
                                   rtol=2e-5, atol=2e-4, err_msg=k)
    np.testing.assert_allclose(float(got.sum), x.double().sum().item(), rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("n", [1, 7, 1000, 1023, 1025])
def test_ragged_sizes_are_taken(n, rng):
    """Any size: the JAX kernel needs a multiple of 1024 (ROADMAP §3, a
    standing difference); each value against float64 numpy."""
    x = rng.uniform(-2, 3, size=n).astype(np.float32)
    if n % 1024:
        with pytest.raises(ValueError, match="divisible"):
            pallas_field_stats(jnp.asarray(x), interpret=True)
    got = cuda_stats.cuda_field_stats(torch.from_numpy(x))
    d = x.astype(np.float64)
    want = {"sum": d.sum(), "L1": np.abs(d).mean(), "L2": math.sqrt((d * d).mean()),
            "min": d.min(), "max": d.max()}
    for k in KEYS:
        np.testing.assert_allclose(float(getattr(got, k)), want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_nan_reaches_min_and_max(rng):
    x = rng.normal(size=4096).astype(np.float32)
    x[1234] = np.nan
    got = cuda_stats.cuda_field_stats(torch.from_numpy(x))
    for k in KEYS:
        assert math.isnan(float(getattr(got, k))), k


def test_stats_of_a_float64_field_and_no_launch_on_the_cpu(rng):
    """The JAX kernel casts its input to float32 (pallas_stats.py:52); the
    plain version does too, and a CPU tensor counts no launch."""
    x = rng.normal(size=(64, 64))
    cuda_stats.reset_launch_counts()
    got = cuda_stats.cuda_field_stats(torch.from_numpy(x))
    want = cuda_stats.field_stats_plain(torch.from_numpy(x.astype(np.float32)))
    for k in KEYS:
        assert float(getattr(got, k)) == float(getattr(want, k)), k
    assert cuda_stats.LAUNCHES == {"field_stats": 0}


def test_microbench_sweep_on_the_cpu():
    """The JAX sweep's sizes (256^2 * 4^k up to n_max) and result keys; each
    rate a positive number."""
    res = microbench.run_reduction_benchmark(n_max=4 * 256 * 256, device="cpu",
                                             max_time_s=0.0)
    assert [r["n"] for r in res] == [256 * 256, 4 * 256 * 256]
    for r in res:
        assert set(r) == JAX_RESULT_KEYS
        assert all(math.isfinite(r[k]) and r[k] > 0 for k in JAX_RESULT_KEYS - {"n"})


@pytest.mark.parametrize("n_max,sizes", [(100, [100]), (65535, [65535]),
                                         (65536, [65536]), (2 * 4096 * 4096, [4 ** k * 65536
                                                                            for k in range(5)])])
def test_microbench_sizes(n_max, sizes):
    assert microbench.reduction_sizes(n_max) == sizes


def test_microbench_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        microbench.run_reduction_benchmark(1000)


def test_microbench_main_writes_json(tmp_path, capsys):
    out = tmp_path / "bench.json"
    assert microbench.main(["--device", "cpu", "--n-max", "4096", "--out", str(out)]) == 0
    import json

    doc = json.loads(out.read_text())
    assert doc["device"] == "cpu" and [r["n"] for r in doc["results"]] == [4096]


def test_timing_harness_on_the_cpu():
    calls = []
    st = timing.benchmark_median(lambda: calls.append(1), "cpu", warmup=2, max_time_s=0.0,
                                 min_runs=5)
    assert st.runs == 5 and len(calls) == 7
    assert 0 <= st.min <= st.p10 <= st.median <= st.p90 <= st.max
    per_step, final = timing.benchmark_steps(lambda s: s + 1, 0, 10, "cpu", warmup=2,
                                             repeats=3)
    assert final == 2 + 3 * 10 and per_step >= 0


def test_driver_runs_the_sweep_then_the_simulation(tmp_path, monkeypatch):
    """``[program] run_benchmarks = true``: the sweep up to the config's
    cell count on the run's device, then the run itself."""
    order = []
    real = microbench.run_reduction_benchmark

    def sweep(n_max, device=None, **kw):
        order.append(("sweep", n_max, device))
        return real(n_max, device, max_time_s=0.0)

    monkeypatch.setattr(microbench, "run_reduction_benchmark", sweep)
    res = run_config_file(CONFIG, [
        "[simulation]\nmesh_size_x = 64\nmesh_size_y = 64\nstop_after = 4e-4\n",
        f"[snapshot]\ntimes = 1\nfolder = {tmp_path}\n",
        "[program]\nrun_benchmarks = true\n"], device="cpu")
    assert order == [("sweep", 64 * 64, "cpu")]
    assert res is not None and res.iters > 0
    assert any(f.endswith(".bin") for f in os.listdir(res.save_folder))


def test_driver_run_tests_still_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="item 17"):
        run_config_file(CONFIG, [f"[snapshot]\nfolder = {tmp_path}\n",
                                 "[program]\nrun_tests = true\n"], device="cpu")
