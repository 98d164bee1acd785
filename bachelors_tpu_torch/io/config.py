"""INI configuration system, key-compatible with the reference.

The port's copy of ``bachelors_tpu/io/config.py``: the same keys, defaults
and errors, so one config file drives either package.  The semantics are
those of the reference's hand-rolled parser + binder
(`config.h:140-224` parser, `:396-519` binding): ``[section]`` headers,
``key = value`` pairs, ``;``/``#`` comments (whole-line and inline),
last-value-wins, typed getters including Vec2 ("x y"), bools, and
solver/boundary enums by name.  All reference keys are required, matching
the all-must-match accumulation; missing keys are reported by name.

Extensions over the reference:
  * override strings actually work (the reference plumbs them but never
    passes any, `config.h:410-411`, `main.cpp:253`);
  * ``[initial] init_path`` resumes from a ``.bin`` snapshot -- declared but
    never implemented upstream (`config.h:20`);
  * optional ``[tpu]`` section: dtype / backend / mesh shards.  The section
    keeps its name; ``backend`` takes the port's values (``core/params.py``),
    and the mesh keys are parsed but only 1 runs (``app/driver.py`` raises
    for more).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..core.params import (BoundaryType, SimParams, SolverType,
                           boundary_type_from_string, rewire_params_for_exact,
                           solver_type_from_string)
from ..models.initial import InitialConditions
from ..utils.logging import get_logger

log = get_logger("config")


class ConfigError(ValueError):
    pass


def parse_ini(text: str) -> Dict[Tuple[str, str], str]:
    """Parse INI text into {(section, key): value} with last-wins semantics."""
    pairs: Dict[Tuple[str, str], str] = {}
    section = ""
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line[0] in ";#":
            continue
        # strip inline comments
        for marker in (";", "#"):
            pos = line.find(marker)
            if pos >= 0:
                line = line[:pos].rstrip()
        if not line:
            continue
        if line.startswith("["):
            if not line.endswith("]"):
                log.error(f"malformed section header at line {lineno}: {raw!r}")
                continue
            section = line[1:-1].strip()
            continue
        for marker in ("=", ":"):
            pos = line.find(marker)
            if pos >= 0:
                key = line[:pos].strip()
                val = line[pos + 1:].strip()
                pairs[(section, key)] = val
                break
        else:
            log.error(f"malformed line {lineno} (no '=' or ':'): {raw!r}")
    return pairs


class _Binder:
    """Typed getters over parsed pairs, collecting missing/bad keys."""

    def __init__(self, pairs):
        self.pairs = pairs
        self.missing: List[str] = []

    def _raw(self, section, key, required):
        v = self.pairs.get((section, key))
        if v is None and required:
            self.missing.append(f"[{section}] {key}")
        return v

    def get_float(self, section, key, default=0.0, required=True):
        v = self._raw(section, key, required)
        if v is None:
            return default
        try:
            return float(v)
        except ValueError:
            self.missing.append(f"[{section}] {key} (bad float: {v!r})")
            return default

    def get_int(self, section, key, default=0, required=True):
        return int(self.get_float(section, key, default, required))

    def get_bool(self, section, key, default=False, required=True):
        v = self._raw(section, key, required)
        if v is None:
            return default
        lv = v.strip().lower()
        if lv in ("true", "1", "yes", "on"):
            return True
        if lv in ("false", "0", "no", "off"):
            return False
        self.missing.append(f"[{section}] {key} (bad bool: {v!r})")
        return default

    def get_str(self, section, key, default="", required=True):
        v = self._raw(section, key, required)
        return default if v is None else v

    def get_vec2(self, section, key, default=(0.0, 0.0), required=True):
        v = self._raw(section, key, required)
        if v is None:
            return default
        parts = v.replace(",", " ").split()
        if len(parts) != 2:
            self.missing.append(f"[{section}] {key} (bad vec2: {v!r})")
            return default
        try:
            return (float(parts[0]), float(parts[1]))
        except ValueError:
            self.missing.append(f"[{section}] {key} (bad vec2: {v!r})")
            return default

    def get_solver(self, section, key):
        v = self._raw(section, key, True)
        if v is None:
            return SolverType.NONE
        try:
            return solver_type_from_string(v)
        except ValueError:
            self.missing.append(f"[{section}] {key} (unknown solver: {v!r})")
            return SolverType.NONE

    def get_boundary(self, section, key):
        v = self._raw(section, key, True)
        if v is None:
            return BoundaryType.NEUMANN
        try:
            return boundary_type_from_string(v)
        except ValueError:
            self.missing.append(f"[{section}] {key} (unknown boundary: {v!r})")
            return BoundaryType.NEUMANN


@dataclasses.dataclass
class SimConfig:
    """Full application config (reference ``Sim_Config``, `config.h:10-57`)."""

    params: SimParams
    initial: InitialConditions

    entire_config_text: str = ""
    scale: float = 1.0
    stop_time: float = 0.04
    init_path: str = ""

    snapshot_every: float = 9999.0
    snapshot_times: int = 10
    snapshot_initial_conditions: bool = True
    snapshot_folder: str = "snapshots"
    snapshot_netcdf: bool = False
    snapshot_prefix: str = ""
    snapshot_postfix: str = ""

    run_simulation: bool = True
    run_tests: bool = False
    run_benchmarks: bool = False
    interactive: bool = False
    print_in_noninteractive: bool = True
    linear_filtering: bool = False
    collect_stats: bool = False
    collect_step_residual: bool = False
    collect_stats_every: float = 0.0
    display_min: float = 0.0
    display_max: float = 1.0
    debug: bool = False

    # [tpu] decomposition keys: multi-GPU grids and ensembles are ROADMAP
    # slices 4-5; the driver raises for anything but one device.
    shards_y: int = 1
    shards_x: int = 1
    ensemble: int = 1
    batch_shards: int = 1
    multihost: bool = False


def load_config(path: str, overrides: Optional[List[str]] = None) -> SimConfig:
    """Read and bind a config file; ``overrides`` are extra INI fragments
    (e.g. ``"[simulation]\\nsolver = explicit"``) applied last."""
    with open(path, "r") as f:
        text = f.read()
    return parse_config(text, overrides)


def parse_config(text: str, overrides: Optional[List[str]] = None) -> SimConfig:
    pairs = parse_ini(text)
    for ov in overrides or []:
        pairs.update(parse_ini(ov))

    b = _Binder(pairs)
    S = "simulation"
    p = SimParams(
        dt=b.get_float(S, "dt"),
        L0=b.get_float(S, "L0"),
        L=b.get_float(S, "L"),
        xi=b.get_float(S, "xi"),
        a=b.get_float(S, "a"),
        b=b.get_float(S, "b"),
        alpha=b.get_float(S, "alpha"),
        beta=b.get_float(S, "beta"),
        Tm=b.get_float(S, "Tm"),
        S=b.get_float(S, "S"),
        m0=b.get_float(S, "m"),
        theta0=b.get_float(S, "theta0"),
        gamma=b.get_float(S, "gamma"),
        do_exact=b.get_bool(S, "do_exact"),
        solver=b.get_solver(S, "solver"),
        Phi_boundary=b.get_boundary(S, "Phi_boundary"),
        T_boundary=b.get_boundary(S, "T_boundary"),
        nx=b.get_int(S, "mesh_size_x"),
        ny=b.get_int(S, "mesh_size_y"),
        T_tolerance=b.get_float(S, "T_tolerance"),
        Phi_tolerance=b.get_float(S, "Phi_tolerance"),
        corrector_tolerance=b.get_float(S, "corrector_tolerance"),
        T_max_iters=b.get_int(S, "T_max_iters"),
        Phi_max_iters=b.get_int(S, "Phi_max_iters"),
        corrector_max_iters=b.get_int(S, "corrector_max_iters"),
        do_corrector_loop=b.get_bool(S, "do_corrector_loop"),
        do_corrector_guess=b.get_bool(S, "do_corrector_guess"),
        min_dt=b.get_float(S, "min_dt", 0.0, required=False),
        dtype=b.get_str("tpu", "dtype", "float32", required=False),
        backend=b.get_str("tpu", "backend", "auto", required=False),
    )

    I = "initial"
    ic = InitialConditions(
        inside_phi=b.get_float(I, "inside_phi"),
        inside_T=b.get_float(I, "inside_T"),
        outside_phi=b.get_float(I, "outside_phi"),
        outside_T=b.get_float(I, "outside_T"),
        circle_center=b.get_vec2(I, "circle_center"),
        circle_radius=b.get_float(I, "circle_radius"),
        circle_fade=b.get_float(I, "circle_fade"),
        square_from=b.get_vec2(I, "square_from"),
        square_to=b.get_vec2(I, "square_to"),
        noise_T=b.get_float(I, "noise_T", 0.0, required=False),
        noise_phi=b.get_float(I, "noise_phi", 0.0, required=False),
        noise_cells=b.get_int(I, "noise_cells", 8, required=False),
        noise_octaves=b.get_int(I, "noise_octaves", 3, required=False),
        noise_seed=b.get_int(I, "noise_seed", 0, required=False),
    )

    cfg = SimConfig(
        params=p,
        initial=ic,
        entire_config_text=text,
        stop_time=b.get_float(S, "stop_after"),
        init_path=b.get_str(I, "init_path", "", required=False),
        snapshot_every=b.get_float("snapshot", "every"),
        snapshot_times=b.get_int("snapshot", "times"),
        snapshot_initial_conditions=b.get_bool("snapshot", "snapshot_initial_conditions"),
        snapshot_folder=b.get_str("snapshot", "folder"),
        snapshot_netcdf=b.get_bool("snapshot", "netcdf", False, required=False),
        snapshot_prefix=b.get_str("snapshot", "prefix"),
        snapshot_postfix=b.get_str("snapshot", "postfix"),
        run_simulation=b.get_bool("program", "run_simulation"),
        run_tests=b.get_bool("program", "run_tests"),
        run_benchmarks=b.get_bool("program", "run_benchmarks"),
        interactive=b.get_bool("program", "interactive"),
        print_in_noninteractive=b.get_bool("program", "print_in_noninteractive"),
        linear_filtering=b.get_bool("program", "linear_filtering"),
        collect_stats=b.get_bool("program", "collect_stats"),
        collect_step_residual=b.get_bool("program", "collect_step_residual"),
        collect_stats_every=b.get_float("program", "collect_stats_every"),
        display_min=b.get_float("program", "display_min"),
        display_max=b.get_float("program", "display_max"),
        debug=b.get_bool("program", "debug", False, required=False),
        shards_y=b.get_int("tpu", "shards_y", 1, required=False),
        shards_x=b.get_int("tpu", "shards_x", 1, required=False),
        ensemble=b.get_int("tpu", "ensemble", 1, required=False),
        batch_shards=b.get_int("tpu", "batch_shards", 1, required=False),
        multihost=b.get_bool("tpu", "multihost", False, required=False),
    )

    # scale multiplier (`config.h:481-490`): scales the mesh and the domain
    # together (constant dx) plus the seed position.
    scale = b.get_float(S, "scale", 1.0, required=False)
    if ("simulation", "scale") in pairs:
        p = cfg.params
        cfg.params = p.replace(
            nx=int(p.nx * scale), ny=int(p.ny * scale), L0=p.L0 * scale)
        cfg.initial = dataclasses.replace(
            cfg.initial,
            circle_center=(ic.circle_center[0] * scale, ic.circle_center[1] * scale))
        cfg.scale = scale

    if cfg.params.do_exact:
        cfg.params = rewire_params_for_exact(cfg.params)
        cfg.initial = dataclasses.replace(cfg.initial, circle_radius=0.25)
        log.warn(f"do_exact: dt rewired to {cfg.params.dt:e}")

    cfg.params = cfg.params.replace(
        do_stats=cfg.collect_stats,
        do_stats_step_residual=cfg.collect_step_residual,
    )

    if b.missing:
        raise ConfigError(
            "couldn't find or parse config entries: " + ", ".join(b.missing))
    log.okay("config successfully read!")
    return cfg
