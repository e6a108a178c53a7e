"""Case configuration: YAML schema compatible with the reference solver.

The port's own copy of `open_ludwig_tpu/config.py` (the same dataclass,
fields and defaults; `tests/test_torch_host_modules.py` loads every
`CASES/*/config.yaml` through both and holds them equal).

The reference materializes ~60 typed globals from a two-tier `basic:` /
`advanced:` YAML (reference: src/config_loader.jl:109-209).  Here the same
schema loads into one frozen dataclass so reference case files run unmodified.

Defaults mirror the reference's `safe_get` defaults (not the module-level
globals, which sometimes differ — e.g. boundary.method defaults to "bouzidi"
per config_loader.jl:181).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Tuple

import yaml


def _get(d: Dict, *keys, default=None, required=False):
    cur: Any = d
    for k in keys:
        if not isinstance(cur, dict) or k not in cur or cur[k] is None:
            if required:
                raise KeyError("Missing config key: " + " -> ".join(keys))
            return default
        cur = cur[k]
    return cur


@dataclass(frozen=True)
class OutputFields:
    density: bool = True
    velocity: bool = True
    velocity_magnitude: bool = True
    vorticity: bool = True
    obstacle: bool = True
    level: bool = True
    bouzidi: bool = True


@dataclass(frozen=True)
class CaseConfig:
    # --- basic ---
    case_dir: str = ""
    stl_file: str = ""
    stl_scale: float = 1.0
    surface_resolution: int = 200
    num_levels: int = 0
    reference_area_full_model: float = 0.0
    reference_chord: float = 0.0
    reference_length_for_meshing: float = 0.0
    reference_dimension: str = "x"
    fluid_density: float = 1.225
    fluid_kinematic_viscosity: float = 1.5e-5
    flow_velocity: float = 10.0
    steps: int = 1000
    ramp_steps: int = 4000
    output_freq: int = 100
    output_dir: str = "RESULTS"
    output_fields: OutputFields = field(default_factory=OutputFields)

    # --- advanced.numerics ---
    u_lattice: float = 0.01
    c_wale: float = 0.20
    tau_min: float = 0.505
    tau_safety_factor: float = 1.0
    inlet_turbulence_intensity: float = 0.01
    nu_sgs_background: float = 0.0005
    sponge_blend_distributions: bool = True
    temporal_interpolation: bool = True

    # --- advanced.high_re ---
    auto_levels: bool = False
    max_levels: int = 12
    min_coarse_blocks: int = 4
    wall_model_enabled: bool = False
    wall_model_type: str = "equilibrium"
    wall_model_yplus_target: float = 30.0

    # --- advanced.domain ---
    domain_upstream: float = 0.75
    domain_downstream: float = 1.5
    domain_lateral: float = 0.75
    domain_height: float = 0.75
    sponge_thickness: float = 0.10

    # --- advanced.refinement ---
    block_size: int = 8  # informational; engine block edge is fixed at 8
    refinement_margin: int = 2
    refinement_strategy: str = "geometry_first"
    symmetric_analysis: bool = False
    wake_enabled: bool = False
    wake_length: float = 0.25
    wake_width_factor: float = 0.1
    wake_height_factor: float = 0.1

    # --- advanced.boundary ---
    boundary_method: str = "bouzidi"
    bouzidi_levels: int = 1
    q_min_threshold: float = 0.001

    # --- advanced.forces ---
    forces_enabled: bool = True
    force_output_freq: int = 0
    # engine extension: two-point wall-normal pressure extrapolation in the
    # surface-stress mapping (the reference's single nearest-cell sample
    # biases the pressure drag of streamlined bodies; see ops/forces.py)
    force_extrapolate: bool = False
    # "stress" (reference parity: nearest-cell stress sampling) or
    # "momentum_exchange" (momentum-flux balance across the obstacle-mask
    # fluid/solid interface; re-derived from the method the reference
    # carries as dead code, src/forces/global.jl — required for
    # streamlined-body drag, see ops/forces.py MEMContext and
    # VALIDATION.md: wing Cd matches an independent control-volume
    # balance to 1.9% where stress mapping has the wrong sign)
    force_method: str = "stress"
    moment_center: Tuple[float, float, float] = (0.25, 0.0, 0.0)

    # --- advanced.diagnostics ---
    diag_freq: int = 500
    stability_check: bool = True
    stability_action: str = "warn"    # "warn" logs and continues (reference
                                      # behavior); "abort" checkpoints the
                                      # last-good state and ends the case
    print_tau_warning: bool = True

    # --- advanced.gpu (reference knob; maps to on-device scan length) ---
    async_depth: int = 8

    # --- engine extensions (not in the reference schema) ---
    checkpoint_freq: int = 0          # steps between checkpoints (0 = off)
    checkpoint_resume: bool = False   # resume from latest checkpoint if found
    precision: str = "float32"
    layout: str = "patch"             # "patch" (dense nested boxes, TPU fast
                                      # path) or "blocks" (sparse 8^3 blocks)
    devices: int = 1                  # >1: shard the run over an x-slab
                                      # device mesh (patch layout only)
    flat_coarse: str = "auto"         # informational: the JAX package's
                                      # flat-(y,z) storage of interface-free
                                      # levels ("auto", "on", "off"), parsed
                                      # so its cases load; the card's kernel
                                      # rule (ops/engine.py) does not read it
    domain_tile_snap: bool = False    # grow the coarse grid to TPU tile
                                      # multiples (x,y -> 16, z -> 128):
                                      # lane/sublane padding becomes real
                                      # simulated fluid instead of dead
                                      # compute (up to ~30% of a large box
                                      # otherwise; see scaling.py).  Off by
                                      # default: it changes domain extents,
                                      # hence blockage/Cd very slightly

    @property
    def reference_area(self) -> float:
        # Half reference area for symmetric half-models
        # (reference: src/config_loader.jl:129).
        a = self.reference_area_full_model
        return a / 2.0 if self.symmetric_analysis else a

    @property
    def effective_force_output_freq(self) -> int:
        return self.force_output_freq if self.force_output_freq > 0 else self.diag_freq

    @property
    def stl_path(self) -> str:
        p = os.path.join(self.case_dir, self.stl_file)
        if os.path.isfile(p):
            return p
        alt = os.path.join(self.case_dir, "model.stl")
        if os.path.isfile(alt):
            return alt
        raise FileNotFoundError(f"STL not found: {p}")

    @property
    def output_path(self) -> str:
        return os.path.join(self.case_dir, self.output_dir)

    def with_overrides(self, **kw) -> "CaseConfig":
        return replace(self, **kw)


def load_case_config(case_dir: str) -> CaseConfig:
    """Load a case directory containing config.yaml (reference schema)."""
    path = os.path.join(case_dir, "config.yaml")
    with open(path) as f:
        cfg = yaml.safe_load(f)
    return parse_config(cfg, case_dir)


def parse_config(cfg: Dict, case_dir: str = "") -> CaseConfig:
    of = _get(cfg, "basic", "simulation", "output_fields", default={}) or {}
    out_fields = OutputFields(
        density=_get(of, "density", default=True),
        velocity=_get(of, "velocity", default=True),
        velocity_magnitude=_get(of, "velocity_magnitude", default=True),
        vorticity=_get(of, "vorticity", default=True),
        obstacle=_get(of, "obstacle", default=True),
        level=_get(of, "level", default=True),
        bouzidi=_get(of, "bouzidi", default=True),
    )
    mc = _get(cfg, "advanced", "forces", "moment_center", default=[0.25, 0.0, 0.0])
    return CaseConfig(
        case_dir=case_dir,
        stl_file=_get(cfg, "basic", "stl_file", required=True),
        stl_scale=float(_get(cfg, "basic", "stl_scale", required=True)),
        surface_resolution=int(_get(cfg, "basic", "surface_resolution", required=True)),
        num_levels=int(_get(cfg, "basic", "num_levels", required=True)),
        reference_area_full_model=float(
            _get(cfg, "basic", "reference_area_of_full_model", default=0.0)
        ),
        reference_chord=float(_get(cfg, "basic", "reference_chord", default=0.0)),
        reference_length_for_meshing=float(
            _get(cfg, "basic", "reference_length_for_meshing", default=0.0)
        ),
        reference_dimension=str(_get(cfg, "basic", "reference_dimension", default="x")),
        fluid_density=float(_get(cfg, "basic", "fluid", "density", default=1.225)),
        fluid_kinematic_viscosity=float(
            _get(cfg, "basic", "fluid", "kinematic_viscosity", default=1.5e-5)
        ),
        flow_velocity=float(_get(cfg, "basic", "flow", "velocity", default=10.0)),
        steps=int(_get(cfg, "basic", "simulation", "steps", required=True)),
        ramp_steps=int(_get(cfg, "basic", "simulation", "ramp_steps", required=True)),
        output_freq=int(_get(cfg, "basic", "simulation", "output_freq", required=True)),
        output_dir=str(_get(cfg, "basic", "simulation", "output_dir", default="RESULTS")),
        output_fields=out_fields,
        u_lattice=float(_get(cfg, "advanced", "numerics", "u_lattice", default=0.01)),
        c_wale=float(_get(cfg, "advanced", "numerics", "c_wale", default=0.20)),
        tau_min=float(_get(cfg, "advanced", "numerics", "tau_min", default=0.505)),
        tau_safety_factor=float(
            _get(cfg, "advanced", "numerics", "tau_safety_factor", default=1.0)
        ),
        inlet_turbulence_intensity=float(
            _get(cfg, "advanced", "numerics", "inlet_turbulence_intensity", default=0.01)
        ),
        nu_sgs_background=float(
            _get(cfg, "advanced", "numerics", "nu_sgs_background", default=0.0005)
        ),
        sponge_blend_distributions=bool(
            _get(cfg, "advanced", "numerics", "sponge_blend_distributions", default=True)
        ),
        temporal_interpolation=bool(
            _get(cfg, "advanced", "numerics", "temporal_interpolation", default=True)
        ),
        auto_levels=bool(_get(cfg, "advanced", "high_re", "auto_levels", default=False)),
        max_levels=int(_get(cfg, "advanced", "high_re", "max_levels", default=12)),
        min_coarse_blocks=int(
            _get(cfg, "advanced", "high_re", "min_coarse_blocks", default=4)
        ),
        wall_model_enabled=bool(
            _get(cfg, "advanced", "high_re", "wall_model", "enabled", default=False)
        ),
        wall_model_type=str(
            _get(cfg, "advanced", "high_re", "wall_model", "type", default="equilibrium")
        ),
        wall_model_yplus_target=float(
            _get(cfg, "advanced", "high_re", "wall_model", "y_plus_target", default=30.0)
        ),
        domain_upstream=float(_get(cfg, "advanced", "domain", "upstream", default=0.75)),
        domain_downstream=float(
            _get(cfg, "advanced", "domain", "downstream", default=1.5)
        ),
        domain_lateral=float(_get(cfg, "advanced", "domain", "lateral", default=0.75)),
        domain_height=float(_get(cfg, "advanced", "domain", "height", default=0.75)),
        sponge_thickness=float(
            _get(cfg, "advanced", "domain", "sponge_thickness", default=0.10)
        ),
        block_size=int(_get(cfg, "advanced", "refinement", "block_size", default=8)),
        refinement_margin=int(_get(cfg, "advanced", "refinement", "margin", default=2)),
        refinement_strategy=str(
            _get(cfg, "advanced", "refinement", "strategy", default="geometry_first")
        ),
        symmetric_analysis=bool(
            _get(cfg, "advanced", "refinement", "symmetric_analysis", default=False)
        ),
        wake_enabled=bool(_get(cfg, "advanced", "refinement", "wake_enabled", default=False)),
        wake_length=float(_get(cfg, "advanced", "refinement", "wake_length", default=0.25)),
        wake_width_factor=float(
            _get(cfg, "advanced", "refinement", "wake_width_factor", default=0.1)
        ),
        wake_height_factor=float(
            _get(cfg, "advanced", "refinement", "wake_height_factor", default=0.1)
        ),
        boundary_method=str(_get(cfg, "advanced", "boundary", "method", default="bouzidi")),
        bouzidi_levels=int(_get(cfg, "advanced", "boundary", "bouzidi_levels", default=1)),
        q_min_threshold=float(
            _get(cfg, "advanced", "boundary", "q_min_threshold", default=0.001)
        ),
        forces_enabled=bool(_get(cfg, "advanced", "forces", "enabled", default=True)),
        force_output_freq=int(_get(cfg, "advanced", "forces", "output_freq", default=0)),
        force_extrapolate=bool(_get(cfg, "advanced", "forces", "extrapolate", default=False)),
        force_method=str(_get(cfg, "advanced", "forces", "method", default="stress")),
        moment_center=tuple(float(v) for v in mc),
        diag_freq=int(_get(cfg, "advanced", "diagnostics", "freq", default=500)),
        stability_check=bool(
            _get(cfg, "advanced", "diagnostics", "stability_check", default=True)
        ),
        stability_action=str(
            _get(cfg, "advanced", "diagnostics", "stability_action", default="warn")
        ),
        print_tau_warning=bool(
            _get(cfg, "advanced", "diagnostics", "print_tau_warning", default=True)
        ),
        async_depth=int(_get(cfg, "advanced", "gpu", "async_depth", default=8)),
        checkpoint_freq=int(_get(cfg, "advanced", "checkpoint", "freq", default=0)),
        checkpoint_resume=bool(_get(cfg, "advanced", "checkpoint", "resume", default=False)),
        precision=str(_get(cfg, "advanced", "numerics", "precision", default="float32")),
        layout=str(_get(cfg, "advanced", "engine", "layout", default="patch")),
        devices=int(_get(cfg, "advanced", "engine", "devices", default=1)),
        flat_coarse=str(
            _get(cfg, "advanced", "engine", "flat_coarse", default="auto")
        ),
        domain_tile_snap=bool(
            _get(cfg, "advanced", "engine", "domain_tile_snap", default=False)
        ),
    )


def load_batch_list(path: str) -> List[str]:
    """Read the root cases_to_run.yaml batch list (reference: main.jl:251-257)."""
    with open(path) as f:
        cfg = yaml.safe_load(f)
    return list(cfg["case_folders"])
