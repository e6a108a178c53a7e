"""The plain reference of a case: its levels rebuilt from the case's files,
its coarse step in plain PyTorch, its forces and flow statistics.

Everything the port's set-up derives is worked out again here with the
frozen copies in `olt/` (copied from open_ludwig_torch at commit 8d8a57a):
the mesh and the domain (`geometry`, `scaling`), the levels with their
obstacle, sponge, wall distance and Bouzidi q (`core/patch.build_patches`),
the Bouzidi box coefficients (`ops/dense_step.build_bouzidi_dense_plan`)
and the map of each surface triangle to its fluid cells
(`ops/forces.build_triangle_cell_map_dense`).  Nothing is read from the
program.

The coarse step is the schedule of the port's `solver_dense.
make_coarse_step_dense` at that commit, unfused: level l runs 2^(l-1)
sub-steps per coarse step, each parent sub-step followed by its child's
two sub-steps with ghost planes at temporal weights 0 and 0.5 between the
parent's state before and after it.  Every level takes the general plain
step (`dense_stream_collide`, whatever kernel the card's rule gives the
level in the program), then on a Bouzidi level the box sweep
(`apply_bouzidi_dense`, not the link list K2 runs over), all in float32
with the state stored in the level's storage type.  The ghost planes take
the endpoint path (`interface_endpoints_pair`, `interface_from_endpoints`,
`shift_planes`: slices, upsampling and the f_neq rescale written out
plane by plane), not the program's matrix-product path
(`build_iface_mm_plan`, `interface_planes_pair_mm`), which is what the
Re10M cells time.

The forces (`plain_forces`) and the flow statistics (`plain_flow_stats`)
are written out here in float64, triangle by triangle and over the fluid
cells, not through the program's batched float32 evaluation.

The levels of a case are kept in `build/lbm_bench_ref/` of the checkout,
under a name made from the case's files and these sources, so a later run
of the case loads them instead of building them again.
"""

from __future__ import annotations

import glob
import hashlib
import math
import os
import pickle
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from .olt.config import load_case_config
from .olt.core.patch import build_patches
from .olt.geometry import load_mesh
from .olt.ops.dense_step import (
    apply_bouzidi_dense,
    bouzidi_plan_to,
    build_bouzidi_dense_plan,
    dense_stream_collide,
    interface_endpoints_pair,
    interface_from_endpoints,
    shift_planes,
)
from .olt.ops.forces import build_triangle_cell_map_dense
from .olt.ops.storage import STORE_BF16, decode_f, encode_f, f_dtype
from .olt.scaling import compute_domain_params

_HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(_HERE, os.pardir, os.pardir))
CACHE_DIR = os.path.join(ROOT, "build", "lbm_bench_ref")


def ramp_velocity(t: int, u_target: float, ramp_steps: int) -> float:
    """The inlet's cosine start-up ramp in float32 (a frozen copy of
    open_ludwig_torch/solver.py:ramp_velocity at commit 8d8a57a)."""
    t_f = np.float32(t)
    if t_f <= ramp_steps:
        prog = np.float32(0.5) * (
            np.float32(1.0)
            - np.cos(np.float32(np.pi) * t_f / np.float32(max(ramp_steps, 1))))
    else:
        prog = np.float32(1.0)
    return float(np.float32(u_target) * prog)


def _levels_key(case_dir: str, cfg) -> str:
    digest = hashlib.sha256()
    for path in [os.path.join(case_dir, "config.yaml"), cfg.stl_path] + sorted(
            glob.glob(os.path.join(_HERE, "olt", "**", "*.*"), recursive=True)):
        if path.endswith((".py", ".cpp", ".yaml", ".stl", ".STL")):
            with open(path, "rb") as fh:
                digest.update(fh.read())
    return digest.hexdigest()[:24]


def build_levels(case_dir: str, cfg, mesh, params, cache: bool = True):
    """The case's levels (`build_patches`), from the cache where a run of
    the same files has built them."""
    path = os.path.join(CACHE_DIR, os.path.basename(os.path.normpath(case_dir))
                        + "-" + _levels_key(case_dir, cfg) + ".pkl")
    if cache and os.path.isfile(path):
        with open(path, "rb") as fh:
            return pickle.load(fh)
    levels = build_patches(cfg, mesh, params)
    if cache:
        os.makedirs(CACHE_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as fh:
            pickle.dump(levels, fh, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    return levels


class Reference:
    """A case's reference on `device` (see the module's docstring)."""

    def __init__(self, case_dir: str, device, cache: bool = True):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.cfg = cfg = load_case_config(case_dir)
        self.mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
        self.params = compute_domain_params(cfg, self.mesh.min_bounds,
                                            self.mesh.max_bounds)
        self.levels = build_levels(case_dir, cfg, self.mesh, self.params, cache)
        self.store_bf16 = f_dtype(cfg.precision) == torch.bfloat16
        dev = self.device
        self.statics = [{
            "obstacle": torch.as_tensor(p.obstacle, dtype=torch.bool, device=dev),
            "sponge": torch.as_tensor(p.sponge, dtype=torch.float32, device=dev),
            "wall_dist": torch.as_tensor(p.wall_dist, dtype=torch.float32, device=dev),
            "bouzidi": bouzidi_plan_to(build_bouzidi_dense_plan(p, cfg.q_min_threshold),
                                       dev),
        } for p in self.levels]
        self.kw = dict(c_wale=cfg.c_wale, nu_sgs_background=cfg.nu_sgs_background,
                       inlet_turbulence=cfg.inlet_turbulence_intensity,
                       wall_model=cfg.wall_model_enabled,
                       sponge_blend=cfg.sponge_blend_distributions)
        self._force_map = None

    @property
    def obstacles(self) -> List[torch.Tensor]:
        return [st["obstacle"] for st in self.statics]

    def level_step(self, st: Dict, lvl: int, u: float, seed: int, iface) -> Dict:
        """One sub-step of level `lvl`: the plain step, then Bouzidi, each
        stored in the level's storage type."""
        fo, rho, vo = dense_stream_collide(
            decode_f(st["f"]), st["vel"], u, seed, self.statics[lvl], self.levels[lvl],
            iface=iface, **self.kw)
        if self.store_bf16:
            fo = encode_f(fo, STORE_BF16)
        plan = self.statics[lvl]["bouzidi"]
        if plan is not None:
            fo = apply_bouzidi_dense(fo, plan)
        return {"f": fo, "rho": rho, "vel": vo}

    def ghost_planes(self, lvl: int, before: Dict, after: Dict) -> List[Dict]:
        """Level lvl + 1's ghost planes for its two sub-steps under level
        lvl's step from `before` to `after`: at temporal weights 0 and 0.5
        (both from `after` without temporal interpolation), in the child's
        storage type."""
        child, parent = self.levels[lvl + 1], self.levels[lvl]
        temporal = self.cfg.temporal_interpolation
        ep_old, ep_new = interface_endpoints_pair(child, parent, before, after)
        c_dtype = f_dtype(self.cfg.precision)
        return [shift_planes(interface_from_endpoints(ep_new, ep_old, child, parent, tw,
                                                      temporal),
                             child, c_dtype == torch.bfloat16, c_dtype)
                for tw in (0.0, 0.5)]

    def coarse_step(self, states: List[Dict], t: int) -> List[Dict]:
        """Coarse step t of every level; `states` hold f (storage type), rho
        and vel."""
        states = list(states)
        n = len(self.levels)
        u = ramp_velocity(t, self.cfg.u_lattice, self.cfg.ramp_steps)

        def visit(lvl: int, k: int, iface) -> None:
            before = states[lvl]
            states[lvl] = self.level_step(before, lvl, u, ((t << lvl) + k) % 1000000,
                                          iface)
            if lvl + 1 == n:
                return
            planes = self.ghost_planes(lvl, before, states[lvl])
            del before
            visit(lvl + 1, 2 * k, planes[0])
            visit(lvl + 1, 2 * k + 1, planes[1])

        visit(0, 0, None)
        return states

    def steps(self, states: List[Dict], t0: int, n: int) -> List[Dict]:
        """Coarse steps t0 .. t0 + n - 1 from `states` ({f, vel} at least)."""
        states = [{"f": st["f"], "rho": st.get("rho"), "vel": st["vel"]} for st in states]
        for t in range(t0, t0 + n):
            states = self.coarse_step(states, t)
        return states

    def force_map(self) -> Dict[str, np.ndarray]:
        """Each surface triangle's fluid cells on the finest level (the
        host build's map), built once."""
        if self._force_map is None:
            self._force_map = build_triangle_cell_map_dense(self.mesh, self.levels[-1],
                                                            self.params)
        return self._force_map

    def forces(self, finest: Dict):
        """The stress-mapped coefficients of the finest level's state
        (`plain_forces`)."""
        return plain_forces(finest, self.force_map(), self.mesh, self.params,
                            float(self.levels[-1].tau), bool(self.cfg.force_extrapolate))

    def flow_stats(self, coarsest: Dict):
        """The flow statistics of the coarsest level's state
        (`plain_flow_stats`)."""
        return plain_flow_stats(coarsest, self.statics[0]["obstacle"])


def plain_forces(finest: Dict, tri_map: Dict[str, np.ndarray], mesh, params, tau: float,
                 extrapolate: bool) -> SimpleNamespace:
    """Cd, Cl and Cs of the finest level's state by surface-stress mapping,
    one triangle at a time in float64 (reference: src/forces/surface.jl:
    282-366, :517-526): at the triangle's mapped cell the pressure
    p = (rho - 1) / 3 (extrapolated to the wall along the normal from a
    second cell where the case asks for it) and the shear stress
    rho nu |u_t| / d along the tangential velocity u_t, both scaled by
    rho_phys velocity_scale^2; the force -p n A + tau A summed over the
    mapped triangles, doubled in x and z and zeroed in y for a half
    model, over q_inf A_ref."""
    cells = np.concatenate([tri_map["cell_idx"], tri_map["cell_idx2"]]).astype(np.int64)
    idx = torch.as_tensor(cells, device=finest["rho"].device)
    rho_at = finest["rho"].reshape(-1)[idx].double().cpu().numpy()
    vel_at = finest["vel"].reshape(3, -1)[:, idx].double().cpu().numpy()
    n_tri = len(tri_map["cell_idx"])
    scale = float(params.rho_physical) * float(params.velocity_scale) ** 2
    nu_lat = (tau - 0.5) / 3.0
    force = np.zeros(3)
    for i in range(n_tri):
        if not tri_map["found"][i]:
            continue
        rho = rho_at[i]
        p = (rho - 1.0) / 3.0 * scale
        if extrapolate and tri_map["found2"][i]:
            p2 = (rho_at[n_tri + i] - 1.0) / 3.0 * scale
            d1, d2 = float(tri_map["dn1"][i]), float(tri_map["dn2"][i])
            p += (p - p2) * min(max(d1 / max(d2 - d1, 0.25), 0.0), 2.0)
        n = mesh.normals[i]
        u = vel_at[:, i]
        u_t = u - np.dot(u, n) * n
        u_t_mag = math.sqrt(float(np.dot(u_t, u_t)))
        dist = float(tri_map["wall_dist"][i])
        shear = np.zeros(3)
        if u_t_mag > 1e-10 and dist > 0.01:
            shear = u_t / u_t_mag * (rho * nu_lat * u_t_mag / dist * scale)
        force += (-p * n + shear) * mesh.areas[i]
    if params.symmetric:
        force = np.array([2.0 * force[0], 0.0, 2.0 * force[2]])
    f_ref = 0.5 * params.rho_physical * params.u_physical ** 2 * params.reference_area
    if f_ref <= 1e-10:
        return SimpleNamespace(Cd=0.0, Cl=0.0, Cs=0.0)
    return SimpleNamespace(Cd=force[0] / f_ref, Cl=force[2] / f_ref, Cs=force[1] / f_ref)


def plain_flow_stats(state: Dict, obstacle: torch.Tensor) -> SimpleNamespace:
    """The flow statistics of one level over its fluid cells, in float64:
    their count, the mean, least and largest rho, the largest |u| and the
    kinetic energy 0.5 sum(rho |u|^2) (reference: src/diagnostics.jl:56-125)."""
    fluid = ~obstacle
    rho = state["rho"][fluid].double()
    v2 = (state["vel"][:, fluid].double() ** 2).sum(dim=0)
    return SimpleNamespace(
        n_fluid=int(rho.numel()), rho_mean=float(rho.mean()), rho_min=float(rho.min()),
        rho_max=float(rho.max()), v_max=math.sqrt(float(v2.max())),
        kinetic_energy=0.5 * float((rho * v2).sum()))
