"""CSV time histories with the JAX runner's (and the reference's) schemas
(convergence.csv: reference main.jl:82; forces.csv: reference
forces/io.jl:91) and the per-triangle surface-load table
(`export_surface_loads_csv`).  Port of `open_ludwig_tpu/io/csv_out.py`,
whose ForceResult import reaches jax."""

from __future__ import annotations

import time

import numpy as np

from ..ops.forces import ForceResult

CONVERGENCE_HEADER = "Step,Walltime,Time_phys_s,U_inlet_lat,Rho_min,MLUPS,Cd,Cl"
FORCES_HEADER = (
    "Step,Time_s,U_inlet,Fx_N,Fy_N,Fz_N,Fx_p_N,Fx_v_N,Mx_Nm,My_Nm,Mz_Nm,Cd,Cl,Cs,Cmy"
)


def walltime_str(start_time: float) -> str:
    e = time.time() - start_time
    return f"{int(e // 3600):02d}:{int((e % 3600) // 60):02d}:{e % 60:05.2f}"


def write_convergence_header(path: str) -> None:
    with open(path, "w") as f:
        f.write(CONVERGENCE_HEADER + "\n")


def append_convergence(
    path: str, step: int, wall: str, t_phys: float, u_lat: float, rho_min: float,
    mlups: float, cd: str, cl: str,
) -> None:
    with open(path, "a") as f:
        f.write(f"{step},{wall},{t_phys},{u_lat},{rho_min},{mlups},{cd},{cl}\n")


def write_forces_header(path: str) -> None:
    with open(path, "w") as f:
        f.write(FORCES_HEADER + "\n")


def append_forces(
    path: str, step: int, t_phys: float, fr: ForceResult, u_inlet: float
) -> None:
    with open(path, "a") as f:
        f.write(
            f"{step},{t_phys:.6e},{u_inlet:.6f},"
            f"{fr.Fx:.6e},{fr.Fy:.6e},{fr.Fz:.6e},"
            f"{fr.Fx_pressure:.6e},{fr.Fx_viscous:.6e},"
            f"{fr.Mx:.6e},{fr.My:.6e},{fr.Mz:.6e},"
            f"{fr.Cd:.6f},{fr.Cl:.6f},{fr.Cs:.6f},{fr.Cmy:.6f}\n"
        )


def print_force_summary(fr: ForceResult, rho_ref, u_ref, area_ref, chord_ref) -> str:
    q_inf = 0.5 * rho_ref * u_ref**2
    lines = [
        "=" * 60,
        "         AERODYNAMIC FORCES SUMMARY",
        "=" * 60,
        f"  rho_ref = {rho_ref:.4f} kg/m^3 | U_ref = {u_ref:.4f} m/s",
        f"  A_ref = {area_ref:.4f} m^2 | L_ref = {chord_ref:.4f} m | q_inf = {q_inf:.4f} Pa",
        f"  Fx (drag) = {fr.Fx:+.4e}  (p: {fr.Fx_pressure:+.4e}, v: {fr.Fx_viscous:+.4e})",
        f"  Fy (side) = {fr.Fy:+.4e}",
        f"  Fz (lift) = {fr.Fz:+.4e}",
        f"  Mx = {fr.Mx:+.4e} | My = {fr.My:+.4e} | Mz = {fr.Mz:+.4e}",
        f"  Cd = {fr.Cd:+.6f} | Cl = {fr.Cl:+.6f} | Cs = {fr.Cs:+.6f} | Cmy = {fr.Cmy:+.6f}",
        "=" * 60,
    ]
    return "\n".join(lines)


def export_surface_loads_csv(
    path: str, centers, normals, areas, pressure, shear, mesh_offset
) -> None:
    """Per-triangle surface loads for external FEA tools
    (reference: src/forces/io.jl:167-190; same column schema)."""
    c = np.asarray(centers) + np.asarray(mesh_offset)[None, :]
    n = np.asarray(normals)
    with open(path, "w") as f:
        f.write(
            "triangle_id,cx,cy,cz,nx,ny,nz,area_m2,pressure_Pa,"
            "shear_x_Pa,shear_y_Pa,shear_z_Pa\n"
        )
        for i in range(len(areas)):
            f.write(
                f"{i + 1},{c[i,0]:.6e},{c[i,1]:.6e},{c[i,2]:.6e},"
                f"{n[i,0]:.6f},{n[i,1]:.6f},{n[i,2]:.6f},{areas[i]:.6e},"
                f"{pressure[i]:.6e},{shear[0,i]:.6e},{shear[1,i]:.6e},"
                f"{shear[2,i]:.6e}\n"
            )
