"""One run of one cell: set-up, the measured window, the trace, the check.

Set-up (host clock from the process's start, `setup_s`): the program's host
build (`host_build_s`: the case's config, mesh and domain, the levels by
`core.patch.build_patches`, `solver_dense.build_patch_statics` with the
card's kernel choice, and the force context where the traffic evaluates
forces), the batch runner `solver_dense.make_batch_runner_dense` at its
defaults (unfused, each coarse step a CUDA graph replay), the warm start
from the seed (`warm`), calls of the traffic's length from it until a call
launches nothing from the host (`work.warm_up`: every graph captured) and
one evaluation of each event the traffic has; then the warm start of the
seed again, handed to the runner for a call of `check_steps` coarse steps
that replays the window's graphs (kept for `start_gap`), from whose end
the window goes on.

The window: calls of the runner, queued with no host sync but the events'
and one that keeps at most two calls queued ahead of the card (a wait on
the end of the call before last, which leaves the card busy), until
`--seconds` have passed after a call; then `torch.cuda.synchronize`.  An
event (forces: `ops.forces.compute_aerodynamics` on the finest level;
flow statistics: `diagnostics.compute_flow_stats` on level 1) comes after
the call whose steps complete its period; it waits for the card to drain
the calls before it, as the event's own read-back would, and its time
(`event_ms`) runs from there to its values on the host.  A force sample's
interval (`sample_p95_ms`) runs from the previous sample's values on the
host (the window's start for the first) to its own.  The window launches
exactly the port's kernels its coarse steps need (`work.batch_launches`)
and captures none, or the run fails.

With `--trace 1` the first `trace_calls` calls of the window and their
events run under `torch.profiler`, then the card is synchronised and the
profiler stopped; the rest of the window runs untraced, and `event_ms`
counts only the untraced events.

The check (`compare`) comes once the window has closed and the memory peak
(`torch.cuda.max_memory_reserved` over set-up and window) has been read:
`check_steps` more coarse steps of the runner from the window's end state,
the program's events on their result, the program freed, then the plain
reference (`reference.model.Reference`), which rebuilds the case from its
files and follows the same steps from the same states.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import logging
import math
import os
import re
import subprocess
import sys
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from . import compare, trace as tr, warm, work

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")
FORBIDDEN = ("jax", "jaxlib", "flax", "open_ludwig_tpu")


@dataclasses.dataclass
class RunRecord:
    """What a run measured, for the metric readers (`metrics/<name>.py`)."""
    device_name: str
    setup_s: float
    host_build_s: float
    window_s: float
    coarse_steps: int  # coarse steps the window completed
    updates_per_coarse: int  # site updates a coarse step: cells x 2^(l-1)
    peak_reserved_bytes: Optional[int]
    sample_ms: List[float]  # each force sample's interval
    event_ms: List[float]  # each untraced event's host time
    levels: List[Dict]  # per level: interior, face_bc, sub_steps a coarse step
    store_bf16: bool
    wall_model: bool
    kernels: Dict[str, "re.Pattern"]  # role -> the port's kernels' names
    trace: Optional[tr.Trace] = None


def load_spec(path: str = BENCHMARK) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def _by_name(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_files(spec: Dict, workload: str) -> Dict:
    """The cell's entry, its configuration's folder, traffic and limits, and
    the metrics it reports with and without a trace, found by name."""
    cell = _by_name(spec["workloads"], workload, "workload")
    config = _by_name(spec["configs"], cell["config"], "config")
    case_dir = os.path.join(ROOT, os.path.dirname(config["file"]))
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    with open(os.path.join(case_dir, "limits.json")) as fh:
        limits = json.load(fh)

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return {"cell": cell, "case_dir": case_dir, "traffic": traffic, "limits": limits,
            "end_to_end": mine(spec["end_to_end"]), "per_layer": mine(spec["per_layer"])}


def reader(name: str):
    """The `read` function of `metrics/<name>.py`."""
    path = os.path.join(HERE, "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "lbm_bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def kernel_patterns() -> Dict[str, "re.Pattern"]:
    with open(os.path.join(HERE, "metrics", "kernels.json")) as fh:
        return {role: re.compile(rx) for role, rx in json.load(fh).items()}


def call_steps(traffic: Dict, updates_per_coarse: int) -> int:
    """Coarse steps a runner call takes: the traffic's `call_steps`, or
    clip(round(call_updates / site updates a coarse step), min, max)."""
    if "call_steps" in traffic:
        return int(traffic["call_steps"])
    n = round(float(traffic["call_updates"]) / updates_per_coarse)
    return int(np.clip(n, traffic["call_steps_min"], traffic["call_steps_max"]))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the port must never load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Program:
    """The system under test, built for a case and a traffic mix: the
    program's host build and statics (`host_build_s`), the force context
    where the traffic evaluates forces, and the batch runner at its
    defaults.  `precision` overrides the case's storage (the control's
    lower precision)."""

    def __init__(self, case_dir: str, traffic: Dict, device, precision=None, say=None):
        from open_ludwig_torch import diagnostics, solver_dense
        from open_ludwig_torch.config import load_case_config
        from open_ludwig_torch.core.patch import build_patches
        from open_ludwig_torch.geometry import load_mesh
        from open_ludwig_torch.ops import cuda_step, forces
        from open_ludwig_torch.ops.storage import f_dtype
        from open_ludwig_torch.scaling import compute_domain_params

        self.say = say or (lambda msg: print(msg, file=sys.stderr, flush=True))
        self.diagnostics, self.forces_mod, self.cuda_step = diagnostics, forces, cuda_step
        self.dev = dev = torch.device(device)
        self.cuda = dev.type == "cuda"
        self.traffic = traffic
        self.forces_every = int(traffic.get("forces_every", 0))
        self.stats_every = int(traffic.get("stats_every", 0))
        self.check_steps = int(traffic["check_steps"])

        t_build = time.time()
        cfg = load_case_config(case_dir)
        if precision is not None:
            cfg = cfg.with_overrides(precision=precision)
        mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
        params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
        self.levels = levels = build_patches(cfg, mesh, params)
        self.statics = solver_dense.build_patch_statics(cfg, levels, dev)
        self.ctx = (forces.make_force_context_dense(mesh, levels[-1], params,
                                                    extrapolate=cfg.force_extrapolate,
                                                    device=dev)
                    if self.forces_every else None)
        _sync(dev)
        self.host_build_s = time.time() - t_build
        self.cfg = cfg
        self.run = solver_dense.make_batch_runner_dense(cfg, params, levels, self.statics)
        self.store_bf16 = f_dtype(cfg.precision) == torch.bfloat16
        self.updates = sum(p.n_cells * 2 ** (p.level_id - 1) for p in levels)
        self.n_call = call_steps(traffic, self.updates)
        for every in (self.forces_every, self.stats_every):
            if every % self.n_call:
                raise ValueError(f"an event every {every} coarse steps, calls of "
                                 f"{self.n_call}")
        self.engines = [st["engine"] for st in self.statics]
        self.t0 = int(cfg.ramp_steps) + 1  # past the ramp: the inlet at full speed
        self.say(f"[lbm_bench] {os.path.basename(os.path.normpath(case_dir))}: "
                 + ", ".join(f"{'x'.join(map(str, p.interior))} on {e}"
                             for p, e in zip(levels, self.engines))
                 + f"; {self.updates} site updates a coarse step, calls of "
                 f"{self.n_call}; host build {self.host_build_s:.1f} s")

    def warm(self, seed: int, into: Optional[List[Dict]] = None) -> List[Dict]:
        """The warm start of `seed` (module `warm`) in the program's storage,
        written into the levels' tensors of `into` where given."""
        t = self.traffic
        return warm.warm_states([st["obstacle"] for st in self.statics],
                                float(self.cfg.u_lattice), self.store_bf16, seed,
                                float(t["perturb_rho"]), float(t["perturb_u"]), into)

    def start(self, seed: int, states: Optional[List[Dict]] = None):
        """A call of `check_steps` coarse steps from the warm start of `seed`:
        (states, the next t, the states copied to the host).  Given the
        runner's last `states` (after `warm_up`), the warm start is written
        into them, so the call replays the window's graphs on the runner's
        own buffers and takes no more memory than the window."""
        into = None
        if states is not None:
            into = [{k: st[k] for k in ("f", "rho", "vel")} for st in states]
        states = self.run(self.warm(seed, into), self.t0, self.check_steps)
        return states, self.t0 + self.check_steps, compare.host_copy(states)

    def warm_up(self, states, t):
        """Calls until one launches nothing from the host, then each event
        once: (states, t, the calls made)."""
        box = {"states": states, "t": t}

        def one_call():
            box["states"] = self.run(box["states"], box["t"], self.n_call)
            box["t"] += self.n_call

        calls = work.warm_up(one_call, lambda: sum(self.cuda_step.LAUNCHES.values()))
        self.events(box["states"], True, True)
        _sync(self.dev)
        return box["states"], box["t"], calls

    def events(self, states, do_forces: bool, do_stats: bool):
        """The traffic's events that are due: (forces, flow statistics), each
        None where not due or not in the traffic."""
        res = stats = None
        if do_forces and self.forces_every:
            res = self.forces_mod.compute_aerodynamics(states[-1], self.ctx)
        if do_stats and self.stats_every:
            stats = self.diagnostics.compute_flow_stats(states[0],
                                                        self.statics[0]["obstacle"])
        return res, stats

    def window(self, states, t, seconds: float, trace_calls: int = 0, min_calls: int = 1):
        """The measured window (module docstring) from `states` at coarse
        step t; the profiler over the first `trace_calls` calls."""
        cs, dev = self.cuda_step, self.dev
        prof = None
        if trace_calls:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        captured0 = sum(cs.CAPTURED.values())
        executed0 = cs.executed_launches()
        w = {"calls": 0, "steps": 0, "samples": [], "event_ms": [], "prof": prof,
             "traced_steps": 0, "traced_launches": 0}
        inflight = deque()
        t_start = time.perf_counter()
        last_sample = t_start
        while True:
            traced = w["calls"] < trace_calls
            with tr.span("call", traced):
                states = self.run(states, t, self.n_call)
            t += self.n_call
            w["steps"] += self.n_call
            w["calls"] += 1
            if self.cuda:
                done = torch.cuda.Event()
                done.record()
                inflight.append(done)
            do_f = bool(self.forces_every) and w["steps"] % self.forces_every == 0
            do_s = bool(self.stats_every) and w["steps"] % self.stats_every == 0
            if do_f or do_s:
                with tr.span("drain", traced):
                    _sync(dev)
                inflight.clear()
                e0 = time.perf_counter()
                with tr.span("event", traced):
                    res, stats = self.events(states, do_f, do_s)
                now = time.perf_counter()
                if res is not None:
                    w["samples"].append((now - last_sample) * 1e3)
                    last_sample = now
                    if not all(math.isfinite(v) for v in (res.Cd, res.Cl, res.Cs)):
                        raise RuntimeError(f"forces not finite at coarse step {t - 1}")
                if stats is not None and not (math.isfinite(stats.rho_min)
                                              and 0.5 < stats.rho_min
                                              and stats.rho_max < 1.5):
                    raise RuntimeError(f"level 1 left rho in (0.5, 1.5) at coarse "
                                       f"step {t - 1}: {stats}")
                if not traced:
                    w["event_ms"].append((now - e0) * 1e3)
            while len(inflight) > 2:
                with tr.span("wait", traced):
                    inflight.popleft().synchronize()
            if prof is not None and w["calls"] == trace_calls:
                _sync(dev)
                prof.stop()
                now_l = cs.executed_launches()
                w["traced_launches"] = sum(now_l[k] - executed0[k] for k in now_l)
                w["traced_steps"] = w["steps"]
            if (time.perf_counter() - t_start >= seconds
                    and w["calls"] >= max(trace_calls, min_calls)):
                break
        _sync(dev)
        w["window_s"] = time.perf_counter() - t_start
        if sum(cs.CAPTURED.values()) != captured0:
            raise RuntimeError("kernel launches were captured inside the window")
        if self.cuda:
            now_l = cs.executed_launches()
            got = {k: v - executed0[k] for k, v in now_l.items() if v != executed0[k]}
            want = {k: v * w["calls"] for k, v in work.batch_launches(
                self.engines, [st["bouzidi"] is not None for st in self.statics],
                self.n_call).items()}
            if got != want:
                raise RuntimeError(f"the window executed {got}, its coarse steps "
                                   f"need {want}")
        return states, t, w

    def finish(self, states, t):
        """`check_steps` more coarse steps from the window's end state and the
        traffic's events on their result: (the end state and the result,
        both copied to the host, forces, flow statistics)."""
        end_in = compare.host_copy(states)
        states = self.run(states, t, self.check_steps)
        res, stats = self.events(states, True, True)
        return end_in, compare.host_copy(states), res, stats


def free_device(dev) -> None:
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def run_case(case_dir: str, traffic: Dict, limits: Dict, seed: int, seconds: float,
             trace: bool, device, t_process: float, say=None) -> Dict:
    """Set-up, window, trace and check of `case_dir` under `traffic` (module
    docstring).  Returns {"record": RunRecord, "checks": compare.judge(...)}."""
    prog = Program(case_dir, traffic, device, say=say)
    dev, say = prog.dev, prog.say
    states, _, warmups = prog.warm_up(prog.warm(seed), prog.t0)
    states, t, prog_start = prog.start(seed, states)
    t_start_check = prog.t0
    setup_s = time.time() - t_process

    trace_calls = int(traffic.get("trace_calls", 1)) if trace else 0
    states, t, w = prog.window(states, t, seconds, trace_calls)
    peak = torch.cuda.max_memory_reserved(dev) if prog.cuda else None
    say(f"[lbm_bench] window: {w['calls']} calls, {w['steps']} coarse steps in "
             f"{w['window_s']:.3f} s (set-up {setup_s:.1f} s, {warmups} warm-up calls)")
    kernels = kernel_patterns()
    trace_rec = None
    if w["prof"] is not None:
        any_port = re.compile("|".join(p.pattern for p in kernels.values()))
        t_read = time.time()
        trace_rec = tr.read(w["prof"], w["traced_steps"], w["traced_launches"], any_port)
        say(f"[lbm_bench] trace of {trace_calls} calls read in "
                 f"{time.time() - t_read:.1f} s"
                 + ("" if trace_rec else "; incomplete, nothing read from it"))
        w["prof"] = None
    record = RunRecord(
        device_name=torch.cuda.get_device_name(dev) if prog.cuda else "cpu",
        setup_s=setup_s, host_build_s=prog.host_build_s, window_s=w["window_s"],
        coarse_steps=w["steps"], updates_per_coarse=prog.updates,
        peak_reserved_bytes=peak, sample_ms=w["samples"], event_ms=w["event_ms"],
        levels=[{"interior": tuple(p.interior), "face_bc": tuple(p.face_bc),
                 "sub_steps": 2 ** (p.level_id - 1)} for p in prog.levels],
        store_bf16=prog.store_bf16, wall_model=bool(prog.cfg.wall_model_enabled),
        kernels=kernels, trace=trace_rec)

    t_check = time.time()
    end_in, prog_end, res, stats = prog.finish(states, t)
    del prog, states
    free_device(dev)
    checks = reference_check(case_dir, dev, seed, traffic, t_start_check, t,
                             prog_start, end_in, prog_end, res, stats, limits)
    say(f"[lbm_bench] check: {time.time() - t_check:.1f} s")
    return {"record": record, "checks": checks}


def reference_states(ref, seed: int, traffic: Dict, t_start: int, t_end: int,
                     end_in) -> Dict:
    """The reference's side of the check: `check_steps` coarse steps from
    the warm start of `seed` at t_start and from the window's end state
    `end_in` at t_end, with its events on the latter."""
    n = int(traffic["check_steps"])
    start = warm.warm_states(ref.obstacles, float(ref.cfg.u_lattice), ref.store_bf16,
                             seed, float(traffic["perturb_rho"]),
                             float(traffic["perturb_u"]))
    out = {"start": compare.host_copy(ref.steps(start, t_start, n))}
    del start
    end = ref.steps(compare.to_device(end_in, ref.device), t_end, n)
    out["forces"] = ref.forces(end[-1]) if traffic.get("forces_every") else None
    out["stats"] = ref.flow_stats(end[0]) if traffic.get("stats_every") else None
    out["end"] = end
    return out


def gaps(r: Dict, prog_start, prog_end, prog_forces, prog_stats) -> Dict[str, float]:
    """The numbers compared (`compare`) between a side and the reference's
    states `r` (`reference_states`)."""
    values = {"start_gap": compare.state_gap(prog_start, r["start"],
                                             r["end"][0]["f"].device),
              "end_gap": compare.state_gap(prog_end, r["end"])}
    if r["forces"] is not None:
        values["force_gap"] = compare.force_gap(prog_forces, r["forces"])
    if r["stats"] is not None:
        values["stats_gap"] = compare.stats_gap(prog_stats, r["stats"])
    return values


def reference_check(case_dir: str, dev, seed: int, traffic: Dict, t_start: int,
                    t_end: int, prog_start, end_in, prog_end, prog_forces, prog_stats,
                    limits: Dict) -> Dict:
    """The plain reference built from the case's files, its states
    (`reference_states`), and every number compared beside its limit."""
    from .reference.model import Reference

    ref = Reference(case_dir, dev)
    r = reference_states(ref, seed, traffic, t_start, t_end, end_in)
    values = gaps(r, prog_start, prog_end, prog_forces, prog_stats)
    return compare.judge(values, compare.limits_for(limits, list(values)))


def result_line(files: Dict, out: Dict, trace: bool) -> Dict:
    """The run's JSON object: correct, attempted and failed (the numbers
    compared and those over their limits), the cell's metrics of this kind
    (end to end untraced, per layer traced), the device, and with a trace
    the breakdown; the compared numbers last."""
    rec, checks = out["record"], out["checks"]
    wanted = files["per_layer"] if trace else files["end_to_end"]
    metrics = {}
    for m in wanted:
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": rec.device_name, "count": 1,
              "memory_peak_bytes": rec.peak_reserved_bytes}
    line = {"correct": all(c["ok"] for c in checks.values()),
            "attempted": len(checks),
            "failed": sum(not c["ok"] for c in checks.values()),
            "metrics": metrics, "device": device}
    if trace and rec.trace is not None:
        device.update(busy_s=rec.trace.busy_ns / 1e9, window_s=rec.trace.window_ns / 1e9)
        line["breakdown"] = tr.breakdown(rec.trace)
    line["card"] = card_line() if rec.device_name != "cpu" else "cpu"
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in checks.items()}
    return line


def check_lines(checks: Dict) -> List[str]:
    return [f"{k} {c['value']!r} limit {c['limit']!r}" + ("" if c["ok"] else " FAILED")
            for k, c in checks.items()]


def quiet_program_logs() -> None:
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
