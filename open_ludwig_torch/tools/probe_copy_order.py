"""How the card's memory takes K5's order of cells: a copy of the 27 slots
of a (27, X, Y, Z) array (csrc/copy_order.cu), a thread per cell, in
linear order and in K5's region order at several row-piece widths.

K5 (`csrc/stream_collide_inplace.cu`) walks a region in z-chunks and
marches along x inside a chunk, so a block reads `chunk` cells of a row of
one slot at a time.  This probe showed that 64-byte pieces cost the card
~70% over the linear order and 128-byte pieces ~17%, which set K5's chunk
to 128 bytes of a row.  It computes nothing; every copy is checked equal
to its source.

    python -m open_ludwig_torch.tools.probe_copy_order [--shape 432 384 384]
        [--reps 3]

Needs a CUDA device and nvcc.  `main(argv)` returns the numbers it prints.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from typing import Dict, List, Optional, Sequence

import torch

from ..ops import build

_I, _P = ctypes.c_int, ctypes.c_void_p
# (rows, cells of a row piece) of a block, for bf16 and float32
TILES = ((16, 32), (8, 32), (8, 64), (16, 64), (4, 128))


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=3, default=(432, 384, 384))
    ap.add_argument("--xr", type=int, default=20, help="planes per x-run")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_copy_order needs a CUDA device")
    dev = torch.device("cuda", 0)
    fn = build.load("copy_order").lib.ol_copy_order
    fn.argtypes = [_I, _I, _P, _P] + [_I] * 6 + [_P]
    fn.restype = _I
    X, Y, Z = args.shape
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi} | shape {(X, Y, Z)}, runs of {args.xr} planes")
    out: Dict = {"card": smi, "shape": (X, Y, Z), "rows": []}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(3)
        a = torch.randn((27, X, Y, Z), generator=gen, device=dev).to(dtype)
        b = torch.empty_like(a)
        nbytes = 2 * a.numel() * a.element_size()

        def ms(kind: int, ty: int = 1, cw: int = 1) -> float:
            def launch():
                rc = fn(a.element_size(), kind, a.data_ptr(), b.data_ptr(), X, Y,
                        Z, ty, cw, args.xr,
                        torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"copy_order launch failed: CUDA error {rc}")
            b.zero_()
            launch()
            if not torch.equal(a, b):
                raise RuntimeError(f"copy kind {kind} ({ty} x {cw}) is not a copy")
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(args.reps):
                launch()
            end.record()
            torch.cuda.synchronize(dev)
            return start.elapsed_time(end) / args.reps

        row = {"dtype": str(dtype), "gb": nbytes / 1e9, "linear_ms": ms(0),
               "tiles": []}
        print(f"{dtype}: {nbytes / 1e9:.2f} GB moved, linear {row['linear_ms']:.3f}"
              " ms")
        tiles: List[Dict] = row["tiles"]
        for ty, cw in TILES:
            t = {"rows": ty, "piece_cells": cw,
                 "piece_bytes": cw * a.element_size(),
                 "z_outer_ms": ms(1, ty, cw), "x_outer_ms": ms(2, ty, cw)}
            tiles.append(t)
            print(f"  {ty:2d} rows x {cw:3d} cells ({t['piece_bytes']:3d} B a row "
                  f"piece): chunks outside, x inside {t['z_outer_ms']:.3f} ms | x "
                  f"outside, chunks inside {t['x_outer_ms']:.3f} ms")
        out["rows"].append(row)
        del a, b
    return out


if __name__ == "__main__":
    main()
