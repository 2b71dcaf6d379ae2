"""Perf-regression bands (counterpart of `straps_tpu/utils/bands.py`):
recorded good numbers + tolerances that turn a silent slowdown into a
nonzero exit from a command a robot runs.

`BENCH_BANDS_TORCH.json` (repo root; the port's own file, for numbers
measured on the card) maps band name -> {"value": recorded, "rel_tol":
fraction, "direction": "min"|"max", "unit", "source"}.  "min" bands fail
when the measurement drops below value*(1-rel_tol) (throughputs); "max"
bands fail when it rises above value*(1+rel_tol) (latencies).  An absent
file holds no bands.

Bands are one-sided: a faster run never fails the gate; update the
recorded value when an improvement lands so the band tracks the new roof.
"""

import json
import os
from typing import Optional

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BANDS_PATH = os.path.join(_ROOT, "BENCH_BANDS_TORCH.json")


def load_bands(path: Optional[str] = None) -> dict:
    p = path or BANDS_PATH
    if not os.path.exists(p):
        return {}
    with open(p) as f:
        return json.load(f)


def check_band(name: str, value: float, bands: Optional[dict] = None,
               verbose: bool = True) -> bool:
    """True if `value` is inside the recorded band (or no band recorded).
    Prints a PASS/FAIL line so logs show which band tripped."""
    if bands is None:
        bands = load_bands()
    band = bands.get(name)
    if band is None:
        return True
    rec, tol = float(band["value"]), float(band.get("rel_tol", 0.2))
    if band.get("direction", "max") == "min":
        limit = rec * (1.0 - tol)
        ok = value >= limit
        cmp = f">= {limit:.4g}"
    else:
        limit = rec * (1.0 + tol)
        ok = value <= limit
        cmp = f"<= {limit:.4g}"
    if verbose:
        print(f"band {name}: {value:.4g} {band.get('unit', '')} "
              f"[{'PASS' if ok else 'FAIL'} {cmp}, recorded {rec:.4g}]")
    return ok
