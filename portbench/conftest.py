"""What the benchmark's tests share beyond `tests/conftest.py`: the cells
that `tests/test_portbench_cells.py` drives.

That module drives every cell of `tests/tiny.spec()` through shrunk sizes
(`tiny.SHRINK`) and planted faults keyed by the cells it was written for.
A cell of a kind it cannot shrink has a test file of its own (the photo
path: `tests/test_portbench_detect.py`), so `tiny.spec()` here lists only
the cells of the kinds in `tiny.SHRINK`; `BENCHMARK.json` is unchanged.

A stopgap: a cell of a new kind drops out of that module here without a
word.  Once `tiny.SHRINK` and the module's faults are keyed by kind, this
file goes.
"""

import json
import os

from portbench.tests import tiny

_full_spec = tiny.spec


def _kind(workload: dict) -> str:
    path = os.path.join(tiny.ROOT, "portbench", "traffic", workload["traffic"] + ".json")
    with open(path) as f:
        return json.load(f)["kind"]


def _spec_of_shrinkable_cells() -> dict:
    spec = _full_spec()
    return dict(spec, workloads=[w for w in spec["workloads"] if _kind(w) in tiny.SHRINK])


tiny.spec = _spec_of_shrinkable_cells
