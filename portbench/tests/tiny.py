"""Cells shrunk to what a CPU test can hold: the same code paths, small
batches and images."""

import json
import os

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHRINK = {
    "train": {"batch_size": 4, "corpus_rows": 64},
    "predict_cached": {"images": 2, "image_wh": 128},
}


def spec() -> dict:
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def tiny_cell(workload: str, img_wh: int = 64) -> harness.Cell:
    """The workload with its traffic shrunk and its images at `img_wh`
    (the focal length scaled with it)."""
    cell = harness.Cell(spec(), workload)
    cell.traffic = dict(cell.traffic, **SHRINK[cell.traffic["kind"]])
    cfg = json.loads(json.dumps(cell.config))
    cfg["focal_length"] = cfg["focal_length"] * img_wh / cfg["img_wh"]
    cfg["img_wh"] = img_wh
    cell.config = cfg
    return cell
