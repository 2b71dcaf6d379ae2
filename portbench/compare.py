"""The numbers that decide `correct`: each a gap between what the program
produced and what the reference produced from the same inputs, held to
the cell's limit (`limits/<workload>.json`).
"""

import statistics

import numpy as np


MISSING = 1e30     # the gap of an answer that is missing or of the wrong shape


def _gap(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) if a.shape == b.shape else MISSING


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each leaf's gap between the program's and the reference's norm,
    over the larger of the reference's norm of that leaf and the median
    leaf's."""
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref}


def moved_leaves(ref_grad1: dict) -> list:
    """Leaves whose first gradient in the reference is not nought to
    rounding: at least a thousandth of the median leaf's."""
    med = statistics.median(ref_grad1.values())
    return [k for k, g in ref_grad1.items() if g >= 1e-3 * med]


def frames_gaps(prog: dict, ref: dict):
    """(largest, median) over frames of a per-frame metric's gap, over the
    median frame's reading of that metric in the reference; each the worst
    metric's."""
    worst, median = [], []
    for m, r in ref.items():
        p, r = np.asarray(prog.get(m, [])), np.asarray(r)
        if p.shape != r.shape:
            return MISSING, MISSING
        gap = np.abs(p - r) / max(float(np.median(np.abs(r))), 1e-30)
        worst.append(float(gap.max()))
        median.append(float(np.median(gap)))
    return max(worst), max(median)


# Tasks whose loss is the batch mean of a per-frame metric that the step
# also reports, times the task's weight.
ROW_MEANS = {"shape_params": "shape_mses", "pose_params": "pose_mses"}


def loss_rows_gap(prog: dict, ref: dict) -> float:
    """The first step's task losses against the reference's loss formula
    applied to the step's own per-frame answers: the task's initial weight
    times the mean over every row of its per-frame metric; the worst
    task's relative gap.  A loss over fewer rows than the step's answers
    cover reads the rows' sampling difference; rounding alone, ~1e-7."""
    gaps = []
    for task, metric in ROW_MEANS.items():
        if task not in ref["task_weights"]:
            continue
        rows = np.asarray(prog["frames1"].get(metric, []), np.float64)
        if task not in prog["tasks"][0] or rows.size == 0:
            return MISSING
        want = ref["task_weights"][task] * float(rows.mean())
        gaps.append(abs(prog["tasks"][0][task] - want) / max(abs(want), 1e-30))
    return max(gaps)


def task_gaps(prog: dict, ref: dict) -> list:
    """Each step's {task: relative gap of its weighted loss}; a task the
    program did not report reads MISSING."""
    return [{t: abs(p[t] - r[t]) / max(abs(r[t]), 1e-30) if t in p else MISSING for t in r}
            for p, r in zip(prog["tasks"], ref["tasks"])]


def train_numbers(prog: dict, ref: dict) -> dict:
    """Gaps of a training cell's first steps: the first step's loss and
    worst task loss (relative), its task losses against its own per-frame
    answers (`loss_rows_gap`) and its per-frame metrics (the worst
    frame's and the median frame's gap, `frames_gaps`), the first gradient
    (the median leaf's gap), the change after the last step (the worst
    leaf's gap, over the leaves the reference moves), the proxy
    silhouettes (share of pixels) and the cropped 2D joint targets
    (pixels)."""
    keep = moved_leaves(ref["grad1"])
    sil = sum(int((np.asarray(a) != np.asarray(b)).sum()) if np.shape(a) == np.shape(b)
              else int(np.asarray(b).size) for a, b in zip(prog["proxy_sil"], ref["proxy_sil"]))
    total = sum(int(np.asarray(b).size) for b in ref["proxy_sil"])
    change = leaf_gaps({k: prog["change"][k] for k in keep}, {k: ref["change"][k] for k in keep})
    frames_worst, frames_median = frames_gaps(prog["frames1"], ref["frames1"])
    return {
        "loss1_gap": abs(prog["losses"][0] - ref["losses"][0]) / max(abs(ref["losses"][0]), 1e-30),
        "tasks1_gap": max(task_gaps(prog, ref)[0].values()),
        "loss_rows_gap": loss_rows_gap(prog, ref),
        "frames_gap": frames_worst,
        "frames_median_gap": frames_median,
        "grad_median_gap": statistics.median(leaf_gaps(prog["grad1"], ref["grad1"]).values()),
        "change_gap": max(change.values()),
        "proxy_mismatch": sil / total,
        "joints_gap_px": max(_gap(a, b) for a, b in zip(prog["joints2D"], ref["joints2D"])),
    }


def train_unused(prog: dict, ref: dict) -> dict:
    """Readings that are not compared (see PERF.md): every step's loss gap,
    the worst leaf's first gradient gap, the median leaf's change gap."""
    keep = moved_leaves(ref["grad1"])
    change = leaf_gaps({k: prog["change"][k] for k in keep}, {k: ref["change"][k] for k in keep})
    return {"loss_gap": max(abs(a - b) / max(abs(b), 1e-30)
                            for a, b in zip(prog["losses"], ref["losses"])),
            "grad_gap": max(leaf_gaps(prog["grad1"], ref["grad1"]).values()),
            "change_median_gap": statistics.median(change.values())}


def predict_numbers(prog_calls: list, prog_files: dict, ref: dict, prog_fg: dict,
                    ref_fg: dict) -> dict:
    """Gaps of a predict: vertices (metres) and cameras of every call's
    returned predictions and of the npy files, and the share of pixels
    whose body coverage differs between the written renders and the
    reference's face-id renders."""
    outs = list(prog_calls) + [prog_files]
    verts = max(_gap(o["verts"], ref["verts"]) for o in outs)
    cam = max(_gap(o["cam_wp"], ref["cam_wp"]) for o in outs)
    rest = max(max(_gap(o["shape"], ref["shape"]), _gap(o["pose_rotmats"], ref["pose_rotmats"]))
               for o in outs)
    if any(prog_fg[k].shape != ref_fg[k].shape for k in ref_fg):
        return {"verts_gap_m": verts, "cam_gap": cam, "params_gap": rest,
                "render_mismatch": MISSING}
    diff = sum(int((prog_fg[k] != ref_fg[k]).sum()) for k in ref_fg)
    total = sum(int(ref_fg[k].size) for k in ref_fg)
    return {"verts_gap_m": verts, "cam_gap": cam, "params_gap": rest,
            "render_mismatch": diff / total}
