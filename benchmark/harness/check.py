"""The numbers that decide ``correct``: the program's answers against the
reference's, each number with a limit in ``benchmark/limits/<cell>.json``.

Serving (per image, pooled over the sampled requests): a program detection
matches a reference detection of the same class, greedily, the reference's
detections in descending score order taking the unmatched program
detection of highest IoU.
  * ``unmatched``: detections of either side without a match at IoU >= 0.9
    (the same box: a precision change moves boxes less) / all detections of
    both sides;
  * ``score_gap``: the median over pairs matched at IoU >= 0.5 of
    |s_prog - s_ref| / s_ref;
  * ``box_gap``: the median over the reference's detections of 1 - the IoU
    of its partner at IoU >= 0.5, 1 where it has none (answers missing
    from half of the images read at least 0.5);
  * ``box_gap_worst``: the worst image's own ``box_gap`` (1 for an image
    where only the program detects anything);
  * ``box_gap_part``: the worst part's pooled ``box_gap``, the parts being
    the images of one batch slot and those of one bucket: a fault confined
    to one slot, one bucket or one orientation moves the pooled median
    little and reads near 1 in both of these.

Training (the first steps of the program's solver against the reference's
steps on the same batches and draws), per trained leaf, leaving out leaves
whose reference gradient at step 1 is under a thousandth of the median
leaf's (nought to rounding, e.g. a bias under a softmax):
  * ``loss_gap``: max over the steps of |L_prog - L_ref| / |L_ref|, the
    total loss;
  * ``grad_gap``: the worst leaf's |‖g_prog‖ - ‖g_ref‖| / max(‖g_ref‖,
    median leaf ‖g_ref‖), g the first step's gradient as the optimizer
    holds it (SGD's momentum buffer after one step: gradient + decay);
  * ``update_gap``: the same of each leaf's change over the steps.
  * ``grad_gap_median``, ``update_gap_median``: the median leaf's gap;
    ``loss_gap_step1``: the first step's loss gap;
  * ``rpn_loss_gap``: the first step's RPN losses (cross-entropy + box),
    ``rpn_grad_gap``, ``rpn_update_gap``: the worst of the RPN head's
    leaves: the RPN's targets come from the anchors and the ground truth
    alone, so these see no proposal and no roi sampling, which differ
    between any two precisions;
  * ``rpn_grad_diff``: the worst RPN-head leaf's ‖g_prog - g_ref‖ /
    ‖g_ref‖ of the first gradient: unbiased rounding hides in a norm's gap
    (errors add in quadrature), not in the norm of the difference, which
    on these leaves no roi sampling disturbs.
"""

from __future__ import annotations

import math

import numpy as np

SAME_BOX = 0.9


def _iou(a, b):
    """IoU of (N, 4) x (M, 4) inclusive-corner boxes → (N, M)."""
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1 + 1, 0, None) * np.clip(y2 - y1 + 1, 0, None)
    area = lambda z: (z[:, 2] - z[:, 0] + 1) * (z[:, 3] - z[:, 1] + 1)  # noqa: E731
    union = area(a)[:, None] + area(b)[None, :] - inter
    return np.where(inter > 0, inter / np.maximum(union, 1e-9), 0.0)


def match_detections(prog, ref, iou_min: float = 0.5):
    """prog, ref: (k, 6) [x1, y1, x2, y2, score, class] of one image →
    [(i_prog, i_ref, iou)] of the matched pairs."""
    if len(prog) == 0 or len(ref) == 0:
        return []
    iou = _iou(ref[:, :4].astype(np.float64), prog[:, :4].astype(np.float64))
    iou = np.where(ref[:, None, 5] == prog[None, :, 5], iou, -1.0)
    free = np.ones(len(prog), bool)
    pairs = []
    for r in np.argsort(-ref[:, 4], kind="stable"):
        cand = np.where(free, iou[r], -1.0)
        p = int(np.argmax(cand))
        if cand[p] >= iou_min:
            free[p] = False
            pairs.append((p, int(r), float(cand[p])))
    return pairs


def detection_readings(prog_images, ref_images, parts=None) -> dict:
    """Pooled serving numbers over lists of per-image detections; ``parts``
    gives each image the keys of the parts it belongs to (its batch slot,
    its bucket)."""
    total = matched = 0
    score_gaps, box_gaps, worst, by_part = [], [], 0.0, {}
    for i, (prog, ref) in enumerate(zip(prog_images, ref_images)):
        pairs = match_detections(prog, ref)
        total += len(prog) + len(ref)
        matched += len(match_detections(prog, ref, SAME_BOX))
        gaps = np.ones(len(ref))
        for p, r, iou in pairs:
            score_gaps.append(abs(float(prog[p, 4]) - float(ref[r, 4])) / float(ref[r, 4]))
            gaps[r] = 1.0 - iou
        box_gaps.append(gaps)
        if not len(ref) and not len(prog):
            continue
        own = gaps if len(ref) else np.ones(1)
        worst = max(worst, float(np.median(own)))
        for key in (parts[i] if parts is not None else ()):
            by_part.setdefault(key, []).append(own)
    box_gaps = np.concatenate(box_gaps) if box_gaps else np.ones(1)
    return {"unmatched": (total - 2 * matched) / total if total else 0.0,
            "score_gap": float(np.median(score_gaps)) if score_gaps else 1.0,
            "box_gap": float(np.median(box_gaps)) if len(box_gaps) else 1.0,
            "box_gap_worst": worst,
            "box_gap_part": max((float(np.median(np.concatenate(g))) for g in by_part.values()),
                                default=0.0),
            "detections": total}


def _leaf_gaps(prog: dict, ref: dict, leaves):
    med = float(np.median([ref[k] for k in leaves]))
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves]


def training_readings(prog: dict, ref: dict) -> dict:
    """prog, ref: {"losses": [total loss a step], "rpn_loss": the first step's
    RPN losses, "grad": {leaf: ‖g‖}, "update": {leaf: ‖Δ‖}, "rpn_grad":
    {RPN-head leaf: first gradient}}; ref also "raw_grad" {leaf: ‖∇‖} at
    step 1."""
    raw = ref["raw_grad"]
    med = float(np.median(list(raw.values())))
    leaves = sorted(k for k, v in raw.items() if v >= 1e-3 * med)
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    grad = _leaf_gaps(prog["grad"], ref["grad"], leaves)
    upd = _leaf_gaps(prog["update"], ref["update"], leaves)
    worst = lambda gaps: leaves[int(np.argmax(gaps))]  # noqa: E731
    rpn = [i for i, k in enumerate(leaves) if k.startswith("rpn_")]
    diff = {k: float((prog["rpn_grad"][k] - ref["rpn_grad"][k]).norm() / ref["rpn_grad"][k].norm())
            for k in (leaves[i] for i in rpn)}
    return {"loss_gap": loss_gap, "grad_gap": max(grad), "update_gap": max(upd),
            "loss_gap_step1": abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "rpn_loss_gap": abs(prog["rpn_loss"] - ref["rpn_loss"]) / abs(ref["rpn_loss"]),
            "rpn_grad_gap": max(grad[i] for i in rpn), "rpn_update_gap": max(upd[i] for i in rpn),
            "rpn_grad_diff": max(diff.values()),
            "grad_gap_median": float(np.median(grad)), "update_gap_median": float(np.median(upd)),
            "worst_grad_leaf": worst(grad), "worst_update_leaf": worst(upd),
            "leaves": len(leaves), "left_out": sorted(set(raw) - set(leaves))}


def judge(readings: dict, limits: dict):
    """(correct, checks): every number named in ``limits`` at or under its
    limit and finite → {name: {"value", "limit"}} in the limits' order."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = readings.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok &= good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks
