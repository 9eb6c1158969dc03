"""Multi-label zero-shot metrics and the metrics.txt report, numpy only.

The port's own copy of `calculate_metrics` and `save_metrics` of
ct_clip_ut_tpu/utils/metrics.py:28-117, without scikit-learn or tabulate
(the GPU machine has neither). Each piece restates the library rule the
JAX module relies on:

  * ROC curve: scores sorted descending, one point per distinct score,
    collinear points dropped (`drop_intermediate=True`), a leading
    (0, 0) point at threshold +inf; AUROC is the trapezoid area;
  * the per-class threshold is the ROC point closest to (0, 1); a
    single-class column takes 0.5 and an AUROC of NaN;
  * F1, precision and recall from confusion counts with `zero_division=0`:
    per class the F1 is label-weighted over the labels present and
    precision / recall are those of label 1; micro over all cells; the
    sample F1 averages each row's F1;
  * macro average precision: per column the step integral of the
    precision-recall curve (recall 1 everywhere when a column has no
    positive);
  * the table in tabulate's "grid" layout: numeric columns parsed and
    printed with format "g", aligned on the decimal point; text columns
    flush left.

tests/test_torch_port_metrics.py holds both functions equal to the JAX
module's wherever scikit-learn is installed. `plot_training_progress`
(the trainer's curves, ct_clip_ut_tpu/utils/metrics.py:212-236) imports
matplotlib when called: ImportError where it does not import.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _clf_curve(y_true, y_score):
    """(fps, tps, thresholds) at each distinct score, scores descending."""
    order = np.argsort(-y_score, kind="stable")
    y_score, y_true = y_score[order], (y_true[order] == 1).astype(np.float64)
    idx = np.r_[np.nonzero(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, y_score[idx]


def roc_curve(y_true, y_score):
    """(fpr, tpr, thresholds) with collinear points dropped."""
    fps, tps, thr = _clf_curve(np.asarray(y_true), np.asarray(y_score, np.float64))
    if fps.shape[0] > 2:
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        fps, tps, thr = fps[keep], tps[keep], thr[keep]
    fps, tps = np.r_[0.0, fps], np.r_[0.0, tps]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, np.r_[np.inf, thr]


def roc_auc(y_true, y_score) -> float:
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())


def average_precision(y_true, y_score) -> float:
    fps, tps, _ = _clf_curve(np.asarray(y_true), np.asarray(y_score, np.float64))
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    precision, recall = np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0]
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def _divide(num, den):
    """num / den with 0 where den == 0 (zero_division=0)."""
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    return np.divide(num, den, out=np.zeros_like(num), where=den != 0)


def _counts(t, p, axis):
    """(tp, predicted, true) sums of 0/1 arrays along `axis`."""
    t, p = t.astype(bool), p.astype(bool)
    return (t & p).sum(axis), p.sum(axis), t.sum(axis)


def _f1(tp, pred, true):
    return _divide(2.0 * tp, np.asarray(true, np.float64) + np.asarray(pred, np.float64))


def weighted_f1(y_true, y_pred) -> float:
    """F1 per label present in either array, averaged with the true counts."""
    labels = np.union1d(y_true, y_pred)
    f1 = np.empty(len(labels))
    support = np.empty(len(labels))
    for i, lab in enumerate(labels):
        tp, pred, true = _counts(y_true == lab, y_pred == lab, None)
        f1[i], support[i] = _f1(tp, pred, true), true
    return float(np.average(f1, weights=support) if support.sum() else f1.mean())


def calculate_metrics(soft_preds: np.ndarray, targets: np.ndarray, pathologies) -> dict:
    soft_preds = np.asarray(soft_preds, np.float64)
    targets = np.asarray(targets)
    hard_preds = np.zeros_like(soft_preds)
    per_class = {"f1": [], "precision": [], "recall": [], "roc_auc": []}

    def optimal_threshold(y_true, y_prob):
        """(threshold, auroc): the ROC point closest to the (0, 1) corner;
        single-class columns take 0.5 / NaN."""
        if len(set(y_true.tolist())) <= 1:
            return 0.5, float("nan")
        fpr, tpr, thresh = roc_curve(y_true, y_prob)
        dist = np.sqrt((1 - tpr) ** 2 + fpr ** 2)
        return thresh[int(np.argmin(dist))], roc_auc(y_true, y_prob)

    for i, _ in enumerate(pathologies):
        y_true, y_prob = targets[:, i], soft_preds[:, i]
        best_thresh, auroc = optimal_threshold(y_true, y_prob)
        y_pred = (y_prob > best_thresh).astype(int)
        hard_preds[:, i] = y_pred
        tp, pred, true = _counts(y_true == 1, y_pred == 1, None)
        per_class["f1"].append(weighted_f1(y_true, y_pred))
        per_class["precision"].append(float(_divide(tp, pred)))
        per_class["recall"].append(float(_divide(tp, true)))
        per_class["roc_auc"].append(auroc)

    tp, pred, true = _counts(targets, hard_preds, None)
    m = {
        "label_accuracy": float(np.mean(targets.flatten() == hard_preds.flatten())),
        "per_class_f1": per_class["f1"],
        "macro_f1": float(np.nanmean(per_class["f1"])),
        "micro_f1": float(_f1(tp, pred, true)),
        "sample_f1": float(np.mean(_f1(*_counts(targets, hard_preds, 1)))),
        "per_class_precision": per_class["precision"],
        "macro_precision": float(np.nanmean(per_class["precision"])),
        "micro_precision": float(_divide(tp, pred)),
        "per_class_recall": per_class["recall"],
        "macro_recall": float(np.nanmean(per_class["recall"])),
        "micro_recall": float(_divide(tp, true)),
        "roc_aucs": per_class["roc_auc"],
        "mean_roc_auc": float(np.nanmean(per_class["roc_auc"])),
        "mAP": float(np.mean([average_precision(targets[:, i], soft_preds[:, i])
                              for i in range(targets.shape[1])])),
    }
    return m


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def grid_table(rows, headers) -> str:
    """The table tabulate(rows, headers, tablefmt="grid") prints for rows of
    strings such as save_metrics writes (fixed-point numbers in [0, 1] or
    text)."""
    columns, heads, widths = [], [], []
    for col, head in zip(zip(*rows), headers):
        numeric = all(_is_number(v) for v in col)
        if numeric:             # printed as "g", padded so the points align
            cells = [format(float(v), "g") for v in col]
            after = [len(c) - c.index(".") - 1 if "." in c else -1 for c in cells]
            cells = [c + " " * (max(after) - a) for c, a in zip(cells, after)]
        else:
            cells = [v.strip() for v in col]
        width = max(len(head) + 2, *(len(c) for c in cells))
        pad = str.rjust if numeric else str.ljust
        columns.append([pad(c, width) for c in cells])
        heads.append(pad(head, width))
        widths.append(width)

    def rule(ch):
        return "+" + "+".join(ch * (w + 2) for w in widths) + "+"

    def line(cells):
        return "|" + "|".join(f" {c} " for c in cells) + "|"

    out = [rule("-"), line(heads), rule("=")]
    for row in zip(*columns):
        out += [line(row), rule("-")]
    return "\n".join(out)


def save_metrics(metrics_list, pathologies, results_path) -> None:
    """metrics.txt, line for line what ct_clip_ut_tpu.utils.metrics writes."""
    results_path = Path(results_path)
    results_path.mkdir(parents=True, exist_ok=True)
    with open(results_path / "metrics.txt", "w") as f:
        for epoch, m in enumerate(metrics_list):
            f.write(f"Epoch {epoch} Metrics:\n" + "=" * 40 + "\n")
            for label, key in [
                ("Label Accuracy", "label_accuracy"),
                ("Sample F1 Score", "sample_f1"),
                ("Macro F1 Score", "macro_f1"),
                ("Micro F1 Score", "micro_f1"),
                ("Macro Precision", "macro_precision"),
                ("Micro Precision", "micro_precision"),
                ("Macro Recall", "macro_recall"),
                ("Micro Recall", "micro_recall"),
                ("Mean ROC-AUC", "mean_roc_auc"),
                ("Mean Average Precision (mAP)", "mAP"),
            ]:
                f.write(f"{label}: {m[key]:.4f}\n")
            f.write("\n")
            rows = []
            for i, p in enumerate(pathologies):
                auc = m["roc_aucs"][i]
                rows.append([p,
                             f"{m['per_class_precision'][i]:.4f}",
                             f"{m['per_class_recall'][i]:.4f}",
                             f"{m['per_class_f1'][i]:.4f}",
                             f"{auc:.4f}" if not np.isnan(auc) else "N/A"])
            f.write(grid_table(rows, ["Pathology", "Precision", "Recall", "F1 Score",
                                      "ROC-AUC"]) + "\n\n")


def plot_training_progress(train_losses: dict, valid_losses, results_path) -> None:
    """training_progress.png under results_path: the step and epoch losses
    beside the validation losses (the JAX module's figure)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    path = Path(results_path)
    path.mkdir(parents=True, exist_ok=True)
    steps, epochs = train_losses["steps"], train_losses["epochs"]
    epoch_idx = (np.linspace(0, max(len(steps) - 1, 0), len(epochs)).astype(int)
                 if epochs else np.array([], int))
    fig, ax = plt.subplots(1, 2, figsize=(14, 6), gridspec_kw={"wspace": 0.3})
    ax[0].plot(np.arange(len(steps)), steps, color="tab:blue", marker="o", linestyle="-",
               label="Step Losses")
    if len(epochs):
        ax[0].plot(epoch_idx, epochs, color="tab:green", marker="s", linestyle="--",
                   label="Epoch Losses")
    ax[0].set_xlabel("Step")
    ax[0].set_ylabel("Contrastive Loss")
    ax[0].set_title("Training Loss")
    ax[0].legend()
    ax[0].grid(True, linestyle="--", alpha=0.5)
    ax[1].plot(np.arange(len(valid_losses)), valid_losses, color="tab:orange", marker="o",
               linestyle="-")
    ax[1].set_xlabel("Epoch")
    ax[1].set_ylabel("Contrastive Loss")
    ax[1].set_title("Validation Loss")
    ax[1].grid(True, linestyle="--", alpha=0.5)
    plt.suptitle("Training Progress", fontsize=14, fontweight="bold")
    plt.savefig(path / "training_progress.png")
    plt.close(fig)
