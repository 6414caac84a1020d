"""Benchmark result plots (ref: lib/eval_toolkit/pysot/visualization/):
success/precision curves, EAO rank plot, F1 curves. matplotlib, headless.

The port's own copy of `usot_tpu/eval/visualization.py`. matplotlib is
imported inside each function; where it is not installed, a plot raises
(never skips)."""
from __future__ import annotations

import numpy as np


def require_pyplot():
    """matplotlib.pyplot on the headless Agg backend; raises a clear
    error where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        raise RuntimeError(
            "plots (--vis) need matplotlib, which is not installed; run "
            "without --vis to score only") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def draw_success_precision(success_ret, name, videos, attr,
                           precision_ret=None, norm_precision_ret=None,
                           bold_name=None, axis=(0, 1), out_path=None):
    plt = require_pyplot()

    if videos is None:
        videos = list(next(iter(success_ret.values())).keys())
    fig, ax = plt.subplots()
    ax.grid(visible=True)
    ax.set_aspect(1)
    plt.xlabel("Overlap threshold")
    plt.ylabel("Success rate")
    plt.title(f"Success plots of OPE on {name} - {attr}")
    plt.axis([0, 1] + list(axis))
    thresholds = np.arange(0, 1.05, 0.05)
    for tracker_name in sorted(
            success_ret.keys(),
            key=lambda t: -np.mean(list(success_ret[t].values()))):
        value = [v for k, v in success_ret[tracker_name].items()
                 if k in videos]
        auc = np.mean(value)
        label = f"[{auc:.3f}] {tracker_name}"
        plt.plot(thresholds, np.mean(value, axis=0), label=label,
                 linewidth=2)
    ax.legend(loc="lower left", labelspacing=0.2)
    if out_path:
        plt.savefig(out_path, bbox_inches="tight", dpi=150)
    plt.close(fig)

    if precision_ret:
        fig, ax = plt.subplots()
        ax.grid(visible=True)
        plt.xlabel("Location error threshold")
        plt.ylabel("Precision")
        plt.title(f"Precision plots of OPE on {name} - {attr}")
        thresholds = np.arange(0, 51, 1)
        for tracker_name in sorted(
                precision_ret.keys(),
                key=lambda t: -np.mean(
                    list(precision_ret[t].values()), axis=0)[20]):
            value = [v for k, v in precision_ret[tracker_name].items()
                     if k in videos]
            pre = np.mean(value, axis=0)[20]
            plt.plot(thresholds, np.mean(value, axis=0),
                     label=f"[{pre:.3f}] {tracker_name}", linewidth=2)
        ax.legend(loc="lower right", labelspacing=0.2)
        if out_path:
            plt.savefig(out_path.replace(".png", "_precision.png"),
                        bbox_inches="tight", dpi=150)
        plt.close(fig)


def draw_eao(result, out_path=None):
    """EAO summary plot. Results evaluated per attribute tag (>=3 tags)
    get the reference's polar attribute radar, max-normalized per axis
    (ref: visualization/draw_eao.py); 'all'-only results get a bar rank.
    """
    plt = require_pyplot()

    tags = [t for t in next(iter(result.values())).keys()]
    if len(tags) >= 3:
        _draw_eao_radar(result, tags, out_path)
        return
    fig = plt.figure()
    names = sorted(result.keys(), key=lambda n: -result[n]["all"])
    values = [result[n]["all"] for n in names]
    plt.barh(range(len(names))[::-1], values)
    plt.yticks(range(len(names))[::-1], names)
    plt.xlabel("EAO")
    if out_path:
        plt.savefig(out_path, bbox_inches="tight", dpi=150)
    plt.close(fig)


_TAG_LABELS = {
    "all": "Overall", "camera_motion": "Camera motion",
    "illum_change": "Illumination change", "motion_change": "Motion Change",
    "size_change": "Size change", "occlusion": "Occlusion",
    "empty": "Unassigned",
}


def _draw_eao_radar(result, tags, out_path=None):
    plt = require_pyplot()

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="polar")
    angles = np.linspace(0, 2 * np.pi, len(tags) + 1, endpoint=True)

    values = np.array([[result[n][t] for t in tags] for n in result])
    values = np.concatenate([values, values[:, :1]], axis=1)
    max_value = np.maximum(values.max(axis=0), 1e-12)
    min_value = values.min(axis=0)
    for i, name in enumerate(result):
        plt.plot(angles, values[i] / max_value, linestyle="-", marker="o",
                 label=name, linewidth=1.5, markersize=6)

    labels = [f"{_TAG_LABELS.get(t, t)}\n({mn:.3f},{mx:.3f})"
              for t, mn, mx in zip(tags, min_value, max_value)]
    ax.set_thetagrids(angles[:-1] * 180 / np.pi, labels)
    ax.spines["polar"].set_visible(False)
    ax.legend(loc="upper center", bbox_to_anchor=(0.5, -0.07),
              frameon=False, ncol=5)
    ax.grid(visible=False)
    ax.set_ylim(0, 1.18)
    ax.set_yticks([])
    if out_path:
        plt.savefig(out_path, bbox_inches="tight", dpi=150)
    plt.close(fig)


def draw_f1(result, out_path=None):
    plt = require_pyplot()

    fig, ax = plt.subplots()
    for name, ret in result.items():
        precision = np.mean(list(ret["precision"].values()), axis=0)
        recall = np.mean(list(ret["recall"].values()), axis=0)
        f1 = 2 * precision * recall / (precision + recall + 1e-16)
        best = np.argmax(f1)
        plt.plot(recall, precision,
                 label=f"[F1: {f1[best]:.3f}] {name}", linewidth=2)
    plt.xlabel("Recall")
    plt.ylabel("Precision")
    ax.legend(loc="lower left")
    if out_path:
        plt.savefig(out_path, bbox_inches="tight", dpi=150)
    plt.close(fig)
