"""Training-report drawing (counterpart of `dformer_tpu/eval/draw.py`): loss
and mIoU curves from a train log, grids of prediction images, and
multi-page PDF decks that set each image's label and every epoch's
predicted mask side by side.

matplotlib is imported at the first drawing call (a missing one raises,
saying so); python-pptx is not used, so a deck is a PDF alone.
"""

import os
import os.path as osp
import re
from typing import Optional, Sequence

# the train tools' log lines: "epoch E/N loss L", "epoch E mIoU M"
LOSS_RE = re.compile(r"epoch (\d+)/\d+ loss ([0-9.]+)")
MIOU_RE = re.compile(r"epoch (\d+) mIoU ([0-9.]+)")


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("report drawing needs matplotlib, which is not "
                           "installed here") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def parse_log_metrics(log_path: str):
    """([(epoch, loss)], [(epoch, mIoU)]) of a train log, in line order."""
    losses, mious = [], []
    with open(log_path) as f:
        for line in f:
            m = LOSS_RE.search(line)
            if m:
                losses.append((int(m.group(1)), float(m.group(2))))
            m = MIOU_RE.search(line)
            if m:
                mious.append((int(m.group(1)), float(m.group(2))))
    return losses, mious


def _save(fig, plt, out_path, **kw):
    os.makedirs(osp.dirname(osp.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, **kw)
    plt.close(fig)
    return out_path


def plot_training_curves(log_path: str, out_png: str) -> str:
    """Train loss and val mIoU by epoch, side by side, as a PNG."""
    plt = _pyplot()
    losses, mious = parse_log_metrics(log_path)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    for ax, series, title in ((axes[0], losses, "train loss"),
                              (axes[1], mious, "val mIoU")):
        if series:
            ax.plot(*zip(*series))
        ax.set_title(title)
        ax.set_xlabel("epoch")
    fig.tight_layout()
    return _save(fig, plt, out_png, dpi=120)


def prediction_grid(image_paths: Sequence[str], out_png: str,
                    titles: Optional[Sequence[str]] = None,
                    cols: int = 4) -> str:
    """The images tiled `cols` to a row, with their titles, as one PNG."""
    plt = _pyplot()
    import matplotlib.image as mpimg

    n = len(image_paths)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 2.5 * rows),
                             squeeze=False)
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        ax.axis("off")
        if i < n:
            ax.imshow(mpimg.imread(image_paths[i]))
            if titles:
                ax.set_title(titles[i], fontsize=8)
    fig.tight_layout()
    return _save(fig, plt, out_png, dpi=120)


def _load_mask(path):
    import matplotlib.image as mpimg
    import numpy as np

    if path.endswith(".npy"):
        return np.load(path)
    return mpimg.imread(path)


def _derive_gt_path(image_path: str) -> str:
    """The label of an image: images/ -> labels/, as a .npy mask."""
    return osp.splitext(image_path.replace("/images/", "/labels/"))[0] \
        + ".npy"


def _polar_lidar_panel(ax_pos, fig, laser, title: str):
    """The scan over the front +-45 degrees, on a polar axis."""
    import numpy as np

    sector = np.deg2rad(45.0)
    ax = fig.add_subplot(*ax_pos, projection="polar")
    angles = np.linspace(-sector, sector, len(laser), endpoint=False)
    ax.plot(angles, laser)
    ax.set_thetamin(-45)
    ax.set_thetamax(45)
    ax.set_theta_zero_location("N")
    ax.set_title(title, fontsize=9)
    ax.set_xticks([])
    ax.set_yticks([])
    return ax


def epoch_comparison_deck(entries: Sequence[dict], epoch_dirs: Sequence,
                          out_path: str, alpha: float = 0.6,
                          overlay_color: str = "lime") -> str:
    """A PDF of one page per entry: the RGB image, its label over it, the
    lidar scan on a polar panel when the entry has one, and each epoch's
    predicted mask over the image.

    entries: dicts of "image" (an RGB path), optionally "label" (a .npy or
    image mask; by default the image path's images/ -> labels/ .npy) and
    "laser" (a pickled LaserScan). epoch_dirs: (name, directory) pairs,
    each holding `<image stem>.npy` masks (a missing one is titled so).
    Each page is also written as `_deck_<stem>.png` beside the PDF."""
    plt = _pyplot()
    import matplotlib.image as mpimg
    from matplotlib.backends.backend_pdf import PdfPages
    from matplotlib.colors import ListedColormap

    from dformer_torch.data.trav import read_lidar

    epoch_dirs = list(epoch_dirs)
    cmap = ListedColormap(["#00000000", overlay_color])
    out_dir = osp.dirname(osp.abspath(out_path))
    os.makedirs(out_dir, exist_ok=True)
    with PdfPages(out_path) as pdf:
        for entry in entries:
            img_path = entry["image"]
            stem = osp.splitext(osp.basename(img_path))[0]
            img = mpimg.imread(img_path)
            gt_path = entry.get("label") or _derive_gt_path(img_path)
            gt = _load_mask(gt_path) if osp.exists(gt_path) else None
            laser = read_lidar(entry["laser"]) if entry.get("laser") \
                else None

            n_panels = 2 + (laser is not None) + len(epoch_dirs)
            cols = max(3, -(-n_panels // 2))
            fig = plt.figure(figsize=(4.5 * cols, 7))
            panel = 1

            ax = fig.add_subplot(2, cols, panel)
            panel += 1
            ax.imshow(img)
            ax.set_title("img", fontsize=9)
            ax.axis("off")

            ax = fig.add_subplot(2, cols, panel)
            panel += 1
            ax.imshow(img)
            if gt is not None:
                ax.imshow(gt, cmap=cmap, alpha=alpha)
            ax.set_title("target", fontsize=9)
            ax.axis("off")

            if laser is not None:
                _polar_lidar_panel((2, cols, panel), fig, laser, "depth")
                panel += 1

            for name, pred_dir in epoch_dirs:
                ax = fig.add_subplot(2, cols, panel)
                panel += 1
                ax.imshow(img)
                pred_path = osp.join(pred_dir, f"{stem}.npy")
                if osp.exists(pred_path):
                    ax.imshow(_load_mask(pred_path), cmap=cmap, alpha=alpha)
                    ax.set_title(name, fontsize=9)
                else:
                    ax.set_title(f"{name} (missing)", fontsize=9)
                ax.axis("off")

            fig.suptitle(img_path, fontsize=8)
            fig.tight_layout()
            pdf.savefig(fig)
            fig.savefig(osp.join(out_dir, f"_deck_{stem}.png"), dpi=100)
            plt.close(fig)
    return out_path


def deck_from_csv(csv_path: str, epoch_dirs: Sequence, out_path: str,
                  alpha: float = 0.6) -> str:
    """`epoch_comparison_deck` over a Trav manifest (an index column, then
    "image" or "img", optionally "label" and "laser" or "depth")."""
    from dformer_torch.data.trav import read_csv

    rows = read_csv(csv_path, index_col=0)
    cols = rows[0].keys() if rows else ()
    img_col = "image" if "image" in cols else "img"
    laser_col = ("laser" if "laser" in cols
                 else "depth" if "depth" in cols else None)
    entries = []
    for row in rows:
        e = {"image": row[img_col]}
        if row.get("label"):
            e["label"] = row["label"]
        if laser_col and row[laser_col]:
            e["laser"] = row[laser_col]
        entries.append(e)
    return epoch_comparison_deck(entries, epoch_dirs, out_path, alpha=alpha)
