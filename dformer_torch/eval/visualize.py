"""Prediction colouring and saving (counterpart of
`dformer_tpu/eval/visualize.py`): palettes, palette PNGs of argmax labels,
the Evaluator's save hook and the per-class table.

The NYU / SUNRGBD palette is the VOC bit-interleave colormap; KITTI-360 /
EventScape and MFNet have their own. The PNGs are 8-bit RGB, written and
read with the standard library (`zlib`), so saving needs no image codec:
the pixels are those cv2 writes from the same colours.
"""

import os
import pathlib
import struct
import zlib

import numpy as np

KITTI_PALETTE = np.array([
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32]], dtype=np.uint8)

MFNET_PALETTE = np.array([
    [0, 0, 0], [64, 0, 128], [64, 64, 0], [0, 128, 192], [0, 0, 192],
    [128, 128, 0], [64, 64, 128], [192, 128, 128], [192, 64, 0]],
    dtype=np.uint8)

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def voc_colormap(n: int = 256) -> np.ndarray:
    """[n, 3] uint8: colour i spreads the bits of i over r, g, b from the
    top bit down (the VOC convention)."""
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        cid = i
        for j in range(8):
            r |= ((cid >> 0) & 1) << (7 - j)
            g |= ((cid >> 1) & 1) << (7 - j)
            b |= ((cid >> 2) & 1) << (7 - j)
            cid >>= 3
        cmap[i] = (r, g, b)
    return cmap


def palette_for(cfg) -> np.ndarray:
    """The config's dataset palette: KITTI-360 and EventScape share one,
    MFNet has its own, every other dataset the VOC colormap of
    max(num_classes + 1, 41) colours."""
    name = cfg.get("dataset_name", "")
    if name in ("KITTI-360", "EventScape"):
        return KITTI_PALETTE
    if name == "MFNet":
        return MFNET_PALETTE
    return voc_colormap(max(cfg.num_classes + 1, 41))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG of `rgb` [H, W, 3] uint8 (no filter on any row)."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb, np.uint8).reshape(h, -1)],
                          axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """[H, W, 3] uint8 of an 8-bit RGB PNG whose rows carry no filter, as
    `write_png` writes them."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG")
    pos, idat, size = len(_PNG_SIGNATURE), [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, colour = struct.unpack(">IIBB", body[:10])
            if (depth, colour) != (8, 2):
                raise ValueError(f"{path}: not 8-bit RGB")
            size = (h, w)
        elif kind == b"IDAT":
            idat.append(body)
    h, w = size
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows")
    return rows[:, 1:].reshape(h, w, 3).copy()


def save_pred_png(pred: np.ndarray, path: str, palette: np.ndarray):
    """Labels [H, W] as a PNG of their palette colours (labels past the
    palette take its last colour)."""
    colored = palette[np.clip(pred, 0, len(palette) - 1)]
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    write_png(path, colored)


def labels_from_png(path: str, palette: np.ndarray) -> np.ndarray:
    """The labels [H, W] (int64) of a `save_pred_png` file: each pixel's
    index in `palette` (its first, when a colour repeats); a colour that is
    not in the palette raises."""
    rgb = read_png(path).astype(np.int64)
    code = (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
    pal = palette.astype(np.int64)
    keys = (pal[:, 0] << 16) | (pal[:, 1] << 8) | pal[:, 2]
    uniq, first = np.unique(keys, return_index=True)
    pos = np.searchsorted(uniq, code).clip(0, len(uniq) - 1)
    if not np.array_equal(uniq[pos], code):
        raise ValueError(f"{path}: a colour outside the palette")
    return first[pos]


def pred_png_name(fn: str) -> str:
    """The file `make_save_hook` writes for a sample named `fn`, relative
    to its save directory."""
    name = str(fn).replace(".jpg", "").replace(".png", "") \
        .replace("datasets/", "")
    return name + "_pred.png"


def make_save_hook(cfg, save_dir: str):
    """A save hook for `Evaluator.evaluate` / `evaluate_msf`: each group's
    labels as palette PNGs `save_dir/<fn>_pred.png` (the batch's "fn",
    else the row's index)."""
    palette = palette_for(cfg)

    def hook(preds: np.ndarray, batch: dict):
        fns = batch.get("fn")
        if not fns:
            fns = [str(i) for i in range(len(preds))]
        for i, pred in enumerate(preds):
            save_pred_png(pred.astype(np.uint8),
                          os.path.join(save_dir, pred_png_name(fns[i])),
                          palette)
    return hook


def print_iou(ious, accs, class_names, logger=None) -> str:
    """The per-class table (name, IoU, Acc), logged or printed; returns it."""
    lines = ["%-22s IoU     Acc" % "class"]
    for name, iou, acc in zip(class_names, ious, accs):
        lines.append("%-22s %-7.2f %-7.2f" % (str(name), iou, acc))
    out = "\n".join(lines)
    (logger.info if logger else print)(out)
    return out
