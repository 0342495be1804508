"""Write a synthetic NYUDepthv2-shaped dataset to disk with real JPEG/PNG
encoding (the port's copy of `tools/make_synth_dataset.py`, numpy + cv2),
so that the input pipeline can be measured end to end without the real
data: RGB/*.jpg, Label/*.png (class + 1, 0 invalid, as `gt_transform`
reads it), Depth/*.png (8-bit), train.txt and test.txt.

Images are low-frequency random fields (upsampled coarse noise plus fine
grain), so the JPEG files land in the 60-150 KB of real photographs: white
noise would inflate them 5x and overstate the decode cost, flat fields
understate it.

    python -m dformer_torch.tools.make_synth_dataset --root DIR [--n-train 795] [--n-val 64]
    DFORMER_DATA_ROOT=DIR python -m dformer_torch.tools.train \\
        --config=local_configs.NYUDepthv2.DFormer_Large --native-loader
"""

import argparse
import os
import os.path as osp

import numpy as np


def _field(rng, hw, coarse=(30, 40), channels=3):
    """A natural-looking image: bicubic-upsampled coarse noise + grain."""
    import cv2

    base = rng.rand(*coarse, channels).astype(np.float32)
    img = cv2.resize(base, (hw[1], hw[0]), interpolation=cv2.INTER_CUBIC)
    if channels == 1 and img.ndim == 2:
        img = img[..., None]
    img = img + rng.normal(0, 0.04, img.shape).astype(np.float32)
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def _label(rng, hw, num_classes, coarse=(15, 20)):
    """A blobby label map in the on-disk encoding: class index + 1, with
    some invalid (0) blobs."""
    import cv2

    base = rng.randint(0, num_classes + 1, coarse).astype(np.uint8)
    return cv2.resize(base, (hw[1], hw[0]), interpolation=cv2.INTER_NEAREST)


def generate(root, n_train=795, n_val=64, hw=(480, 640), num_classes=40,
             seed=0, quiet=False):
    """Write the tree under `root`/NYUDepthv2 and return that directory."""
    import cv2

    ds = osp.join(root, "NYUDepthv2")
    for sub in ("RGB", "Label", "Depth"):
        os.makedirs(osp.join(ds, sub), exist_ok=True)
    rng = np.random.RandomState(seed)
    names = {"train": [], "test": []}
    sizes = []
    for split, n in (("train", n_train), ("test", n_val)):
        for i in range(n):
            name = f"{split}_{i:05d}"
            rgb = _field(rng, hw, channels=3)
            dep = _field(rng, hw, coarse=(24, 32), channels=1)
            lab = _label(rng, hw, num_classes)
            cv2.imwrite(osp.join(ds, "RGB", name + ".jpg"), rgb,
                        [cv2.IMWRITE_JPEG_QUALITY, 90])
            cv2.imwrite(osp.join(ds, "Label", name + ".png"), lab)
            cv2.imwrite(osp.join(ds, "Depth", name + ".png"), dep[..., 0])
            sizes.append(os.path.getsize(osp.join(ds, "RGB", name + ".jpg")))
            # the reference's two-column "RGB/<n>.jpg\tLabel/<n>.png" lines
            names[split].append(f"RGB/{name}.jpg\tLabel/{name}.png")
    for split in ("train", "test"):
        with open(osp.join(ds, f"{split}.txt"), "w") as f:
            f.write("\n".join(names[split]) + "\n")
    if not quiet:
        print(f"wrote {n_train}+{n_val} imgs to {ds}; "
              f"median jpg {int(np.median(sizes)) // 1024} KB")
    return ds


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--n-train", type=int, default=795)
    ap.add_argument("--n-val", type=int, default=64)
    args = ap.parse_args(argv)
    generate(args.root, args.n_train, args.n_val)


if __name__ == "__main__":
    main()
