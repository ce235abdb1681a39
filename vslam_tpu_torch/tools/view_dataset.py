"""Dataset viewer: dump frames with detected-feature overlays to PNG.

Port of ``vslam_tpu/tools/view_dataset.py``: a headless equivalent of the
reference's sidecar image viewer demo (src/feed_image_opencv.cpp). Useful
for eyeballing what the frontend detects on a new dataset. Extraction runs
on the card unless ``cpu`` is given as the device; writing PNGs needs
Pillow.

Usage: python -m vslam_tpu_torch.tools.view_dataset <dataset_path>
           [out_dir] [N] [device]
"""

from __future__ import annotations

import os
import sys


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    dataset = argv[0]
    out_dir = argv[1] if len(argv) > 1 else "dataset_view"
    n = int(argv[2]) if len(argv) > 2 else 5

    import numpy as np
    import torch

    from .. import resolve_device
    from ..frontend.features import extract_features
    from ..io import euroc
    from ..viz import overlays

    dev = resolve_device(argv[3] if len(argv) > 3 else "cuda")
    seq = euroc.load_sequence(dataset)
    os.makedirs(out_dir, exist_ok=True)
    for i in range(min(n, seq.num_frames)):
        img_l, img_r = (euroc.load_image(seq.image_paths[i][0]),
                        euroc.load_image(seq.image_paths[i][1]))
        fl = extract_features(torch.from_numpy(img_l).to(dev),
                              num_features=1500)
        fr = extract_features(torch.from_numpy(img_r).to(dev),
                              num_features=1500)
        out = np.concatenate([
            overlays.draw_keypoints(img_l, fl.corners.cpu().numpy(),
                                    fl.valid.cpu().numpy()),
            overlays.draw_keypoints(img_r, fr.corners.cpu().numpy(),
                                    fr.valid.cpu().numpy()),
        ], axis=1)
        path = os.path.join(out_dir, f"frame_{i:04d}.png")
        overlays.save_png(out, path)
        print(path, f"({int(fl.valid.sum())} / {int(fr.valid.sum())} "
              "features)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
