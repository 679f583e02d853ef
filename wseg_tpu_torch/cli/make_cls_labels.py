"""The image-level multi-hot label dict (cls_labels.npy) from the VOC XML
annotations (counterpart of wseg_tpu/cli/make_cls_labels.py; the
reference's voc12/make_cls_labels.py).

    python -m wseg_tpu_torch.cli.make_cls_labels --voc12_root VOC2012 \\
        --train_list voc12/train_aug.txt --val_list voc12/val.txt \\
        --out voc12/cls_labels.npy
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_list", default="voc12/train_aug.txt")
    parser.add_argument("--val_list", default="voc12/val.txt")
    parser.add_argument("--out", default="voc12/cls_labels.npy")
    parser.add_argument("--voc12_root", required=True)
    args = parser.parse_args(argv)

    import numpy as np

    from wseg_tpu_torch.data.voc12 import load_image_label_from_xml, load_img_name_list

    names = dict.fromkeys(load_img_name_list(args.train_list)
                          + load_img_name_list(args.val_list))
    labels = {name: load_image_label_from_xml(name, args.voc12_root) for name in names}
    np.save(args.out, labels)
    print(f"saved {len(labels)} labels to {args.out}")


if __name__ == "__main__":
    main()
