"""The one traffic generator: every cell's inputs, from the parameters in its
workload file and the run's seed.

Every seed gets the same work in another order: each batch holds the same
counts of each image size (the mix's shares rounded to the batch by largest
remainder), and each pool of images the same counts of images with 1, 2, 3
... classes (the shares of a table of real labels, rounded to the pool); the
seed shuffles them, draws each image's label row from the table's rows of
its count, and draws the pixels.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.cam import MEAN, STD

NUM_FG = 20
LABELS = Path(__file__).resolve().parent / "labels"


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy stream of its own for each purpose, from any whole seed."""
    return np.random.default_rng([int(seed), *stream])


def torch_seed(seed: int, *stream: int) -> int:
    return int(rng(seed, *stream).integers(2**62))


def counts(mix, n: int) -> list:
    """[value] * count for each [value, share] of `mix`, the shares of `n`
    rounded by largest remainder (ties to the earlier entry)."""
    raw = [share * n for _, share in mix]
    got = [int(r) for r in raw]
    order = sorted(range(len(mix)), key=lambda i: (-(raw[i] - got[i]), i))
    for i in order[: n - sum(got)]:
        got[i] += 1
    return [v for (v, _), k in zip(mix, got) for _ in range(k)]


def per_batch(mix, batch: int, batches: int, g: np.random.Generator) -> list:
    """`batches` batches of the same composition, each shuffled."""
    out = []
    for _ in range(batches):
        b = counts(mix, batch)
        g.shuffle(b)
        out += b
    return out


def label_table(name: str) -> np.ndarray:
    """(images, 20) multi-hot rows of `benchmark/labels/<name>.csv` (columns
    `name,classes`, the classes 0-based and space-separated)."""
    lines = (LABELS / f"{name}.csv").read_text().splitlines()[1:]
    rows = np.zeros((len(lines), NUM_FG), np.float32)
    for i, line in enumerate(lines):
        rows[i, [int(c) for c in line.split(",")[1].split()]] = 1.0
    return rows


def labels(table: str, n: int, g: np.random.Generator) -> np.ndarray:
    """(n, 20) labels, rows of the table: as many images of each count of
    classes as the table's share of it rounded to `n`, each drawn from the
    table's rows of that count (distinct while they last), then shuffled."""
    rows = label_table(table)
    k = rows.sum(axis=1).astype(int)
    values, n_k = np.unique(k, return_counts=True)
    ks = counts(list(zip(values.tolist(), n_k / len(rows))), n)
    out = []
    for v in values:
        of_v = np.flatnonzero(k == v)
        want = ks.count(v)
        out.append(rows[g.choice(of_v, want, replace=want > len(of_v))])
    return np.concatenate(out)[g.permutation(n)]


def image(seed: int, i: int, h: int, w: int) -> np.ndarray:
    """A photo-like (h, w, 3) uint8 image: a coarse random colour grid,
    upsampled bicubic, with fine grain."""
    from PIL import Image

    g = rng(seed, 1, i)
    grid = Image.fromarray(g.integers(0, 256, (9, 12, 3), dtype=np.uint8))
    img = np.asarray(grid.resize((w, h), Image.BICUBIC), np.int16)
    img = img + g.integers(-10, 11, (h, w, 3), dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_voc(root: Path, seed: int, names, sizes, label_arr, threads: int = 4) -> None:
    """A VOC-style root: JPEGImages/<name>.jpg (quality 90) and cls_labels.npy
    ({name: (20,) labels}), overwriting what is there."""
    from PIL import Image

    jpeg = root / "JPEGImages"
    jpeg.mkdir(parents=True, exist_ok=True)

    def one(i):
        h, w = sizes[i]
        Image.fromarray(image(seed, i, h, w)).save(jpeg / f"{names[i]}.jpg", quality=90)

    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(one, range(len(names))))
    np.save(root / "cls_labels.npy", {n: label_arr[i] for i, n in enumerate(names)})


def crops(generator: torch.Generator, n: int, crop: int, device) -> torch.Tensor:
    """(n, crop, crop, 3) normalised photo-like crops, made on the device: a
    coarse random grid upsampled bicubic, with fine grain."""
    grid = torch.rand((n, 3, 14, 14), generator=generator, device=device)
    x = F.interpolate(grid, size=(crop, crop), mode="bicubic", align_corners=False)
    x = x + (torch.rand((n, 3, crop, crop), generator=generator, device=device) - 0.5) * 0.08
    x = x.clamp(0.0, 1.0)
    mean = torch.tensor(MEAN, device=device)[:, None, None]
    std = torch.tensor(STD, device=device)[:, None, None]
    return ((x - mean) / std).permute(0, 2, 3, 1).contiguous()
