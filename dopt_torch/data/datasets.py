"""Dataset loading without torchvision (no network).

The port's copy of ``dopt.data.datasets`` for the slice's datasets:
raw MNIST IDX files from a local directory, or the
deterministic learnable synthetic set when no raw files exist.  Both
produce the same float32 NHWC arrays as dopt, bit for bit.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

# Reference MNIST normalisation (P1 utils.py:100-110).
_MNIST_MEAN, _MNIST_STD = 0.1307, 0.3081


@dataclass(frozen=True)
class Dataset:
    """A fully-materialised split pair: features NHWC float32, labels int32."""

    name: str
    train_x: np.ndarray
    train_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray


def _read_idx(path: Path) -> np.ndarray:
    """Parse an IDX file (the raw MNIST/FMNIST format), gzipped or not."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


class _Finder:
    """File discovery under a data root: one recursive walk per load,
    ranking paths whose parents mention the requested dataset first
    (MNIST and FashionMNIST share their IDX file names).  Hits whose
    path mentions only ``avoid`` substrings count as missing."""

    def __init__(self, data_dir: Path, prefer: tuple[str, ...] = (),
                 avoid: tuple[str, ...] = ()):
        self.data_dir = data_dir
        self.prefer = prefer
        self.avoid = avoid
        self._table: dict[str, list[Path]] | None = None

    def _listing(self) -> dict[str, list[Path]]:
        if self._table is None:
            table: dict[str, list[Path]] = {}
            for p in sorted(self.data_dir.rglob("*")):
                if p.is_file():
                    table.setdefault(p.name, []).append(p)
            self._table = table
        return self._table

    def _avoided(self, s: str) -> bool:
        return any(t in s for t in self.avoid)

    def _rank(self, p: Path) -> tuple[int, int]:
        s = str(p).lower()
        preferred = any(t in s for t in self.prefer)
        return (0 if preferred else 1, 1 if self._avoided(s) else 0)

    def find(self, names: list[str]) -> Path | None:
        for name in names:
            for cand in (self.data_dir / name, self.data_dir / (name + ".gz")):
                if cand.is_file():
                    return cand
            table = self._listing()
            hits = table.get(name, []) + table.get(name + ".gz", [])
            if hits:
                if all(self._avoided(str(h).lower()) for h in hits):
                    continue
                return min(hits, key=self._rank)
        return None


def _load_mnist(data_dir: Path) -> Dataset | None:
    files = {
        "train_x": ["train-images-idx3-ubyte", "train-images.idx3-ubyte"],
        "train_y": ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"],
        "test_x": ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"],
        "test_y": ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"],
    }
    finder = _Finder(data_dir, prefer=("mnist",), avoid=("fashion", "fmnist"))
    paths = {k: finder.find(v) for k, v in files.items()}
    if any(p is None for p in paths.values()):
        return None
    xs = {}
    for split in ("train", "test"):
        x = _read_idx(paths[f"{split}_x"]).astype(np.float32) / 255.0
        x = (x - _MNIST_MEAN) / _MNIST_STD
        xs[split] = x[..., None]  # NHWC
    return Dataset(
        name="mnist",
        train_x=xs["train"],
        train_y=_read_idx(paths["train_y"]).astype(np.int32),
        test_x=xs["test"],
        test_y=_read_idx(paths["test_y"]).astype(np.int32),
    )


def make_synthetic(
    *,
    input_shape: tuple[int, ...] = (28, 28, 1),
    num_classes: int = 10,
    train_size: int = 2048,
    test_size: int = 512,
    seed: int = 0,
    noise: float = 0.7,
    name: str = "synthetic",
) -> Dataset:
    """Deterministic learnable classification data: one random prototype
    per class plus Gaussian noise (dopt's exact draws)."""
    rng = np.random.default_rng(seed)
    dim = int(np.prod(input_shape))
    protos = rng.normal(0.0, 1.0, size=(num_classes, dim)).astype(np.float32)

    def split(n, salt):
        r = np.random.default_rng(seed * 7919 + salt)
        y = r.integers(0, num_classes, size=n).astype(np.int32)
        x = protos[y] + r.normal(0.0, noise, size=(n, dim)).astype(np.float32)
        return x.reshape((n, *input_shape)).astype(np.float32), y

    train_x, train_y = split(train_size, 1)
    test_x, test_y = split(test_size, 2)
    return Dataset(name, train_x, train_y, test_x, test_y)


def load_dataset(
    dataset: str,
    *,
    data_dir: str | os.PathLike | None = None,
    train_size: int = 2048,
    test_size: int = 512,
    seed: int = 0,
    input_shape: tuple[int, ...] | None = None,
    num_classes: int | None = None,
) -> Dataset:
    """Load a dataset by name: raw IDX files under ``data_dir`` (or
    ``$DOPT_DATA_DIR``), else the shape-compatible synthetic set."""
    name = dataset.lower()
    if name not in ("mnist", "synthetic"):
        raise ValueError(
            f"dataset {dataset!r} is not in the PyTorch port yet (mnist "
            "and synthetic are; FMNIST, CIFAR and a9a arrive with the "
            "model zoo slice)")
    roots = []
    if data_dir is not None:
        roots.append(Path(data_dir))
    if os.environ.get("DOPT_DATA_DIR"):
        roots.append(Path(os.environ["DOPT_DATA_DIR"]))
    if name == "mnist":
        for root in roots:
            if root.exists():
                ds = _load_mnist(root)
                if ds is not None:
                    return ds
        shape, ncls = (28, 28, 1), 10
    else:
        shape = input_shape or (28, 28, 1)
        ncls = num_classes or 10
    return make_synthetic(input_shape=shape, num_classes=ncls,
                          train_size=train_size, test_size=test_size,
                          seed=seed, name=f"synthetic[{name}]")
