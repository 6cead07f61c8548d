"""Dataset loading without torchvision (no network).

The port's copy of ``dopt.data.datasets``: raw MNIST/FMNIST IDX files,
CIFAR-10/100 python pickles and LIBSVM a9a text from a local directory
(``data_dir`` or ``$DOPT_DATA_DIR``), or the deterministic learnable
synthetic set when no raw files exist.  Every array is bit for bit the
one dopt produces: float32 NHWC features (``[N, D]`` for a9a), int32
labels.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

# Reference normalisation constants (P1 utils.py:100-110).
_NORM = {
    "mnist": ((0.1307,), (0.3081,)),
    "fmnist": ((0.5,), (0.5,)),
    "cifar10": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    "cifar100": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
}


@dataclass(frozen=True)
class Dataset:
    """A fully-materialised split pair: features are NHWC float32 (or
    [N, D] for tabular), labels int32."""

    name: str
    train_x: np.ndarray
    train_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray

    @property
    def num_classes(self) -> int:
        return int(max(self.train_y.max(), self.test_y.max())) + 1

    @property
    def input_shape(self) -> tuple[int, ...]:
        return tuple(self.train_x.shape[1:])


# --------------------------------------------------------------------
# Raw-format parsers
# --------------------------------------------------------------------

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
    """File discovery under a data root: one recursive walk per
    ``load_dataset`` call (cached for that call only, so files added
    between calls are seen), with dataset-name-aware ranking — under a
    shared root holding both ``MNIST/raw/`` and ``FashionMNIST/raw/``
    (identical IDX filenames, torchvision layout) the path whose parents
    mention the requested dataset wins."""

    def __init__(self, data_dir: Path, prefer: tuple[str, ...] = (),
                 avoid=()):
        """``avoid`` is a tuple of substrings or a predicate on the
        lower-cased path string; avoided-only hits count as missing."""
        self.data_dir = data_dir
        self.prefer = tuple(t.lower() for t in prefer)
        if callable(avoid):
            self._avoided = avoid
        else:
            toks = tuple(t.lower() for t in avoid)
            self._avoided = (lambda s: any(t in s for t in toks)) if toks else (lambda s: False)
        self._table: dict[str, list[Path]] | None = None

    def _listing(self) -> dict[str, list[Path]]:
        if self._table is None:
            table: dict[str, list[Path]] = {}
            for p in sorted(self.data_dir.rglob("*")):
                if p.is_file():
                    table.setdefault(p.name, []).append(p)
            self._table = table
        return self._table

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
                    # every hit sits under an avoided name -> the wrong
                    # dataset's files; treat as missing
                    continue
                return min(hits, key=self._rank)
        return None


def _find(data_dir: Path, names: list[str]) -> Path | None:
    return _Finder(data_dir).find(names)


def _load_mnist_like(name: str, data_dir: Path) -> Dataset | None:
    files = {
        "train_x": ["train-images-idx3-ubyte", "train-images.idx3-ubyte"],
        "train_y": ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"],
        "test_x": ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"],
        "test_y": ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"],
    }
    if name == "mnist":
        finder = _Finder(data_dir, prefer=("mnist",), avoid=("fashion", "fmnist"))
    else:
        # "mnist" is a substring of "fashionmnist", so express the avoid
        # rule as a predicate: a path that mentions mnist but not fashion.
        finder = _Finder(
            data_dir, prefer=("fashion", "fmnist"),
            avoid=lambda s: "mnist" in s and "fashion" not in s and "fmnist" not in s,
        )
    paths = {k: finder.find(v) for k, v in files.items()}
    if any(p is None for p in paths.values()):
        return None
    mean, std = _NORM[name]
    xs = {}
    for split in ("train", "test"):
        x = _read_idx(paths[f"{split}_x"]).astype(np.float32) / 255.0
        x = (x - mean[0]) / std[0]
        xs[split] = x[..., None]  # NHWC
    return Dataset(
        name=name,
        train_x=xs["train"],
        train_y=_read_idx(paths["train_y"]).astype(np.int32),
        test_x=xs["test"],
        test_y=_read_idx(paths["test_y"]).astype(np.int32),
    )


def _load_cifar(name: str, data_dir: Path) -> Dataset | None:
    if name == "cifar10":
        batch_names = [f"data_batch_{i}" for i in range(1, 6)]
        test_names = ["test_batch"]
        label_key = b"labels"
    else:
        batch_names = ["train"]
        test_names = ["test"]
        label_key = b"fine_labels"

    finder = _Finder(data_dir, prefer=("cifar-100" if name == "cifar100" else "cifar-10",),
                     avoid=("cifar-100",) if name == "cifar10" else ())

    def read(names):
        xs, ys = [], []
        for n in names:
            p = finder.find([n])
            if p is None:
                return None, None
            with open(p, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.extend(d[label_key])
        return np.concatenate(xs), np.asarray(ys, dtype=np.int32)

    train_x, train_y = read(batch_names)
    test_x, test_y = read(test_names)
    if train_x is None or test_x is None:
        return None
    mean, std = _NORM[name]
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)

    def to_nhwc(x):
        x = x.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32) / 255.0
        return (x - mean_a) / std_a

    return Dataset(name, to_nhwc(train_x), train_y, to_nhwc(test_x), test_y)


def _load_a9a(data_dir: Path) -> Dataset | None:
    """LIBSVM a9a: 123 binary features, labels ±1 → {0,1} (the ADMM
    logistic-regression benchmark config, BASELINE.json config 4)."""
    train_p = _find(data_dir, ["a9a", "a9a.txt", "a9a.train"])
    test_p = _find(data_dir, ["a9a.t", "a9a.test"])
    if train_p is None:
        return None

    def parse(path: Path, d: int = 123):
        xs, ys = [], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                ys.append(1 if float(parts[0]) > 0 else 0)
                row = np.zeros(d, np.float32)
                for tok in parts[1:]:
                    idx, val = tok.split(":")
                    row[int(idx) - 1] = float(val)
                xs.append(row)
        return np.stack(xs), np.asarray(ys, np.int32)

    train_x, train_y = parse(train_p)
    if test_p is not None:
        test_x, test_y = parse(test_p)
    else:
        # Shuffle before the 80/20 cut: LIBSVM dumps are often
        # label-sorted, and an ordered cut would skew the test split.
        n = len(train_x)
        perm = np.random.default_rng(0).permutation(n)
        train_x, train_y = train_x[perm], train_y[perm]
        cut = int(0.8 * n)
        train_x, test_x = train_x[:cut], train_x[cut:]
        train_y, test_y = train_y[:cut], train_y[cut:]
    return Dataset("a9a", train_x, train_y, test_x, test_y)


# --------------------------------------------------------------------
# Synthetic fallback
# --------------------------------------------------------------------

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
    """Deterministic learnable classification data.

    Each class gets a random smooth prototype in feature space; samples
    are prototype + Gaussian noise.  Linearly separable enough that both
    an MLP and the reference CNNs reach high accuracy in a few epochs,
    so training-curve smoke tests are meaningful without real data.
    """
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


# --------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------

def load_dataset(
    dataset: str,
    *,
    data_dir: str | os.PathLike | None = None,
    synthetic_fallback: bool = True,
    train_size: int = 2048,
    test_size: int = 512,
    seed: int = 0,
    input_shape: tuple[int, ...] | None = None,
    num_classes: int | None = None,
) -> Dataset:
    """Load a dataset by name (reference ``get_dataset`` equivalent).

    Looks for raw files under ``data_dir`` (or ``$DOPT_DATA_DIR``); if
    absent and ``synthetic_fallback``, returns a shape-compatible
    synthetic dataset so the full pipeline still runs offline.
    """
    name = dataset.lower()
    if name in ("cifar",):
        name = "cifar10"
    roots = []
    if data_dir is not None:
        roots.append(Path(data_dir))
    if os.environ.get("DOPT_DATA_DIR"):
        roots.append(Path(os.environ["DOPT_DATA_DIR"]))

    shapes = {
        "mnist": ((28, 28, 1), 10),
        "fmnist": ((28, 28, 1), 10),
        "cifar10": ((32, 32, 3), 10),
        "cifar100": ((32, 32, 3), 100),
        "a9a": ((123,), 2),
    }

    for root in roots:
        if not root.exists():
            continue
        ds = None
        if name in ("mnist", "fmnist"):
            ds = _load_mnist_like(name, root)
        elif name in ("cifar10", "cifar100"):
            ds = _load_cifar(name, root)
        elif name == "a9a":
            ds = _load_a9a(root)
        if ds is not None:
            return ds

    if name == "synthetic" or (synthetic_fallback and name in shapes):
        if name == "synthetic":
            shape = input_shape or (28, 28, 1)
            ncls = num_classes or 10
        else:
            shape, ncls = shapes[name]
        return make_synthetic(
            input_shape=shape, num_classes=ncls, train_size=train_size,
            test_size=test_size, seed=seed, name=f"synthetic[{name}]",
        )
    raise FileNotFoundError(
        f"no raw files for {dataset!r} under {roots or '$DOPT_DATA_DIR'} "
        "and synthetic_fallback is off"
    )
