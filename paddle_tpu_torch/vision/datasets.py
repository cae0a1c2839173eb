"""Vision datasets (the port's copy of paddle_tpu/vision/datasets.py:
MNIST, FashionMNIST, Cifar10, Cifar100, DatasetFolder).

Nothing is downloaded (`download=True` is accepted and fetches nothing):
a dataset reads the standard idx or pickle files where they already exist
(an explicit path, or the reference's cache directory
~/.cache/paddle_tpu/datasets), and otherwise makes the reference's
deterministic synthetic sample, bit for bit (the same seeds, shapes,
dtypes and cardinality; PADDLE_TPU_SYNTH_SAMPLES caps its size). Samples
are numpy arrays, so worker processes can load them."""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "DatasetFolder"]

_CACHE = os.path.expanduser("~/.cache/paddle_tpu/datasets")


def _synth_images(n, shape, num_classes, seed):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n).astype(np.int64)
    images = rng.randint(0, 256, (n,) + shape).astype(np.uint8)
    # make classes weakly separable so training curves move
    for c in range(num_classes):
        mask = labels == c
        images[mask, ..., : shape[-1] // 2] = (
            images[mask, ..., : shape[-1] // 2] // 4 + c * (200 // num_classes))
    return images, labels


class MNIST(Dataset):
    NUM_CLASSES = 10
    IMG_SHAPE = (28, 28)
    _SYN_TRAIN = 60000
    _SYN_TEST = 10000

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend="cv2"):
        self.mode = mode.lower()
        self.transform = transform
        self.backend = backend
        images, labels = self._load(image_path, label_path)
        self.images = images
        self.labels = labels

    def _load(self, image_path, label_path):
        name = type(self).__name__.lower()
        tag = "train" if self.mode == "train" else "t10k"
        img_p = image_path or os.path.join(_CACHE, name,
                                           f"{tag}-images-idx3-ubyte.gz")
        lab_p = label_path or os.path.join(_CACHE, name,
                                           f"{tag}-labels-idx1-ubyte.gz")
        if os.path.exists(img_p) and os.path.exists(lab_p):
            return self._read_idx(img_p, lab_p)
        n = self._SYN_TRAIN if self.mode == "train" else self._SYN_TEST
        # reduce synthetic size when quick mode requested
        env_n = os.environ.get("PADDLE_TPU_SYNTH_SAMPLES")
        if env_n:
            n = min(n, int(env_n))
        return _synth_images(n, self.IMG_SHAPE, self.NUM_CLASSES,
                             seed=42 if self.mode == "train" else 7)

    @staticmethod
    def _read_idx(img_p, lab_p):
        opener = gzip.open if img_p.endswith(".gz") else open
        with opener(img_p, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            images = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)
        with opener(lab_p, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            labels = np.frombuffer(f.read(), np.uint8).astype(np.int64)
        return images, labels

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32)[None] / 255.0
        return img, np.asarray(label, np.int64)

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    NUM_CLASSES = 10
    IMG_SHAPE = (32, 32, 3)

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="cv2"):
        self.mode = mode.lower()
        self.transform = transform
        n = 50000 if self.mode == "train" else 10000
        env_n = os.environ.get("PADDLE_TPU_SYNTH_SAMPLES")
        if data_file and os.path.exists(data_file):
            import pickle
            with open(data_file, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            self.images = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            self.labels = np.asarray(d[b"labels"], np.int64)
        else:
            if env_n:
                n = min(n, int(env_n))
            self.images, self.labels = _synth_images(
                n, self.IMG_SHAPE, self.NUM_CLASSES,
                seed=43 if self.mode == "train" else 8)

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32).transpose(2, 0, 1) / 255.0
        return img, np.asarray(label, np.int64)

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    NUM_CLASSES = 100


class DatasetFolder(Dataset):
    """Image-folder dataset (reference: vision/datasets/folder.py)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        extensions = extensions or (".png", ".jpg", ".jpeg", ".bmp", ".npy")
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(extensions):
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[c]))
        self.loader = loader or self._default_loader

    @staticmethod
    def _default_loader(path):
        if path.endswith(".npy"):
            return np.load(path)
        try:
            from PIL import Image
            return np.asarray(Image.open(path).convert("RGB"))
        except ImportError as e:
            raise RuntimeError("no image loader available for " + path) from e

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)
