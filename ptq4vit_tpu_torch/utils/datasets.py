"""Dataset / loader layer: a copy of ``ptq4vit_tpu/utils/datasets.py``
(numpy + PIL, no torchvision), the functional counterpart of the
reference's utils/datasets.py (hahnyuan/PTQ4ViT), with a thread-pool
decode pipeline (PIL and the native data plane release the GIL while they
decode, so ``num_workers`` threads keep the host busy while the card runs).

Loaders yield ``(x, y)`` numpy batches: x is NCHW float32 (normalized), or
uint8 with ``EvalTransform(raw_uint8=True)`` (pair it with
``Evaluator(data_config=...)``, which normalizes on the device); y is
int64 labels.

Key parity points:
  * ``calib_loader(num, seed=3)``: fixed-seed ``np.random.permutation``
    subset of the *train* split, served as ONE batch with the *test*
    transform (reference datasets.py:88-94);
  * ViT loaders resolve the per-model eval transform (resize shorter side
    to floor(size/crop_pct) bicubic -> center crop -> normalize), the
    timm resolve_data_config equivalent (reference datasets.py:325-341);
  * ``FasterImageNetLoaderGenerator`` caches the preprocessed test set in
    /dev/shm (reference datasets.py:247-268);
  * ``DebugLoaderGenerator`` serves one synthetic all-ones sample at tiny
    resolutions, names ``debug0..debug3`` (reference datasets.py:270-288).
"""
from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

try:
    from PIL import Image
    HAVE_PIL = True
except ImportError:  # pragma: no cover
    HAVE_PIL = False

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp")


def calculate_n_correct(outputs: np.ndarray, targets: np.ndarray) -> int:
    """Top-1 correct count (reference datasets.py:23-26)."""
    return int((np.argmax(outputs, axis=1) == np.asarray(targets)).sum())


# ---------------------------------------------------------------------------
# transforms (torchvision-equivalent semantics on PIL images)
# ---------------------------------------------------------------------------

class EvalTransform:
    """Resize shorter side -> center crop -> float32 CHW -> normalize.

    Matches torchvision Resize/CenterCrop/ToTensor/Normalize semantics and
    timm's eval transform: ``scale_size = floor(input_size / crop_pct)``.
    """

    def __init__(self, input_size: int, crop_pct: float = 0.875,
                 mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD,
                 interpolation: str = "bicubic", raw_uint8: bool = False,
                 use_native: str = "auto"):
        # raw_uint8: skip normalization and return uint8 CHW — 4x less
        # host->device traffic; pair with Evaluator(data_config=...) which
        # normalizes on-device
        self.raw_uint8 = raw_uint8
        # use_native: "auto" routes bicubic non-raw transforms through the
        # C++ data plane (ptq4vit_tpu_torch/native: libjpeg decode + Pillow-
        # bit-exact resample) when the toolchain is available
        self._native = False
        if use_native != "never" and interpolation == "bicubic"                 and not raw_uint8:
            try:
                from .. import native
                self._native = native.available()
            except Exception:
                self._native = False
        self.input_size = input_size
        self.scale_size = int(np.floor(input_size / crop_pct))
        self.mean = np.asarray(mean, np.float32).reshape(3, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(3, 1, 1)
        self.interpolation = {"bicubic": Image.BICUBIC,
                              "bilinear": Image.BILINEAR}[interpolation] \
            if HAVE_PIL else interpolation

    @property
    def wants_bytes(self) -> bool:
        """Datasets hand raw JPEG bytes to the native decode path."""
        return self._native

    def __call__(self, img) -> np.ndarray:
        if self._native:
            from .. import native
            if isinstance(img, (bytes, bytearray)):
                return native.decode_preprocess(
                    bytes(img), self.scale_size, self.input_size,
                    self.mean.ravel(), self.std.ravel())
            arr = np.asarray(img.convert("RGB"), np.uint8)
            return native.preprocess_rgb(arr, self.scale_size,
                                         self.input_size,
                                         self.mean.ravel(), self.std.ravel())
        img = img.convert("RGB")
        w, h = img.size
        # torchvision Resize(shorter-side) semantics
        if w <= h:
            ow, oh = self.scale_size, int(self.scale_size * h / w)
        else:
            oh, ow = self.scale_size, int(self.scale_size * w / h)
        img = img.resize((ow, oh), self.interpolation)
        # torchvision CenterCrop semantics
        left = int(round((ow - self.input_size) / 2.0))
        top = int(round((oh - self.input_size) / 2.0))
        img = img.crop((left, top, left + self.input_size,
                        top + self.input_size))
        if self.raw_uint8:
            return np.asarray(img, np.uint8).transpose(2, 0, 1)
        x = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
        return (x - self.mean) / self.std


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

class ImageFolderDataset:
    """torchvision.datasets.ImageFolder equivalent: class-per-subdirectory,
    classes sorted, labels by sorted index."""

    def __init__(self, root: str, transform: Optional[Callable] = None):
        self.root = root
        self.transform = transform
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            d = os.path.join(root, c)
            for fn in sorted(os.listdir(d)):
                if fn.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append((os.path.join(d, fn),
                                         self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int):
        path, label = self.samples[idx]
        try:
            if (getattr(self.transform, "wants_bytes", False)
                    and path.lower().endswith((".jpg", ".jpeg"))):
                with open(path, "rb") as f:
                    return self.transform(f.read()), label
            img = Image.open(path)
            x = self.transform(img) if self.transform else np.asarray(img)
        except Exception as e:
            raise ValueError(f"failed to load '{path}': {e}") from e
        return x, label


class ArrayDataset:
    """In-memory (datas, targets) dataset (reference CacheDataset,
    datasets.py:235-246)."""

    def __init__(self, datas: np.ndarray, targets: np.ndarray,
                 transform: Optional[Callable] = None):
        self.datas = datas
        self.targets = targets
        self.transform = transform

    def __len__(self):
        return len(self.datas)

    def __getitem__(self, idx: int):
        x = self.datas[idx]
        if self.transform is not None:
            x = self.transform(x)
        return x, self.targets[idx]


class SubsetDataset:
    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx: int):
        return self.dataset[self.indices[idx]]


class Loader:
    """Batched iterator with thread-pool decode and one-batch prefetch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 8, drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed).permutation(n)
        batches = [order[s:s + self.batch_size]
                   for s in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        from collections import deque
        PREFETCH = 2  # batches in flight
        with ThreadPoolExecutor(self.num_workers) as pool:
            window = deque()
            bi = 0
            while bi < len(batches) or window:
                while bi < len(batches) and len(window) < PREFETCH:
                    window.append([pool.submit(self.dataset.__getitem__,
                                               int(i)) for i in batches[bi]])
                    bi += 1
                futs = window.popleft()
                items = [f.result() for f in futs]
                xs = np.stack([np.asarray(x) for x, _ in items])
                if xs.dtype not in (np.uint8,):
                    xs = xs.astype(np.float32)
                ys = np.asarray([y for _, y in items], np.int64)
                yield xs, ys


# ---------------------------------------------------------------------------
# loader generators (reference datasets.py:35-341)
# ---------------------------------------------------------------------------

class SetSplittor:
    """Train/val split helper — the reference ships this as an empty stub
    (datasets.py:28-33); kept for API parity."""

    def __init__(self, fraction: float = 0.2):
        self.fraction = fraction

    def split(self, dataset):
        n = len(dataset)
        n_val = int(n * self.fraction)
        idx = np.random.permutation(n)
        return (SubsetDataset(dataset, idx[n_val:]),
                SubsetDataset(dataset, idx[:n_val]))


class LoaderGenerator:
    """Base loader factory (reference datasets.py:35-94)."""

    def __init__(self, root: str, dataset_name: str, train_batch_size=1,
                 test_batch_size=1, num_workers=8, kwargs=None):
        self.root = root
        self.dataset_name = str.lower(dataset_name)
        self.train_batch_size = train_batch_size
        self.test_batch_size = test_batch_size
        self.num_workers = num_workers
        self.kwargs = kwargs or {}
        self._train_set = None
        self._test_set = None
        self._calib_set = None
        self.train_transform = None
        self.test_transform = None
        self.load()

    def load(self):
        pass

    @property
    def train_set(self):
        raise NotImplementedError

    @property
    def test_set(self):
        raise NotImplementedError

    def train_loader(self):
        return Loader(self.train_set, self.train_batch_size, shuffle=True,
                      num_workers=self.num_workers)

    def test_loader(self, shuffle=False, batch_size=None):
        return Loader(self.test_set, batch_size or self.test_batch_size,
                      shuffle=shuffle, num_workers=self.num_workers)

    def val_loader(self):
        assert getattr(self, "val_set", None) is not None
        return Loader(self.val_set, self.test_batch_size, shuffle=False,
                      num_workers=self.num_workers)

    def calib_loader(self, num=1024, seed=3):
        """Fixed-seed train-split subset served as one batch with the test
        transform (reference datasets.py:88-94)."""
        if self._calib_set is None:
            np.random.seed(seed)
            inds = np.random.permutation(len(self.train_set))[:num]
            base = self._train_set_with_test_transform()
            self._calib_set = SubsetDataset(base, inds)
        return Loader(self._calib_set, batch_size=num, shuffle=False,
                      num_workers=self.num_workers)

    def calib_batch(self, num=1024, seed=3) -> np.ndarray:
        """Convenience: the single (num, C, H, W) calibration array."""
        for x, _ in self.calib_loader(num=num, seed=seed):
            return x
        raise RuntimeError("empty calibration set")

    def _train_set_with_test_transform(self):
        raise NotImplementedError


class ImageNetLoaderGenerator(LoaderGenerator):
    """ImageFolder-based ImageNet with fixed 224 transforms
    (reference datasets.py:204-233; eval = Resize(256) + CenterCrop(224),
    bilinear like torchvision's default)."""

    def load(self):
        self.test_transform = EvalTransform(224, crop_pct=224 / 256,
                                            interpolation="bilinear")
        self.train_transform = self.test_transform  # eval-only pipeline

    @property
    def train_set(self):
        if self._train_set is None:
            self._train_set = ImageFolderDataset(
                os.path.join(self.root, "train"), self.train_transform)
        return self._train_set

    @property
    def test_set(self):
        if self._test_set is None:
            self._test_set = ImageFolderDataset(
                os.path.join(self.root, "val"), self.test_transform)
        return self._test_set

    def _train_set_with_test_transform(self):
        return ImageFolderDataset(os.path.join(self.root, "train"),
                                  self.test_transform)


class ViTImageNetLoaderGenerator(ImageNetLoaderGenerator):
    """Per-model transform resolution (reference datasets.py:325-341).
    ``kwargs={"model": net}`` where net is a models.registry.Net — its
    ``data_config`` carries the timm default_cfg equivalents."""

    def load(self):
        net = self.kwargs.get("model", None)
        assert net is not None, "No model in ViTImageNetLoaderGenerator!"
        dc = net.data_config
        self.test_transform = EvalTransform(
            dc.input_size, crop_pct=dc.crop_pct, mean=dc.mean, std=dc.std,
            interpolation=dc.interpolation)
        self.train_transform = self.test_transform


class FasterImageNetLoaderGenerator(ViTImageNetLoaderGenerator):
    """/dev/shm-cached preprocessed test set (reference datasets.py:247-268)."""

    def test_loader(self, shuffle=False, batch_size=None):
        cache = self.kwargs.get("cache_path",
                                "/dev/shm/ptq4vit_tpu_torch_imagenet.npz")
        bs = batch_size or self.test_batch_size
        if os.path.exists(cache):
            z = np.load(cache)
            datas, targets = z["datas"], z["targets"]
        else:
            datas, targets = [], []
            for x, y in super().test_loader(shuffle=False, batch_size=bs):
                datas.append(x)
                targets.append(y)
            datas = np.concatenate(datas, 0)
            targets = np.concatenate(targets, 0)
            np.savez(cache, datas=datas, targets=targets)
        return Loader(ArrayDataset(datas, targets), bs, shuffle=shuffle,
                      num_workers=self.num_workers)


class CIFARLoaderGenerator(LoaderGenerator):
    """CIFAR-10/100 from the standard python pickle batches on disk
    (reference datasets.py:96-128; no download — zero-egress environment)."""

    _STATS = {
        "cifar100": ((0.5071, 0.4865, 0.4409), (0.2673, 0.2564, 0.2762)),
        "cifar10": ((0.4914, 0.4822, 0.4465), (0.2470, 0.2435, 0.2616)),
    }

    def load(self):
        if self.dataset_name not in self._STATS:
            raise NotImplementedError(self.dataset_name)
        mean, std = self._STATS[self.dataset_name]
        m = np.asarray(mean, np.float32).reshape(3, 1, 1)
        s = np.asarray(std, np.float32).reshape(3, 1, 1)
        self.test_transform = lambda x: (x.astype(np.float32) / 255.0 - m) / s
        self.train_transform = self.test_transform

    def _load_split(self, train: bool):
        import pickle
        if self.dataset_name == "cifar10":
            sub = "cifar-10-batches-py"
            files = ([f"data_batch_{i}" for i in range(1, 6)] if train
                     else ["test_batch"])
            key = b"labels"
        else:
            sub = "cifar-100-python"
            files = ["train"] if train else ["test"]
            key = b"fine_labels"
        xs, ys = [], []
        for fn in files:
            with open(os.path.join(self.root, sub, fn), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"].reshape(-1, 3, 32, 32))
            ys.extend(d[key])
        return ArrayDataset(np.concatenate(xs), np.asarray(ys, np.int64),
                            self.test_transform)

    @property
    def train_set(self):
        if self._train_set is None:
            self._train_set = self._load_split(True)
        return self._train_set

    @property
    def test_set(self):
        if self._test_set is None:
            self._test_set = self._load_split(False)
        return self._test_set

    def _train_set_with_test_transform(self):
        return self.train_set


class DebugLoaderGenerator(LoaderGenerator):
    """One synthetic all-ones sample at tiny resolutions, dataset names
    ``debug0..debug3`` (reference datasets.py:270-288)."""

    _SIZES = {"0": (1, 4, 4), "1": (1, 8, 8), "2": (1, 1, 1), "3": (1, 3, 3)}

    def load(self):
        version = re.findall(r"\d+", self.dataset_name)[0]
        if version not in self._SIZES:
            raise NotImplementedError(
                f"version {version} of Debug dataset is not supported")
        shape = self._SIZES[version]
        data = np.ones((1,) + shape, np.float32)
        self._train_set = ArrayDataset(data, np.zeros((1,), np.int64))
        self._test_set = ArrayDataset(data, np.zeros((1,), np.int64))

    @property
    def train_set(self):
        return self._train_set

    @property
    def test_set(self):
        return self._test_set

    def _train_set_with_test_transform(self):
        return self._train_set


class DetectionListDataset:
    """YOLO-style detection list dataset (reference datasets.py:138-196):
    image paths from a list file, labels in sibling ``labels/*.txt``
    (class, cx, cy, w, h).  Images letterbox-resized to ``img_size``."""

    def __init__(self, list_path: str, img_size: int = 416):
        with open(list_path) as f:
            self.img_files = [p.strip() for p in f.readlines() if p.strip()]
        self.label_files = [
            p.replace("images", "labels").replace(".png", ".txt")
            .replace(".jpg", ".txt") for p in self.img_files]
        self.img_size = img_size

    def __len__(self):
        return len(self.img_files)

    def __getitem__(self, idx: int):
        img = Image.open(self.img_files[idx]).convert("RGB") \
            .resize((self.img_size, self.img_size), Image.NEAREST)
        x = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
        try:
            boxes = np.loadtxt(self.label_files[idx]).reshape(-1, 5)
        except OSError:
            boxes = np.zeros((0, 5), np.float32)
        return x, boxes


class COCOLoaderGenerator(LoaderGenerator):
    """COCO detection lists (reference datasets.py:130-136): train list
    ``trainvalno5k.txt``, test list ``5k.txt``."""

    @property
    def train_set(self):
        if self._train_set is None:
            self._train_set = DetectionListDataset(
                os.path.join(self.root, "trainvalno5k.txt"))
        return self._train_set

    @property
    def test_set(self):
        if self._test_set is None:
            self._test_set = DetectionListDataset(
                os.path.join(self.root, "5k.txt"))
        return self._test_set

    def _train_set_with_test_transform(self):
        return self.train_set


def get_dataset(args):
    """Dataset dispatcher (reference datasets.py:290-317).  args needs
    ``dataset``; optional dataset_root/num_workers/batch_size/..."""
    name = str.lower(args.dataset)
    root = getattr(args, "dataset_root", "./datasets")
    workers = getattr(args, "num_workers", 4)
    bs = getattr(args, "batch_size", 64)
    tbs = getattr(args, "test_batch_size", bs)
    if "cifar" in name:
        g = CIFARLoaderGenerator(root, args.dataset, bs, tbs, workers)
    elif "coco" in name:
        g = COCOLoaderGenerator(root, args.dataset, bs, tbs, workers)
    elif "debug" in name:
        g = DebugLoaderGenerator(root, args.dataset, bs, tbs, workers)
    elif args.dataset == "ImageNet":
        g = ImageNetLoaderGenerator(root, args.dataset, bs, tbs, workers)
    else:
        raise NotImplementedError(name)
    return g.train_loader(), g.test_loader()
