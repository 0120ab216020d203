"""YOLO dataset + prefetching host loader: a copy of
yolo_re_tpu/data/dataset.py, the multi-process `shard=` split and the
native host kernels' dispatch (`YOLO_TPU_NATIVE`, utils/native.py)
included. tests/test_torch_eval.py and tests/test_torch_parallel.py pin
the batches equal to the JAX package's on cv2, tests/test_torch_native.py
under the native switch.

Dataset semantics follow the reference (src/yolo/data/dataset.py): file
discovery by extension rglob or .txt list, the images/ -> labels/ path
convention, label caching, rect batching, RAM/disk image caches. The
*loader* is rebuilt for TPU feeding:

- torch DataLoader worker processes are replaced by a thread pool
  (cv2/numpy release the GIL) with per-sample counter-based RNG — fully
  deterministic given (seed, epoch, index), unlike the reference's global
  random state,
- batches come out TPU-ready: NHWC float32 RGB images in [0, 1] and GT
  padded to a **static** (B, max_boxes, 5) so the jitted train step never
  recompiles,
- double-buffered prefetch overlaps host augmentation with device compute.
"""

from __future__ import annotations

import hashlib
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np

from yolo_re_tpu_torch.data.augment import letterbox, xywhn2xyxy, xyxy2xywhn
from yolo_re_tpu_torch.data.config import CacheMode, DataConfig
from yolo_re_tpu_torch.data.transforms import (
    Compose,
    Sample,
    default_train_transforms,
    default_val_transforms,
)
from yolo_re_tpu_torch.parallel.mesh import local_rows
from yolo_re_tpu_torch.utils import native

IMG_EXTENSIONS = (".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp")

# Avoid cv2-internal threading fighting with loader threads.
cv2.setNumThreads(0)


def _img2label_path(img_path: str) -> str:
    """images/ -> labels/, ext -> .txt (reference: dataset.py:113-124)."""
    sa = f"{os.sep}images{os.sep}"
    sb = f"{os.sep}labels{os.sep}"
    parts = img_path.rsplit(sa, 1)
    stem = sb.join(parts) if len(parts) == 2 else img_path
    return os.path.splitext(stem)[0] + ".txt"


class YOLODataset:
    """Image+label dataset (reference: src/yolo/data/dataset.py:29-313)."""

    def __init__(
        self,
        path: str | Path,
        img_size: int = 640,
        augment: bool = False,
        transforms: Compose | None = None,
        cache: CacheMode = CacheMode.NONE,
        rect: bool = False,
        batch_size: int = 16,
        stride: int = 32,
        pad: float = 0.5,
        seed: int = 6148914691236517205 % (2**32),
    ):
        self.path = Path(path)
        self.img_size = img_size
        self.augment = augment
        self.cache = cache
        self.rect = rect
        self.batch_size = batch_size
        self.stride = stride
        self.pad = pad
        self.seed = seed
        self.epoch = 0

        self.img_files = self._find_images()
        if not self.img_files:
            raise FileNotFoundError(f"No images found in {path}")
        self.label_files = [_img2label_path(p) for p in self.img_files]
        self.labels, self.shapes = self._load_labels()
        self.indices = np.arange(len(self.img_files))

        self._ram_cache: dict[int, tuple[np.ndarray, tuple[int, int]]] = {}
        self._disk_dir: Path | None = None
        if cache == CacheMode.DISK:
            self._disk_dir = self.path.parent / f".{self.path.name}_npy_cache"
            self._disk_dir.mkdir(exist_ok=True)

        if rect:
            self._setup_rect()

        self.transforms = transforms

    # -- discovery / labels -------------------------------------------------

    def _find_images(self) -> list[str]:
        """Reference: dataset.py:100-111."""
        p = self.path
        if p.is_dir():
            files = sorted(
                str(f) for f in p.rglob("*")
                if f.suffix.lower() in IMG_EXTENSIONS)
        elif p.is_file() and p.suffix == ".txt":
            base = p.parent
            files = []
            for line in p.read_text().splitlines():
                line = line.strip()
                if not line:
                    continue
                fp = Path(line)
                files.append(str(fp if fp.is_absolute() else base / fp))
            files.sort()
        else:
            raise FileNotFoundError(f"{p} is neither a directory nor a .txt list")
        return files

    def _cache_path(self) -> Path:
        return self.path.parent / f".{self.path.name}.cache.npy"

    def _cache_key(self) -> str:
        """md5 over total size + paths (reference: dataset.py:150-181)."""
        total = 0
        for f in self.img_files:
            try:
                total += os.path.getsize(f)
            except OSError:
                pass
        h = hashlib.md5(str(total).encode())
        h.update("".join(self.img_files).encode())
        return h.hexdigest()

    def _load_labels(self):
        cache_path = self._cache_path()
        key = self._cache_key()
        if cache_path.exists():
            try:
                data = np.load(cache_path, allow_pickle=True).item()
                if data.get("key") == key:
                    return data["labels"], data["shapes"]
            except Exception:
                pass

        labels, shapes = [], []
        for img_file, label_file in zip(self.img_files, self.label_files):
            img = cv2.imread(img_file)
            if img is None:
                raise ValueError(f"Cannot read image {img_file}")
            shapes.append(img.shape[:2])  # (h, w)
            if os.path.exists(label_file):
                rows = []
                with open(label_file) as f:
                    for line in f:
                        vals = line.split()
                        if len(vals) >= 5:
                            rows.append([float(v) for v in vals[:5]])
                lab = (np.array(rows, dtype=np.float32) if rows
                       else np.zeros((0, 5), np.float32))
            else:
                lab = np.zeros((0, 5), np.float32)
            labels.append(lab)
        shapes = np.array(shapes, dtype=np.int64)

        try:
            np.save(cache_path, {"key": key, "labels": labels, "shapes": shapes})
            if cache_path.with_suffix(".npy.npy").exists():
                cache_path.with_suffix(".npy.npy").rename(cache_path)
        except OSError:
            pass
        return labels, shapes

    # -- rect mode -----------------------------------------------------------

    def _setup_rect(self):
        """Sort by aspect ratio, compute per-batch shapes rounded to stride
        (reference: dataset.py:183-216)."""
        n = len(self.img_files)
        bi = np.arange(n) // self.batch_size
        nb = bi[-1] + 1

        ar = self.shapes[:, 0] / self.shapes[:, 1]  # h / w
        irect = ar.argsort()
        self.img_files = [self.img_files[i] for i in irect]
        self.label_files = [self.label_files[i] for i in irect]
        self.labels = [self.labels[i] for i in irect]
        self.shapes = self.shapes[irect]
        ar = ar[irect]

        shapes = [[1.0, 1.0]] * nb
        for b in range(nb):
            ari = ar[bi == b]
            mini, maxi = ari.min(), ari.max()
            if maxi < 1:
                shapes[b] = [maxi, 1.0]
            elif mini > 1:
                shapes[b] = [1.0, 1.0 / mini]
        self.batch_shapes = (np.ceil(
            np.array(shapes) * self.img_size / self.stride + self.pad
        ).astype(int) * self.stride)
        self.batch_index = bi

    # -- image loading -------------------------------------------------------

    def _load_image(self, idx: int):
        """Load + resize so max dim == img_size. Returns
        (img BGR, (h0, w0) original, (h, w) resized);
        reference: dataset.py:274-300."""
        if idx in self._ram_cache:
            img, (h0, w0) = self._ram_cache[idx]
            return img, (h0, w0), img.shape[:2]

        npy = (self._disk_dir / f"{idx}.npy") if self._disk_dir else None
        if npy is not None and npy.exists():
            img = np.load(npy)
            h0, w0 = self.shapes[idx]
            return img, (int(h0), int(w0)), img.shape[:2]

        img = cv2.imread(self.img_files[idx])
        if img is None:
            raise ValueError(f"Cannot read image {self.img_files[idx]}")
        h0, w0 = img.shape[:2]
        r = self.img_size / max(h0, w0)
        if r != 1:
            interp = cv2.INTER_LINEAR if (self.augment or r > 1) else cv2.INTER_AREA
            if interp == cv2.INTER_LINEAR and native.enabled():
                img = native.resize_bilinear(img, int(h0 * r), int(w0 * r))
            else:
                img = cv2.resize(img, (int(w0 * r), int(h0 * r)),
                                 interpolation=interp)

        if self.cache == CacheMode.RAM:
            self._ram_cache[idx] = (img, (h0, w0))
        elif npy is not None:
            np.save(npy, img)
        return img, (h0, w0), img.shape[:2]

    def load_raw(self, idx: int):
        """(resized BGR image, labels xywhn (n,5), resized (h,w)) —
        the Mosaic/MixUp source API."""
        img, _, hw = self._load_image(int(idx))
        return img, self.labels[int(idx)].copy(), hw

    # -- sample access -------------------------------------------------------

    def __len__(self):
        return len(self.img_files)

    def get_sample(self, idx: int, rng: np.random.Generator) -> Sample:
        img, (h0, w0), _ = self._load_image(idx)
        sample = Sample(img=img, labels=self.labels[idx].copy(),
                        img_size=self.img_size, original_shape=(h0, w0))
        if self.rect and hasattr(self, "batch_shapes"):
            # Rect mode: letterbox to this batch's stride-aligned shape
            # (reference: dataset.py:183-216). Bypasses self.transforms.
            shape = self.batch_shapes[self.batch_index[idx]]
            h, w = img.shape[:2]
            img, ratio, pad = letterbox(img, (int(shape[0]), int(shape[1])),
                                        auto=False, scaleup=False)
            labels = sample.labels
            if len(labels):
                labels = labels.copy()
                labels[:, 1:5] = xywhn2xyxy(labels[:, 1:5], ratio[0] * w,
                                            ratio[1] * h, pad[0], pad[1])
                labels[:, 1:5] = xyxy2xywhn(labels[:, 1:5], img.shape[1],
                                            img.shape[0], clip=True)
            return Sample(img, labels, self.img_size, (h0, w0))
        if self.transforms is not None:
            sample = self.transforms(sample, rng)
        return sample

    def set_epoch(self, epoch: int):
        """Advance the per-sample RNG stream for direct-indexing users."""
        self.epoch = epoch

    def __getitem__(self, idx: int):
        # Same counter-based (seed, epoch, index) stream as DataLoader, so
        # direct indexing is deterministic AND re-seedable per epoch.
        rng = np.random.default_rng(
            (self.seed * 1000003 + self.epoch * 131071 + int(idx)) % (2**32))
        return self.get_sample(idx, rng)


def to_tensor(sample: Sample) -> np.ndarray:
    """BGR uint8 HWC -> RGB float32 NHWC in [0,1] (reference: dataset.py:302-313
    produced CHW; NHWC is the TPU layout)."""
    img = cv2.cvtColor(sample.img, cv2.COLOR_BGR2RGB)
    return np.ascontiguousarray(img, dtype=np.float32) / 255.0


class DataLoader:
    """Deterministic, thread-pooled, double-buffered batch loader.

    Yields dict batches:
        images (B, H, W, 3) float32, targets (B, max_boxes, 5) float32
        [cls, xywhn; zero rows = padding], nboxes (B,) int32.
    """

    def __init__(self, dataset: YOLODataset, batch_size: int,
                 max_boxes: int = 128, shuffle: bool = False,
                 drop_last: bool = False, workers: int = 8,
                 seed: int = 6148914691236517205 % (2**32),
                 prefetch: int = 2, uint8_images: bool = False,
                 shard: tuple[int, int] | None = None):
        # uint8_images: emit (B, H, W, 3) uint8 RGB instead of float32/255 —
        # 4x less host->device transfer; the train step divides on device.
        #
        # shard=(index, count): multi-process data parallelism. batch_size
        # stays the GLOBAL batch; every process builds the identical
        # global batch order (same seed/epoch -> same permutation) and
        # loads only its batch_size/count slice of each global batch, so
        # process-local batches assemble into exactly the batches a
        # single-process run would see (and per-sample augmentation RNG,
        # keyed on the global index, is identical too). Partial final
        # batches are always dropped when sharded — they cannot slice
        # uniformly across processes.
        self.uint8_images = uint8_images
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_boxes = max(1, max_boxes)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.workers = max(1, workers)
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0
        if shard is not None:
            shard = tuple(shard)
            local_rows(batch_size, *shard)      # raises if it cannot split
        self.shard = shard

    def __len__(self):
        n = len(self.dataset)
        if self.shard is not None:
            return n // self.batch_size
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _index_batches(self):
        n = len(self.dataset)
        if self.shuffle and not self.dataset.rect:
            rng = np.random.default_rng((self.seed + self.epoch) % (2**32))
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        batches = []
        drop = self.drop_last or self.shard is not None
        stop = n - n % self.batch_size if drop else n
        for i in range(0, stop, self.batch_size):
            batches.append(order[i:i + self.batch_size])
        batches = [b for b in batches if len(b)]
        if self.shard is not None:
            rows = local_rows(self.batch_size, *self.shard)
            batches = [b[rows] for b in batches]
        return batches

    def _make_batch(self, indices, pool):
        def load_one(i):
            rng = np.random.default_rng(
                (self.seed * 1000003 + self.epoch * 131071 + int(i)) % (2**32))
            s = self.dataset.get_sample(int(i), rng)
            if self.uint8_images:
                img = cv2.cvtColor(s.img, cv2.COLOR_BGR2RGB)
                return np.ascontiguousarray(img), s.labels
            return to_tensor(s), s.labels

        results = list(pool.map(load_one, indices))
        imgs = np.stack([r[0] for r in results])
        targets = np.zeros((len(results), self.max_boxes, 5), np.float32)
        nboxes = np.zeros((len(results),), np.int32)
        for bi, (_, lab) in enumerate(results):
            k = min(len(lab), self.max_boxes)
            if k:
                targets[bi, :k] = lab[:k]
            nboxes[bi] = k
        return {"images": imgs, "targets": targets, "nboxes": nboxes}

    def __iter__(self):
        batches = self._index_batches()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            with ThreadPoolExecutor(self.workers) as pool:
                for idxs in batches:
                    q.put(self._make_batch(idxs, pool))
            q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        t.join()


def create_dataloader(
    path: str | Path,
    config: DataConfig,
    mode: str = "train",
    shard: tuple[int, int] | None = None,
) -> DataLoader:
    """Build dataset + loader from DataConfig
    (reference: src/yolo/data/dataset.py:330-399).

    shard=(process index, process count): this process's slice of every
    global batch of config.batch_size (`DataLoader`)."""
    is_train = mode == "train"
    dataset = YOLODataset(
        path,
        img_size=config.img_size,
        augment=is_train,
        cache=config.cache,
        rect=config.rect and not is_train,
        batch_size=config.batch_size,
        stride=config.stride,
    )
    if is_train:
        dataset.transforms = default_train_transforms(
            dataset, config.img_size, config.augment)
    else:
        dataset.transforms = default_val_transforms(
            config.img_size, auto=False, stride=config.stride)
    return DataLoader(
        dataset,
        batch_size=config.batch_size,
        max_boxes=config.max_boxes,
        shuffle=is_train,
        drop_last=is_train,
        workers=config.workers,
        uint8_images=config.uint8_images,
        shard=shard,
    )
