"""Image ETL pipeline.

Counterpart of ``deeplearning4j_tpu/data/image.py`` (datavec-data-image:
``NativeImageLoader`` decode, ``ImageRecordReader`` with directory labels
from ``ParentPathLabelGenerator``, the ``ImageTransform`` augmentations and
``PipelineImageTransform`` chains), with the JAX package's pre-decoded
uint8 cache (``PreDecodedImageCache`` → ``CachedImageDataSetIterator``) and
its video and frame-directory readers. A copy: decode and augmentation are
host numpy and Pillow, and the seeded per-image augmentation gives the JAX
package's exact crops and flips. With ``uint8_wire=True`` (or
``dtype=np.uint8`` on the cached iterator) batches stay HWC uint8, and the
cast, scaling and NCHW layout run on the card
(``data.normalizers.make_device_ingest``).

Transforms operate on HWC uint8 numpy arrays (the decode layout); the
reader converts to CHW float at the end. Pillow is imported where an image
is decoded or resized; without it those calls raise an ``ImportError``
that names it.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..common.environment import host_cpu_count
from .dataset import DataSet
from .iterators import DataSetIterator
from .records import InputSplit, LabeledFileRecordReader

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif")


def _pil():
    """``PIL.Image``, or an ImportError that names Pillow."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("image decode and resize need Pillow (the PIL package), "
                          "which this Python does not have") from e
    return Image


# ------------------------------------------------------------ label makers


class PathLabelGenerator:
    """org.datavec.api.io.labels.PathLabelGenerator."""

    def label_for_path(self, path: str) -> str:
        raise NotImplementedError


class ParentPathLabelGenerator(PathLabelGenerator):
    """Label = name of the file's parent directory (the ImageNet/dir-per-class
    convention the reference's examples use)."""

    def label_for_path(self, path: str) -> str:
        return os.path.basename(os.path.dirname(path))


# -------------------------------------------------------------- transforms


class ImageTransform:
    """org.datavec.image.transform.ImageTransform: HWC uint8 → HWC uint8."""

    def transform(self, img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        raise NotImplementedError

    def __call__(self, img, rng):
        return self.transform(img, rng)


class ResizeImageTransform(ImageTransform):
    def __init__(self, height: int, width: int):
        self.height, self.width = height, width

    def transform(self, img, rng):
        Image = _pil()

        return np.asarray(Image.fromarray(img).resize(
            (self.width, self.height), Image.BILINEAR))


class FlipImageTransform(ImageTransform):
    """flipMode: 0 = vertical, 1 = horizontal (the OpenCV flip codes the
    reference exposes); random=True flips with p=0.5."""

    def __init__(self, flip_mode: int = 1, random: bool = True):
        self.flip_mode = flip_mode
        self.random = random

    def transform(self, img, rng):
        if self.random and rng.rand() >= 0.5:
            return img
        return img[::-1] if self.flip_mode == 0 else img[:, ::-1]


class CropImageTransform(ImageTransform):
    """Random crop by up to crop_[top/bottom/left/right] pixels."""

    def __init__(self, crop: int = 0):
        self.crop = crop

    def transform(self, img, rng):
        if self.crop <= 0:
            return img
        t, b = rng.randint(0, self.crop + 1), rng.randint(0, self.crop + 1)
        l, r = rng.randint(0, self.crop + 1), rng.randint(0, self.crop + 1)
        h, w = img.shape[:2]
        return img[t:h - b or h, l:w - r or w]


class RandomCropTransform(ImageTransform):
    """Crop a fixed (h, w) window at a random position (ref RandomCropTransform)."""

    def __init__(self, height: int, width: int):
        self.height, self.width = height, width

    def transform(self, img, rng):
        h, w = img.shape[:2]
        if h < self.height or w < self.width:
            Image = _pil()

            img = np.asarray(Image.fromarray(img).resize(
                (max(w, self.width), max(h, self.height)), Image.BILINEAR))
            h, w = img.shape[:2]
        y = rng.randint(0, h - self.height + 1)
        x = rng.randint(0, w - self.width + 1)
        return img[y:y + self.height, x:x + self.width]


class RotateImageTransform(ImageTransform):
    """Random rotation in [-angle, angle] degrees (ref RotateImageTransform)."""

    def __init__(self, angle: float):
        self.angle = angle

    def transform(self, img, rng):
        Image = _pil()

        a = rng.uniform(-self.angle, self.angle)
        return np.asarray(Image.fromarray(img).rotate(a, Image.BILINEAR))


class ColorJitterTransform(ImageTransform):
    """Brightness/contrast jitter (the reference's ColorConversion/Equalize
    family collapsed to the two augmentations modern pipelines use)."""

    def __init__(self, brightness: float = 0.2, contrast: float = 0.2):
        self.brightness, self.contrast = brightness, contrast

    def transform(self, img, rng):
        x = img.astype(np.float32)
        x = x * (1.0 + rng.uniform(-self.contrast, self.contrast))
        x = x + 255.0 * rng.uniform(-self.brightness, self.brightness)
        return np.clip(x, 0, 255).astype(np.uint8)


class PipelineImageTransform(ImageTransform):
    """Chain of (transform, probability) applied in order — ref
    ``PipelineImageTransform`` (shuffle=False semantics)."""

    def __init__(self, steps: Sequence, probabilities: Optional[Sequence[float]] = None):
        self.steps = list(steps)
        self.probs = list(probabilities) if probabilities else [1.0] * len(self.steps)

    def transform(self, img, rng):
        for t, p in zip(self.steps, self.probs):
            if p >= 1.0 or rng.rand() < p:
                img = t.transform(img, rng)
        return img


# ------------------------------------------------------------------ reader


class ImageRecordReader(LabeledFileRecordReader):
    """org.datavec.image.recordreader.ImageRecordReader: decode → (optional
    transform chain) → resize to (height, width) → CHW float32 + label index.

    ``next()`` returns ``[chw_array, label_idx]`` (the NDArrayWritable +
    label Writable pair of the reference); use ``ImageRecordReaderDataSetIterator``
    to batch into DataSets.
    """

    _extensions = _IMG_EXTS

    def __init__(self, height: int, width: int, channels: int = 3,
                 label_generator: Optional[PathLabelGenerator] = None,
                 transform: Optional[ImageTransform] = None, seed: int = 123,
                 uint8_wire: bool = False):
        super().__init__(label_generator)
        self.height, self.width, self.channels = height, width, channels
        self.transform = transform
        self.seed = seed
        # narrow wire format: emit HWC uint8 rows (the decode layout) and
        # leave cast/normalize/NCHW to the device ingest — 4x fewer bytes
        # over the h2d link than the float32 CHW default
        self.uint8_wire = uint8_wire

    def read_index(self, idx: int) -> List:
        """Decode + augment file #idx. Augmentation rng is seeded per image
        index, so results are deterministic under ANY execution order —
        including the thread-pool batching below."""
        path = self._files[idx]
        img = self._decode(path)
        if self.transform is not None:
            rng = np.random.RandomState((self.seed * 1_000_003 + idx) % (1 << 31))
            img = self.transform.transform(img, rng)
        img = self._to_hwc_u8(img) if self.uint8_wire else self._to_chw(img)
        if self.label_gen is None:
            return [img]
        return [img, self._label_of(path)]

    # -- decode helpers (NativeImageLoader.asMatrix equivalents) ------------

    def _decode(self, path: str) -> np.ndarray:
        Image = _pil()

        with Image.open(path) as im:
            im = im.convert("RGB" if self.channels == 3 else "L")
            return np.asarray(im)

    def _to_hwc_u8(self, img: np.ndarray) -> np.ndarray:
        """Resize only — stays HWC uint8 (the narrow wire format)."""
        Image = _pil()

        if img.shape[0] != self.height or img.shape[1] != self.width:
            img = np.asarray(Image.fromarray(img).resize(
                (self.width, self.height), Image.BILINEAR))
        if img.ndim == 2:
            img = img[:, :, None]
        return img

    def _to_chw(self, img: np.ndarray) -> np.ndarray:
        return self._to_hwc_u8(img).astype(np.float32).transpose(2, 0, 1)


class ImageRecordReaderDataSetIterator(DataSetIterator):
    """Batches ImageRecordReader rows into NCHW DataSets (the image-typed
    RecordReaderDataSetIterator constructor of the reference).

    ``num_workers`` decodes a batch's images on a thread pool — PIL's decode
    and numpy transforms release the GIL, so this parallelizes like the
    reference's multi-threaded OpenCV ETL; per-image seeded augmentation rng
    keeps results order-independent. Defaults to ``host_cpu_count()`` — the
    scheduler-affinity CPU count, so a cgroup-limited host sizes the pool by
    what it can actually run, not the machine's core count; pass 0 for the
    synchronous path. The pool is PERSISTENT — rebuilt executors
    cost a thread-spawn storm per epoch (a decode-starved pipeline) —
    and torn down only by ``close()``/GC. Wrap in ``AsyncDataSetIterator``
    (or ``DevicePrefetchIterator``) to additionally overlap whole batches
    with device steps.
    """

    def __init__(self, reader: ImageRecordReader, batch_size: int,
                 num_classes: Optional[int] = None, preprocessor=None,
                 num_workers: Optional[int] = None):
        self.reader = reader
        self.batch_size = batch_size
        self._num_classes = num_classes
        self.preprocessor = preprocessor
        self.num_workers = host_cpu_count() if num_workers is None else num_workers
        self._pool = None

    @property
    def num_classes(self):
        # lazy: the reader may be initialize()d after this iterator is built
        return self._num_classes or self.reader.num_labels() or None

    def reset(self):
        # the decode pool deliberately survives reset(): one pool for the
        # iterator's lifetime, not one per epoch
        self.reader.reset()

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __del__(self):
        self.close()

    def has_next(self) -> bool:
        return self.reader.has_next()

    def batch(self) -> int:
        return self.batch_size

    def _rows(self):
        idxs = self.reader.take_indices(self.batch_size)
        if self.num_workers > 1 and len(idxs) > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(self.num_workers)
            rows = list(self._pool.map(self.reader.read_index, idxs))
        else:
            rows = [self.reader.read_index(i) for i in idxs]
        return rows

    def next(self) -> DataSet:
        rows = self._rows()
        xs = [r[0] for r in rows]
        ys = [r[1] for r in rows if len(r) > 1]
        x = np.stack(xs)
        y = (np.eye(self.num_classes, dtype=np.float32)[np.asarray(ys)]
             if ys else None)
        ds = DataSet(x, y)
        if self.preprocessor is not None:
            self.preprocessor.transform(ds)
        return ds


# ------------------------------------------------- pre-decoded uint8 cache
# Decoding once into a uint8 memmap and augmenting vectorized per batch
# turns the per-step ETL cost into two big memory passes, which one core
# sustains at thousands of images/s where the JPEG path is decode-bound
# (~3 ms per image per core): the reference's "pre-save DataSets to disk"
# pattern (dl4j-examples PreSave + ExistingMiniBatchDataSetIterator) at the
# uint8-image level, so augmentation stays on the fly.


class PreDecodedImageCache:
    """Decode a directory of images once into ``cache_dir`` as a uint8
    memmap [N, store_h, store_w, C] + int32 labels + metadata json.
    Reopening with the same file list and store size reuses the shards."""

    def __init__(self, cache_dir: str, store_size: Tuple[int, int],
                 channels: int = 3):
        self.cache_dir = cache_dir
        self.store_h, self.store_w = store_size
        self.channels = channels
        self.images: Optional[np.memmap] = None
        self.labels: Optional[np.ndarray] = None
        self.label_names: List[str] = []

    def _meta_path(self):
        return os.path.join(self.cache_dir, "meta.json")

    def build(self, split: InputSplit,
              label_generator: Optional[PathLabelGenerator] = None,
              num_workers: Optional[int] = None) -> "PreDecodedImageCache":
        import hashlib
        import json

        Image = _pil()

        files = sorted(p for p in split.locations()
                       if p.lower().endswith(_IMG_EXTS))
        if not files:
            raise ValueError("no image files in split")
        key = hashlib.sha256(("\n".join(files)
                              + f"|{self.store_h}x{self.store_w}x{self.channels}")
                             .encode()).hexdigest()[:16]
        os.makedirs(self.cache_dir, exist_ok=True)
        img_path = os.path.join(self.cache_dir, "images.u8")
        if os.path.exists(self._meta_path()):
            with open(self._meta_path()) as f:
                meta = json.load(f)
            if meta.get("key") == key:
                self._open(meta)
                return self

        gen = label_generator or ParentPathLabelGenerator()
        names = sorted({gen.label_for_path(p) for p in files})
        name_to_idx = {n: i for i, n in enumerate(names)}
        labels = np.asarray([name_to_idx[gen.label_for_path(p)] for p in files],
                            np.int32)
        shape = (len(files), self.store_h, self.store_w, self.channels)
        mm = np.memmap(img_path, np.uint8, "w+", shape=shape)

        def decode(i):
            with Image.open(files[i]) as im:
                im = im.convert("RGB" if self.channels == 3 else "L")
                if im.size != (self.store_w, self.store_h):
                    im = im.resize((self.store_w, self.store_h), Image.BILINEAR)
                arr = np.asarray(im)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            mm[i] = arr

        if num_workers is None:
            num_workers = host_cpu_count()
        if num_workers > 1 and len(files) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(num_workers) as pool:
                list(pool.map(decode, range(len(files))))
        else:
            for i in range(len(files)):
                decode(i)
        mm.flush()
        np.save(os.path.join(self.cache_dir, "labels.npy"), labels)
        meta = {"key": key, "shape": list(shape), "label_names": names}
        with open(self._meta_path(), "w") as f:
            json.dump(meta, f)
        self._open(meta)
        return self

    def _open(self, meta):
        self.images = np.memmap(os.path.join(self.cache_dir, "images.u8"),
                                np.uint8, "r", shape=tuple(meta["shape"]))
        self.labels = np.load(os.path.join(self.cache_dir, "labels.npy"))
        self.label_names = list(meta["label_names"])

    def __len__(self):
        return 0 if self.images is None else self.images.shape[0]

    def num_labels(self):
        return len(self.label_names)


class CachedImageDataSetIterator(DataSetIterator):
    """NCHW DataSets straight from a ``PreDecodedImageCache`` with
    VECTORIZED on-the-fly augmentation (per-image random crop + horizontal
    flip as whole-batch numpy ops — no per-image Python in the loop).

    ``crop`` (h, w): per-image random window when the store size is larger
    (inference: centered); ``flip_p``: per-image horizontal-flip
    probability. ``scale``: multiply into [0,1] floats (the
    ImagePreProcessingScaler default) fused into the uint8→float32 pass.

    ``dtype=np.uint8`` emits raw uint8 NHWC batches instead (crop+flip are
    fused into one slice-copy pass, ~25ms/batch for 256x224² on ONE core)
    and leaves cast/scale/NCHW to the consumer — on TPU that runs on-device,
    and the host→device transfer shrinks 4x. This is the mode that keeps a
    small host ahead of the chip.
    """

    def __init__(self, cache: PreDecodedImageCache, batch_size: int,
                 crop: Optional[Tuple[int, int]] = None, flip_p: float = 0.5,
                 scale: float = 1.0 / 255.0, training: bool = True,
                 seed: int = 123, shuffle: bool = True, dtype=np.float32):
        self.cache = cache
        self.batch_size = batch_size
        self.crop = crop
        self.flip_p = flip_p
        self.scale = scale
        self.training = training
        self.shuffle = shuffle
        self.dtype = dtype
        self._rs = np.random.RandomState(seed)
        self._order = np.arange(len(cache))
        self._pos = 0
        if shuffle:
            self._rs.shuffle(self._order)

    @property
    def num_classes(self):
        return self.cache.num_labels()

    def reset(self):
        self._pos = 0
        if self.shuffle:
            self._rs.shuffle(self._order)

    def has_next(self) -> bool:
        return self._pos < len(self._order)

    def batch(self) -> int:
        return self.batch_size

    def next(self) -> DataSet:
        idxs = np.sort(self._order[self._pos : self._pos + self.batch_size])
        self._pos += len(idxs)
        src = self.cache.images
        B = len(idxs)
        Hs, Ws, C = src.shape[1:]
        H, W = self.crop if self.crop is not None else (Hs, Ws)
        if self.training and self.crop is not None:
            oy = self._rs.randint(0, Hs - H + 1, B)
            ox = self._rs.randint(0, Ws - W + 1, B)
        else:
            oy = np.full(B, (Hs - H) // 2)
            ox = np.full(B, (Ws - W) // 2)
        fl = (self._rs.rand(B) < self.flip_p) if (self.training and self.flip_p > 0) \
            else np.zeros(B, bool)
        # one slice-copy per image with the flip fused into the copy — 10x
        # cheaper than a whole-batch fancy-index gather (measured 248ms vs
        # ~25ms for 256x224² on one core)
        x = np.empty((B, H, W, C), np.uint8)
        for i, j in enumerate(idxs):
            win = src[j, oy[i]:oy[i] + H, ox[i]:ox[i] + W]
            x[i] = win[:, ::-1] if fl[i] else win
        y = np.eye(self.num_classes, dtype=np.float32)[self.cache.labels[idxs]]
        if self.dtype == np.uint8:
            return DataSet(x, y)  # NHWC uint8: cast/scale/layout on device
        xf = x.transpose(0, 3, 1, 2).astype(np.float32)
        if self.scale != 1.0:
            xf *= self.scale
        return DataSet(xf, y)

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next()


class VideoRecordReader(LabeledFileRecordReader):
    """datavec ``codec.reader.CodecRecordReader`` parity, scoped to the
    containers PIL decodes without native codec libraries: multi-frame
    image files (animated GIF/TIFF/WebP) and directories-of-frames. Each
    record is a sequence ``[CHW float32] * num_frames`` (+ label when a
    generator is set) — the reference's record-per-video layout.

    ffmpeg-backed containers (mp4/avi) need JavaCV/ffmpeg, which this
    zero-egress image does not ship — documented exclusion in README; the
    frames-directory mode is the standard workaround (``ffmpeg -i v.mp4
    frames/%d.png`` offline, then read the directory).
    """

    _extensions = (".gif", ".tiff", ".tif", ".webp")

    def __init__(self, height: int, width: int, channels: int = 3,
                 start_frame: int = 0, num_frames: int = 0,
                 rows_per_sequence: int = 0,
                 label_generator: Optional[PathLabelGenerator] = None):
        super().__init__(label_generator)
        self.height, self.width, self.channels = height, width, channels
        self.start_frame = start_frame
        self.num_frames = num_frames  # 0 = all
        del rows_per_sequence  # reference knob, subsumed by num_frames

    def read_index(self, idx: int) -> List:
        Image = _pil()
        from PIL import ImageSequence

        path = self._files[idx]
        frames = []
        with Image.open(path) as im:
            it = ImageSequence.Iterator(im)
            for fi, frame in enumerate(it):
                if fi < self.start_frame:
                    continue
                if self.num_frames and len(frames) >= self.num_frames:
                    break
                frames.append(_frame_to_chw(frame, self.height, self.width,
                                            self.channels))
        out: List = [np.stack(frames)] if frames else [np.zeros(
            (0, self.channels, self.height, self.width), np.float32)]
        if self.label_gen is not None:
            out.append(self._label_of(path))
        return out


def _frame_to_chw(pil_image, height: int, width: int, channels: int) -> np.ndarray:
    """One decoded PIL image → CHW float32 (shared by the video readers)."""
    Image = _pil()

    f = pil_image.convert("RGB" if channels == 3 else "L")
    if f.size != (width, height):
        f = f.resize((width, height), Image.BILINEAR)
    arr = np.asarray(f, np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr.transpose(2, 0, 1)


def _natural_key(path: str):
    """Numeric-aware sort key: ffmpeg's %d.png produces 1,2,...,10 which a
    lexicographic sort would scramble into 1,10,11,...,2."""
    import re

    return [int(t) if t.isdigit() else t
            for t in re.split(r"(\d+)", os.path.basename(path))]


class FrameDirectoryRecordReader:
    """Directory-of-frames video reader: each SUBDIRECTORY is one video,
    its frames sorted NUMERICALLY (ffmpeg ``%d.png`` output order) — the
    offline-ffmpeg workflow's reader half. Record layout matches
    VideoRecordReader: ``[frames [T,C,H,W], label_index]``; the label of a
    video is produced by ``label_generator`` applied to the video DIRECTORY
    (default ParentPathLabelGenerator: the class directory above the clip,
    so same-named clips under different classes don't collide)."""

    def __init__(self, height: int, width: int, channels: int = 3,
                 label_generator: Optional[PathLabelGenerator] = None):
        self.height, self.width, self.channels = height, width, channels
        self.label_gen = label_generator or ParentPathLabelGenerator()
        self._videos: List[Tuple[str, List[str]]] = []
        self._labels: List[str] = []
        self._pos = 0

    def initialize(self, split: InputSplit) -> "FrameDirectoryRecordReader":
        byd: dict = {}
        for p in sorted(split.locations()):
            if p.lower().endswith(_IMG_EXTS):
                byd.setdefault(os.path.dirname(p), []).append(p)
        self._videos = sorted(byd.items())
        # the generator is applied to the video DIRECTORY path, so the
        # default ParentPathLabelGenerator yields the class dir above the clip
        self._labels = sorted({self.label_gen.label_for_path(d)
                               for d, _ in self._videos})
        self._pos = 0
        return self

    def labels(self) -> List[str]:
        return list(self._labels)

    def num_labels(self) -> int:
        return len(self._labels)

    def has_next(self) -> bool:
        return self._pos < len(self._videos)

    def reset(self):
        self._pos = 0

    def next(self) -> List:
        Image = _pil()

        dirname, files = self._videos[self._pos]
        self._pos += 1
        frames = []
        for p in sorted(files, key=_natural_key):
            with Image.open(p) as im:
                frames.append(_frame_to_chw(im, self.height, self.width,
                                            self.channels))
        label = self.label_gen.label_for_path(dirname)
        return [np.stack(frames), self._labels.index(label)]
