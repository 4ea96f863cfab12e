"""Port parity: the image ETL (``deeplearning4j_tpu_torch.data.image``)
against the JAX package's, on the CPU, over the same files.

Decoded and augmented images (every transform, seeded per image), uint8
HWC and float CHW rows, the thread-pool batches with a preprocessor, the
pre-decoded cache's files and its iterator's batches (uint8 and float), and
the video and frame-directory readers: all equal to the JAX package's bit
for bit.
"""

import json

import numpy as np
import pytest
from PIL import Image

from deeplearning4j_tpu.data import image as JI
from deeplearning4j_tpu.data import normalizers as JN
from deeplearning4j_tpu.data import records as JR
from deeplearning4j_tpu_torch.data import image as TI
from deeplearning4j_tpu_torch.data import normalizers as TN
from deeplearning4j_tpu_torch.data import records as TR
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

PKGS = ((JI, JR, JN), (TI, TR, TN))


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgs")
    rs = np.random.RandomState(0)
    for i in range(30):
        d = root / f"c{i % 3}"
        d.mkdir(exist_ok=True)
        h, w = (24, 20) if i % 4 else (18, 26)  # a few smaller than the crop
        arr = rs.randint(0, 255, (h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(d / f"i{i}.{'png' if i % 5 == 0 else 'jpg'}", quality=85)
    return str(root)


def _chain(M):
    return {
        "none": None,
        "crop_flip": M.PipelineImageTransform([M.RandomCropTransform(16, 16),
                                               M.FlipImageTransform(1)]),
        "resize_vflip": M.PipelineImageTransform([M.ResizeImageTransform(22, 22),
                                                  M.FlipImageTransform(0, random=False)]),
        "crop_rotate_jitter": M.PipelineImageTransform(
            [M.CropImageTransform(3), M.RotateImageTransform(15.0),
             M.ColorJitterTransform(0.2, 0.3)], probabilities=[1.0, 0.5, 0.7]),
    }


@pytest.mark.parametrize("chain", ["none", "crop_flip", "resize_vflip", "crop_rotate_jitter"])
@pytest.mark.parametrize("wire", [False, True], ids=["float_chw", "uint8_hwc"])
def test_reader_rows_equal_jax(image_dir, chain, wire):
    rows = []
    for I, R, _ in PKGS:
        rr = I.ImageRecordReader(16, 16, 3, I.ParentPathLabelGenerator(),
                                 transform=_chain(I)[chain], seed=9, uint8_wire=wire)
        rr.initialize(R.FileSplit(image_dir))
        rows.append([rr.next() for _ in range(30)])
        assert rr.labels() == ["c0", "c1", "c2"] and not rr.has_next()
    for (jx, jl), (tx, tl) in zip(*rows):
        assert tx.dtype == (np.uint8 if wire else np.float32) and tl == jl
        np.testing.assert_array_equal(tx, jx)


def test_threaded_batches_with_a_preprocessor_equal_jax(image_dir):
    """Three decode threads against JAX's synchronous path: per-image
    seeding makes the batches independent of the order of decode."""
    out = []
    for (I, R, N), workers in zip(PKGS, (0, 3)):
        rr = I.ImageRecordReader(16, 16, 3, I.ParentPathLabelGenerator(),
                                 transform=_chain(I)["crop_flip"], seed=4)
        rr.initialize(R.FileSplit(image_dir))
        it = I.ImageRecordReaderDataSetIterator(rr, 8, preprocessor=N.ImagePreProcessingScaler(),
                                                num_workers=workers)
        out.append([(ds.features, ds.labels) for ds in it] + [(ds.features, ds.labels)
                                                              for ds in it])
        assert it.num_classes == 3
        it.close()
    assert len(out[1]) == 8  # 4 batches (8, 8, 8, 6) per epoch
    for (jx, jy), (tx, ty) in zip(*out):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


def test_predecoded_cache_files_and_batches_equal_jax(image_dir, tmp_path):
    caches = []
    for (I, R, _), name in zip(PKGS, ("j", "t")):
        caches.append(I.PreDecodedImageCache(str(tmp_path / name), (20, 20)).build(
            R.FileSplit(image_dir), num_workers=2 if name == "t" else 0))
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    for f in ("images.u8", "labels.npy"):
        assert (jdir / f).read_bytes() == (tdir / f).read_bytes()
    meta = [json.loads((d / "meta.json").read_text()) for d in (jdir, tdir)]
    assert meta[0] == meta[1]
    assert len(caches[1]) == 30 and caches[1].num_labels() == 3
    again = TI.PreDecodedImageCache(str(tdir), (20, 20)).build(TR.FileSplit(image_dir))
    assert again.images.filename == caches[1].images.filename  # reused, not rebuilt
    for kw in (dict(crop=(16, 16), dtype=np.uint8), dict(crop=(16, 16)),
               dict(training=False, crop=(12, 12), shuffle=False)):
        got = []
        for (I, _, _), cache in zip(PKGS, caches):
            it = I.CachedImageDataSetIterator(cache, 7, seed=3, **kw)
            got.append([(ds.features, ds.labels) for _ in range(2) for ds in it])
        for (jx, jy), (tx, ty) in zip(*got):
            assert tx.dtype == jx.dtype
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)


def test_video_and_frame_directory_readers_equal_jax(tmp_path):
    rs = np.random.RandomState(2)
    for cls in ("run", "walk"):
        (tmp_path / "gif" / cls).mkdir(parents=True)
        frames = [Image.fromarray(rs.randint(0, 255, (12, 10, 3), dtype=np.uint8))
                  for _ in range(5)]
        frames[0].save(tmp_path / "gif" / cls / "v.gif", save_all=True,
                       append_images=frames[1:], duration=40)
        clip = tmp_path / "frames" / cls / "clip1"
        clip.mkdir(parents=True)
        for k in (1, 2, 10):
            Image.fromarray(rs.randint(0, 255, (12, 10, 3), dtype=np.uint8)).save(
                clip / f"{k}.png")
    got = []
    for I, R, _ in PKGS:
        vr = I.VideoRecordReader(8, 8, start_frame=1, num_frames=3,
                                 label_generator=I.ParentPathLabelGenerator())
        vr.initialize(R.FileSplit(str(tmp_path / "gif")))
        fr = I.FrameDirectoryRecordReader(8, 8).initialize(R.FileSplit(str(tmp_path / "frames")))
        got.append([vr.next(), vr.next(), fr.next(), fr.next()] + [fr.labels()])
    for j, t in zip(got[0][:4], got[1][:4]):
        assert j[1] == t[1]
        np.testing.assert_array_equal(t[0], j[0])
    assert got[1][0][0].shape == (3, 3, 8, 8) and got[0][4] == got[1][4] == ["run", "walk"]


def test_decode_without_pillow_names_it(monkeypatch, image_dir):
    import builtins

    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real(name, *a, **kw)

    rr = TI.ImageRecordReader(16, 16).initialize(TR.FileSplit(image_dir))
    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="Pillow"):
        rr.next()
