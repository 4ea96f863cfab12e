"""Host-side data containers, iterators and the input pipeline of the port
(counterparts of the JAX package's ``data`` modules).

A lazy namespace (PEP 562, as the package's top level): the ETL service's
spawned workers import ``etl_service``, ``image``, ``records``,
``dataset`` and ``iterators``, none of which imports torch, and an eager
package import here would cost each worker an ``import torch`` it never
uses. ``from deeplearning4j_tpu_torch.data import X`` works for every name
below; its module is imported on first use. Datavec's
``TransformProcess`` (``transform.py``) and the audio reader (``audio.py``)
are host Python too.
"""

import importlib as _importlib

_EXPORTS = {
    # dataset containers
    "DataSet": ".dataset",
    "MultiDataSet": ".dataset",
    # curated datasets
    "Cifar10DataSetIterator": ".datasets",
    "EmnistDataSetIterator": ".datasets",
    "IrisDataSetIterator": ".datasets",
    "MnistDataSetIterator": ".datasets",
    "TinyImageNetDataSetIterator": ".datasets",
    # multi-process sharded ETL service
    "DecodedBatchCache": ".etl_service",
    "EtlDataSetIterator": ".etl_service",
    "EtlWorkerError": ".etl_service",
    "ImageEtlSpec": ".etl_service",
    "shard_batches": ".etl_service",
    # iterators
    "DataSetIterator": ".iterators",
    "DevicePrefetchIterator": ".iterators",
    "ListDataSetIterator": ".iterators",
    "ListMultiDataSetIterator": ".iterators",
    "ArrayDataSetIterator": ".iterators",
    "AsyncDataSetIterator": ".iterators",
    "MultiDataSetIterator": ".iterators",
    # normalizers
    "ImagePreProcessingScaler": ".normalizers",
    "NormalizerMinMaxScaler": ".normalizers",
    "NormalizerStandardize": ".normalizers",
    "make_device_ingest": ".normalizers",
    # image ETL
    "CachedImageDataSetIterator": ".image",
    "FrameDirectoryRecordReader": ".image",
    "VideoRecordReader": ".image",
    "ColorJitterTransform": ".image",
    "CropImageTransform": ".image",
    "FlipImageTransform": ".image",
    "ImageRecordReader": ".image",
    "ImageRecordReaderDataSetIterator": ".image",
    "ImageTransform": ".image",
    "PreDecodedImageCache": ".image",
    "ParentPathLabelGenerator": ".image",
    "PipelineImageTransform": ".image",
    "RandomCropTransform": ".image",
    "ResizeImageTransform": ".image",
    "RotateImageTransform": ".image",
    # record readers and splits
    "RecordReaderDataSetIterator": ".record_reader_iterator",
    "ExcelRecordReader": ".records",
    "CollectionRecordReader": ".records",
    "CSVRecordReader": ".records",
    "FileSplit": ".records",
    "JacksonLineRecordReader": ".records",
    "LineRecordReader": ".records",
    "RegexLineRecordReader": ".records",
    "SVMLightRecordReader": ".records",
    "RecordReader": ".records",
    # transforms
    "DataQualityAnalysis": ".transform",
    "Reducer": ".transform",
    "Schema": ".transform",
    "SplitMaxLengthSequence": ".transform",
    "TransformProcess": ".transform",
    "convert_to_sequence": ".transform",
    "offset_sequence": ".transform",
    "reduce_sequence_by_window": ".transform",
    "split_sequences": ".transform",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(_importlib.import_module(mod, __name__), name)
    globals()[name] = value
    return value
