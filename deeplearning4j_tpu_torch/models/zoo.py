"""Model zoo base and the small CNNs.

Counterpart of ``deeplearning4j_tpu/models/zoo.py`` (DL4J's
``org.deeplearning4j.zoo.ZooModel`` SPI and ``zoo.model.{LeNet,
SimpleCNN}``), with the same configurations. ``init`` builds the model's
network (a ``MultiLayerNetwork``, or the ``ComputationGraph`` that a graph
model's ``_net_class`` names) on ``device`` (``"cuda"`` unless the caller
asks for the CPU). ``init_pretrained`` loads a local ModelSerializer zip
(either package's), checked against its sha256; nothing is downloaded.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..nn.conf import (
    BatchNormalization,
    ConvolutionLayer,
    DenseLayer,
    DropoutLayer,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
    SubsamplingLayer,
)
from ..nn.multilayer import MultiLayerNetwork
from ..nn.updaters import Adam, Nesterovs


class ZooModel:
    """org.deeplearning4j.zoo.ZooModel SPI."""

    def conf(self):
        raise NotImplementedError

    def init(self, *, device="cuda"):
        """The network of ``conf()`` (a ``MultiLayerNetwork``, or what
        ``_net_class`` names) on ``device``, initialised."""
        return self._net_class()(self.conf(), device=device).init()

    def _net_class(self):
        return MultiLayerNetwork

    def pretrained_url(self, dataset: str = "imagenet") -> Optional[str]:
        return None  # zero-egress build: no download URLs

    def pretrained_checksum(self, dataset: str = "imagenet") -> Optional[str]:
        """sha256 hex the checkpoint must match (``ZooModel.pretrainedChecksum``
        analog; the reference uses adler32 over the download)."""
        return None

    def init_pretrained(self, path: Optional[str] = None, dataset: str = "imagenet",
                        checksum: Optional[str] = None, *, device="cuda"):
        """The network of a LOCAL ModelSerializer zip on ``device``, its
        sha256 verified when a checksum is given (or published by the model
        class). The reference's ``initPretrained()`` downloads from
        ``pretrainedUrl``; this build fetches nothing, so the file must
        already be on disk."""
        if path is None:
            url = self.pretrained_url(dataset)
            raise ValueError(
                "no pretrained weights can be downloaded in this environment"
                + (f" (reference URL would be {url})" if url else "")
                + "; pass a local checkpoint path (ModelSerializer zip)")
        want = checksum or self.pretrained_checksum(dataset)
        if want is not None:
            import hashlib

            h = hashlib.sha256()
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            got = h.hexdigest()
            if got != want.lower():
                raise ValueError(
                    f"pretrained checkpoint checksum mismatch for {path}: "
                    f"sha256 {got} != expected {want} (corrupt or wrong file)")
        from ..serde.model_serializer import ModelSerializer

        return ModelSerializer.restore(path, device=device)

    initPretrained = init_pretrained


class LeNet(ZooModel):
    """org.deeplearning4j.zoo.model.LeNet (LeNet MNIST): conv 20 and 50
    filters of 5x5 "same", max pool 2x2, dense 500, softmax; Adam 1e-3."""

    def __init__(self, num_classes: int = 10, seed: int = 123,
                 input_shape: Tuple[int, int, int] = (1, 28, 28)):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = input_shape

    def conf(self):
        c, h, w = self.input_shape
        return (
            NeuralNetConfiguration.Builder()
            .seed(self.seed)
            .updater(Adam(1e-3))
            .weight_init("xavier")
            .list()
            .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5), stride=(1, 1),
                                    convolution_mode="same", activation="relu"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5), stride=(1, 1),
                                    convolution_mode="same", activation="relu"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                               loss="negativeloglikelihood"))
            .set_input_type(InputType.convolutional(h, w, c))
            .build()
        )


class SimpleCNN(ZooModel):
    """org.deeplearning4j.zoo.model.SimpleCNN (4 conv blocks + dense)."""

    def __init__(self, num_classes: int = 10, seed: int = 123,
                 input_shape: Tuple[int, int, int] = (3, 48, 48)):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = input_shape

    def conf(self):
        c, h, w = self.input_shape
        b = (
            NeuralNetConfiguration.Builder()
            .seed(self.seed)
            .updater(Nesterovs(5e-3, 0.9))
            .weight_init("xavier")
            .list()
        )
        for n_out in (32, 64, 128, 256):
            b = (
                b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                         convolution_mode="same", activation="identity"))
                .layer(BatchNormalization())
                .layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                        convolution_mode="same", activation="relu"))
                .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
            )
        return (
            b.layer(DenseLayer(n_out=512, activation="relu"))
            .layer(DropoutLayer(dropout=0.5))
            .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                               loss="negativeloglikelihood"))
            .set_input_type(InputType.convolutional(h, w, c))
            .build()
        )
