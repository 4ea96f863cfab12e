"""Character-level LSTM text generation model (the GravesLSTM char-RNN).

Counterpart of ``deeplearning4j_tpu/models/text_lstm.py`` (DL4J's
``zoo.model.TextGenerationLSTM`` and the dl4j-examples GravesLSTM char-RNN):
GravesLSTM layers, a softmax RnnOutputLayer with mcxent, truncated BPTT,
Adam and element-wise gradient clipping at 1.0.
"""

from __future__ import annotations

from ..nn.conf import GravesLSTM, InputType, NeuralNetConfiguration, RnnOutputLayer
from ..nn.updaters import Adam
from .zoo import ZooModel


class TextGenerationLSTM(ZooModel):
    def __init__(self, vocab_size: int = 77, hidden: int = 256, layers: int = 2,
                 tbptt_length: int = 50, seed: int = 123):
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.layers = layers
        self.tbptt_length = tbptt_length
        self.seed = seed

    def conf(self):
        b = (
            NeuralNetConfiguration.Builder()
            .seed(self.seed)
            .updater(Adam(1e-3))
            .weight_init("xavier")
            .gradient_normalization("ClipElementWiseAbsoluteValue", 1.0)
            .list()
        )
        for _ in range(self.layers):
            b = b.layer(GravesLSTM(n_out=self.hidden, activation="tanh"))
        return (
            b.layer(RnnOutputLayer(n_out=self.vocab_size, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.recurrent(self.vocab_size))
            .t_bptt_length(self.tbptt_length)
            .build()
        )
