"""Audio ETL (copy of the JAX package's ``data.audio``: datavec-data-audio).

Reference: ``org.datavec.audio.recordreader.WavFileRecordReader`` (raw
waveform rows) and the FFT feature pipeline. Decode is stdlib ``wave`` (the
reference uses its own WavFile reader — no external deps either way);
spectrogram features are a numpy STFT on the host, the same division of
labour as the image pipeline (ETL on the host, training math on the
device). Nothing here imports torch.
"""

from __future__ import annotations

import os
import wave
from typing import List, Optional

import numpy as np

from .records import InputSplit, LabeledFileRecordReader


def read_wav(path: str) -> tuple:
    """(samples float32 [-1, 1] mono, sample_rate)."""
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
        channels = w.getnchannels()
        rate = w.getframerate()
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, rate


def spectrogram(x: np.ndarray, n_fft: int = 256, hop: int = 128) -> np.ndarray:
    """Magnitude STFT [frames, n_fft//2+1] (Hann window)."""
    if len(x) < n_fft:
        x = np.pad(x, (0, n_fft - len(x)))
    win = np.hanning(n_fft).astype(np.float32)
    starts = range(0, len(x) - n_fft + 1, hop)
    frames = np.stack([x[s:s + n_fft] * win for s in starts])
    return np.abs(np.fft.rfft(frames, axis=-1)).astype(np.float32)


class WavFileRecordReader(LabeledFileRecordReader):
    """org.datavec.audio.recordreader.WavFileRecordReader: each record =
    [features, label?]; features = raw waveform (default) or spectrogram;
    dir-name labels via an optional label generator (image-reader parity)."""

    _extensions = (".wav",)

    def __init__(self, features: str = "waveform", n_fft: int = 256,
                 hop: int = 128, max_samples: Optional[int] = None,
                 label_generator=None):
        if features not in ("waveform", "spectrogram"):
            raise ValueError(f"features={features!r}: waveform|spectrogram")
        super().__init__(label_generator)
        self.features = features
        self.n_fft = n_fft
        self.hop = hop
        self.max_samples = max_samples

    def read_index(self, idx: int) -> List:
        path = self._files[idx]
        x, _rate = read_wav(path)
        if self.max_samples:
            x = x[: self.max_samples]
            if len(x) < self.max_samples:
                x = np.pad(x, (0, self.max_samples - len(x)))
        feat = (spectrogram(x, self.n_fft, self.hop)
                if self.features == "spectrogram" else x)
        if self.label_gen is None:
            return [feat]
        return [feat, self._label_of(path)]
