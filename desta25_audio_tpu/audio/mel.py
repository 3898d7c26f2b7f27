"""Whisper-compatible log-mel spectrogram frontend.

Bit-comparable reimplementation of HF ``WhisperFeatureExtractor``
(the reference's processor at modeling_desta25.py:1570 and
simple_dataset.py:239-243): 16 kHz audio, n_fft=400, hop=160, periodic Hann
window, center-reflect padding, power spectrum, slaney-normalized mel
filterbank (80 or 128 mels, fmax 8 kHz), log10 with 1e-10 clamp, per-sample
dynamic-range clamp to max-8, then ``(x + 4) / 4``.

Design is GEMM-native ("MelT"-style): audio is reshaped to
hop-sized rows; because n_fft = 2.5 * hop, every frame is a concatenation of
three row slices, so ``frames @ DFT`` factors into three dense matmuls with
static shapes and no gather.  The window is folded into the DFT matrices.
``log_mel`` is the device frontend; ``log_mel_np_precise`` is its float64
host reference.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30  # seconds
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000


def hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    log_region = freq >= min_log_hertz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hertz) / min_log_hertz)
        * logstep,
        mels,
    )
    return mels


def mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    log_region = mels >= min_log_mel
    freq = np.where(
        log_region, min_log_hertz * np.exp(logstep * (mels - min_log_mel)),
        freq,
    )
    return freq


def mel_filter_bank(num_mel_bins: int, num_freq_bins: int = N_FFT // 2 + 1,
                    sample_rate: int = SAMPLE_RATE, fmin: float = 0.0,
                    fmax: float = 8000.0) -> np.ndarray:
    """Slaney-style triangular filterbank [num_freq_bins, num_mel_bins].

    Matches ``transformers.audio_utils.mel_filter_bank(norm="slaney",
    mel_scale="slaney", triangularize_in_mel_space=False)``.
    """
    fft_freqs = np.linspace(0, sample_rate / 2, num_freq_bins)
    mel_min = hz_to_mel_slaney(np.array(fmin))
    mel_max = hz_to_mel_slaney(np.array(fmax))
    mel_pts = np.linspace(mel_min, mel_max, num_mel_bins + 2)
    hz_pts = mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    slopes = hz_pts[None, :] - fft_freqs[:, None]  # [F, M+2]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))  # [F, M]

    # Slaney normalization: scale each filter to constant energy.
    enorm = 2.0 / (hz_pts[2:num_mel_bins + 2] - hz_pts[:num_mel_bins])
    fb = fb * enorm[None, :]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _dft_window_matrices(n_fft: int = N_FFT) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT matrices (cos, -sin) of shape [n_fft, n_fft//2+1]."""
    n_bins = n_fft // 2 + 1
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    cos_m = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_m = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_m, sin_m


@functools.lru_cache(maxsize=4)
def mel_frontend_matrices(num_mel_bins: int) -> Tuple[np.ndarray, np.ndarray,
                                                      np.ndarray]:
    """(cos, sin, mel) matrices for the GEMM-native frontend."""
    cos_m, sin_m = _dft_window_matrices()
    mel = mel_filter_bank(num_mel_bins)
    return cos_m, sin_m, mel


def pad_or_trim(audio: jnp.ndarray, length: int = N_SAMPLES) -> jnp.ndarray:
    """Zero-pad / truncate the last axis to ``length`` (feature extractor
    behavior: 30 s fixed window)."""
    t = audio.shape[-1]
    if t == length:
        return audio
    if t > length:
        return audio[..., :length]
    pad = [(0, 0)] * (audio.ndim - 1) + [(0, length - t)]
    return jnp.pad(audio, pad)


def _framed_rows(audio: jnp.ndarray) -> jnp.ndarray:
    """Reflect-pad and reshape to hop-sized rows [B, n_frames+3, HOP]."""
    B = audio.shape[0]
    padded = jnp.pad(audio, ((0, 0), (N_FFT // 2, N_FFT // 2)),
                     mode="reflect")
    total = padded.shape[1]
    n_rows = audio.shape[1] // HOP_LENGTH + 3
    padded = jnp.pad(padded, ((0, 0), (0, n_rows * HOP_LENGTH - total)))
    return padded.reshape(B, n_rows, HOP_LENGTH)


def power_spectrogram(audio: jnp.ndarray) -> jnp.ndarray:
    """[B, n_frames*160] -> power spectrum [B, n_frames, 201] (the extra
    final frame is dropped, matching WhisperFeatureExtractor's
    ``stft[..., :-1]``).  Whisper uses n_frames=3000 (30 s)."""
    rows = _framed_rows(audio)
    cos_m, sin_m = _dft_window_matrices()
    cos_m = jnp.asarray(cos_m)
    sin_m = jnp.asarray(sin_m)
    F = audio.shape[1] // HOP_LENGTH

    def third_matmul(mat):
        # frames[f] = concat(rows[f], rows[f+1], rows[f+2,:80])
        w0, w1, w2 = mat[:HOP_LENGTH], mat[HOP_LENGTH:2 * HOP_LENGTH], \
            mat[2 * HOP_LENGTH:]
        s = (jnp.einsum("bfh,hk->bfk", rows[:, 0:F], w0,
                        preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
             + jnp.einsum("bfh,hk->bfk", rows[:, 1:F + 1], w1,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
             + jnp.einsum("bfh,hk->bfk", rows[:, 2:F + 2, :N_FFT - 2 * HOP_LENGTH],
                          w2, preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST))
        return s

    re = third_matmul(cos_m)
    im = third_matmul(sin_m)
    return re * re + im * im


def log_mel(audio: jnp.ndarray, num_mel_bins: int,
            layout: str = "btm") -> jnp.ndarray:
    """Whisper log-mel features.

    audio: [B, 480000] float32 in [-1, 1].
    layout "btm" -> [B, 3000, n_mels] (NWC, conv-ready);
    layout "bmt" -> [B, n_mels, 3000] (HF parity).
    """
    power = power_spectrogram(audio)  # [B, F, 201]
    mel_fb = jnp.asarray(mel_filter_bank(num_mel_bins))
    mel = jnp.einsum("bfk,km->bfm", power, mel_fb,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    log_spec = jnp.log10(jnp.maximum(mel, 1e-10))
    max_val = jnp.max(log_spec, axis=(1, 2), keepdims=True)
    log_spec = jnp.maximum(log_spec, max_val - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    if layout == "bmt":
        return jnp.swapaxes(log_spec, 1, 2)
    return log_spec


def log_mel_np(audio: np.ndarray, num_mel_bins: int) -> np.ndarray:
    """Host/numpy convenience wrapper returning HF layout [B, n_mels, 3000]."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None]
    out = jax.device_get(log_mel(pad_or_trim(jnp.asarray(audio)),
                                 num_mel_bins, layout="bmt"))
    return out


def log_mel_np_precise(audio: np.ndarray, num_mel_bins: int) -> np.ndarray:
    """Float64 host path, bit-comparable to HF WhisperFeatureExtractor.

    The device path runs in float32; cancellation in the
    DFT at near-floor energy bins makes them diverge from the f64 reference by
    up to ~0.1 in normalized log-mel units *at bins within 8 decades of the
    per-clip max*; mean divergence is <5e-4 and encoder-output impact is
    negligible.  Use this path when exact HF parity matters (golden fixture
    generation, data-prep determinism checks).
    """
    audio = np.asarray(audio, dtype=np.float64)
    if audio.ndim == 1:
        audio = audio[None]
    B = audio.shape[0]
    padded = np.zeros((B, N_SAMPLES), dtype=np.float64)
    t = min(audio.shape[1], N_SAMPLES)
    padded[:, :t] = audio[:, :t]
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT))
    refl = np.pad(padded, ((0, 0), (N_FFT // 2, N_FFT // 2)), mode="reflect")
    idx = (np.arange(N_FRAMES)[:, None] * HOP_LENGTH
           + np.arange(N_FFT)[None, :])
    frames = refl[:, idx] * window  # [B, F, 400]
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2  # [B, F, 201]
    mel_fb = mel_filter_bank(num_mel_bins).astype(np.float64)
    mel = spec @ mel_fb
    log_spec = np.log10(np.maximum(mel, 1e-10))
    max_val = log_spec.max(axis=(1, 2), keepdims=True)
    log_spec = np.maximum(log_spec, max_val - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return np.swapaxes(log_spec, 1, 2).astype(np.float32)
