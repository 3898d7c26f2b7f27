"""Golden tests: mel frontend vs HF WhisperFeatureExtractor (pure numpy,
hub-free).  SURVEY §7 "Bit-comparable mel" requirement."""

import numpy as np
import pytest

from desta25_audio_tpu.audio import mel as melmod


def _hf_mel(audio, n_mels):
    tr = pytest.importorskip("transformers")
    fe = tr.WhisperFeatureExtractor(feature_size=n_mels)
    return fe(list(audio), sampling_rate=16000,
              return_tensors="np").input_features


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_hf(rng, n_mels):
    # Two clips: tone+noise (2 s) and pure noise (0.5 s) — exercises padding.
    t = np.arange(32000) / 16000.0
    a1 = (0.5 * np.sin(2 * np.pi * 440 * t)
          + 0.1 * rng.standard_normal(32000)).astype(np.float32)
    a2 = (0.2 * rng.standard_normal(8000)).astype(np.float32)
    ref = _hf_mel([a1, a2], n_mels)  # [2, n_mels, 3000]
    got = melmod.log_mel_np(
        np.stack([np.pad(a1, (0, 0)), np.pad(a2, (0, 24000))])[:, :32000],
        n_mels,
    )
    # note: HF pads each to 30 s internally; ours pads via pad_or_trim.
    assert got.shape == ref.shape
    # f32 device path: tight in the mean; bounded worst case at near-floor bins
    # (HF computes the STFT in float64 — see log_mel_np_precise docstring).
    diff = np.abs(got - ref)
    assert diff.mean() < 5e-4
    assert diff.max() < 0.2
    # f64 host path: bit-comparable.
    precise = melmod.log_mel_np_precise(
        np.stack([a1, np.pad(a2, (0, 24000))]), n_mels)
    assert np.max(np.abs(precise - ref)) < 1e-5


def test_filterbank_matches_hf():
    tr = pytest.importorskip("transformers")
    from transformers.audio_utils import mel_filter_bank as hf_fb
    ours = melmod.mel_filter_bank(128)
    theirs = hf_fb(
        num_frequency_bins=201, num_mel_filters=128, min_frequency=0.0,
        max_frequency=8000.0, sampling_rate=16000, norm="slaney",
        mel_scale="slaney",
    )
    assert np.max(np.abs(ours - theirs)) < 1e-6


def test_power_spectrogram_matches_npfft(rng):
    audio = rng.standard_normal(16000 * 30).astype(np.float32)[None]
    got = np.asarray(melmod.power_spectrogram(
        melmod.pad_or_trim(np.asarray(audio))))
    # numpy oracle
    window = 0.5 * (1 - np.cos(2 * np.pi * np.arange(400) / 400))
    padded = np.pad(audio[0], 200, mode="reflect")
    frames = np.stack([padded[i * 160:i * 160 + 400] for i in range(3000)])
    spec = np.abs(np.fft.rfft(frames * window, axis=-1)) ** 2
    assert np.max(np.abs(got[0] - spec)) / (np.max(spec) + 1e-9) < 1e-5


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_f64_host_reference(rng, n_mels):
    """The device frontend (log_mel, float32 DFT-as-matmul at HIGHEST
    precision) on full 30 s clips against the float64 numpy path."""
    import jax.numpy as jnp
    n = melmod.N_SAMPLES
    t = np.arange(n) / 16000.0
    audio = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
    audio[0] += 0.5 * np.sin(2 * np.pi * 523.0 * t).astype(np.float32)
    audio[1, n // 2:] = 0.0   # silent half: bins at the clamp floor
    got = np.asarray(melmod.log_mel(jnp.asarray(audio), n_mels,
                                    layout="bmt"))
    ref = melmod.log_mel_np_precise(audio, n_mels)
    assert got.shape == ref.shape == (2, n_mels, melmod.N_FRAMES)
    assert np.abs(got - ref).max() < 1e-4
