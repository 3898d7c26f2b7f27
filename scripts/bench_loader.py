"""Input-pipeline throughput: can the host loader keep a train step fed?

The host loader must decode + collate at least as many clips per second
as the flagship train step consumes (batch 12 per step; the step time
on the card is not measured yet).  This writes a synthetic FLAC
dataset (30 s clips via the FFmpeg native encoder), builds the real
AudioTextDataset + CollateFn + PrefetchLoader at flagship geometry
(batch 12, max_seq_length 300), and measures sustained samples/s
through the loader.

Host-only: python scripts/bench_loader.py [n_clips] [workers]
"""
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    n_clips = int(sys.argv[1]) if len(sys.argv) > 1 else 96
    workers = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    from desta25_audio_tpu import native
    from desta25_audio_tpu.config import DeSTA25Config
    from desta25_audio_tpu.data.dataset import (
        AudioTextDataset,
        CollateFn,
        DataConfig,
    )
    from desta25_audio_tpu.data.prefetch import PrefetchLoader

    tmp = tempfile.mkdtemp(prefix="loaderbench_")
    rng = np.random.default_rng(0)
    sr = 16000
    t0 = time.time()
    rows = []
    for i in range(n_clips):
        sig = (0.2 * rng.standard_normal(30 * sr)).astype(np.float32)
        path = os.path.join(tmp, f"clip{i}.flac")
        native.ff_encode(path, sig, sr)
        rows.append({"id": f"clip{i}.flac", "dataset": "bench",
                     "prompt": "Describe the audio. <|AUDIO|>",
                     "response": "A long noisy recording " * 8})
    enc_s = time.time() - t0
    sizes = sum(os.path.getsize(os.path.join(tmp, f"clip{i}.flac"))
                for i in range(n_clips))
    print(f"wrote {n_clips} x 30 s FLAC in {enc_s:.1f}s "
          f"({sizes/2**20:.0f} MiB total, "
          f"{sizes/n_clips/2**20:.2f} MiB/clip)")
    manifest = os.path.join(tmp, "train.jsonl")
    with open(manifest, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")

    cfg = DeSTA25Config(llm_model_id="test/llama-nano",
                        encoder_model_id="test/whisper-nano",
                        prompt_size=64)
    data_cfg = DataConfig(manifest_filepaths=[manifest], data_root=tmp,
                          max_seq_length=300, batch_size=12)
    from desta25_audio_tpu.data.tokenizer import build_tokenizer
    tk = build_tokenizer(cfg.llm_model_id, cfg.placeholder_token,
                         chat_template=cfg.llm_config.chat_template)
    ds = AudioTextDataset(cfg, data_cfg, tk)
    collate = CollateFn(cfg, data_cfg, tk)

    for nw in (1, workers):
        loader = PrefetchLoader(ds, collate, batch_size=12,
                                num_workers=nw, depth=4, drop_last=True)
        # one warm epoch to fault in everything
        n_batches = 0
        t0 = time.time()
        for batch in loader:
            n_batches += 1
        dt = time.time() - t0
        samples = n_batches * 12
        print(f"workers={nw:2d}: {n_batches} batches "
              f"({samples} samples) in {dt:.2f}s -> "
              f"{samples/dt:6.1f} samples/s "
              f"({samples*30/dt:6.0f} audio-sec/s decoded)")

    import shutil
    shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
