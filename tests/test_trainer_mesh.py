"""Trainer-owned mesh: the user-facing distributed-training entry
(trainer.mesh / mesh_model / fsdp YAML keys) — not the manual
use_mesh+apply_sharding plumbing the sharding tests drive.

Covers: mesh construction from TrainerConfig, frozen-tower tensor
parallelism, batch "data"-sharding, ZeRO-3 fsdp sharding of trainable
params + optimizer state, and numerical equality with the single-device
trainer.  Reference is DDP-only (SURVEY §2.7); this is a
superset.
"""

import json
import os

import numpy as np
import pytest

import jax

from desta25_audio_tpu import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu.audio.io import write_wav
from desta25_audio_tpu.data.dataset import (
    AudioTextDataset,
    CollateFn,
    DataConfig,
)
from desta25_audio_tpu.train.optimizer import OptimizerConfig
from desta25_audio_tpu.train.trainer import DeSTA25Trainer, TrainerConfig

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU mesh")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    rows = []
    os.makedirs(root / "clips", exist_ok=True)
    for i in range(8):
        t = np.arange(8000) / 16000.0
        sig = (0.4 * np.sin(2 * np.pi * (200 + 40 * i) * t)).astype(
            np.float32)
        rel = f"clips/a{i}.wav"
        write_wav(str(root / rel), sig)
        rows.append({"id": rel, "dataset": "synthetic",
                     "prompt": f"Describe sound {i} <|AUDIO|>",
                     "response": f"tone {i}"})
    manifest = root / "train.jsonl"
    with open(manifest, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(manifest), str(root)


def _build(corpus, tmp_path, name, **tkw):
    cfg = DeSTA25Config(
        llm_model_id="test/llama-nano",
        encoder_model_id="test/whisper-nano",
        connector_mode="qformer_1",
        qformer_num_hidden_layers=2,
        prompt_size=8,
        dtype="float32",
    )
    manifest, root = corpus
    model = DeSTA25AudioModel(cfg, seed=0)
    dcfg = DataConfig(manifest_filepaths=[manifest], data_root=root,
                      batch_size=4, max_seq_length=96,
                      num_audio_samples=48000, trans_max_tokens=8)
    ds = AudioTextDataset(cfg, dcfg, model.tokenizer)
    collate = CollateFn(cfg, dcfg, model.tokenizer)
    tcfg = TrainerConfig(exp_dir=str(tmp_path / name), max_epochs=1,
                         max_steps=2, log_every_n_steps=1,
                         eval_before_train=False, val_check_interval=1e9,
                         auto_find_batch_size=False, **tkw)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=20,
                           gradient_clip_val=1.0)
    return DeSTA25Trainer(model, ds, None, collate, ocfg, tcfg)


def _losses(exp_dir):
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["train/lm_loss"] for r in recs if "train/lm_loss" in r]


def test_trainer_mesh_matches_single_device(corpus, tmp_path):
    """mesh="on" + mesh_model=2 + fsdp: same per-step losses as the
    plain single-program trainer (numerics unchanged by layout)."""
    t_ref = _build(corpus, tmp_path, "ref")
    assert t_ref.mesh is None  # default mesh="off"
    t_ref.train()

    t_mesh = _build(corpus, tmp_path, "mesh", mesh="on", mesh_model=2,
                    fsdp=True)
    assert t_mesh.mesh is not None
    assert dict(t_mesh.mesh.shape) == {"data": 4, "model": 2}
    t_mesh.train()

    ref, got = _losses(t_ref.tcfg.exp_dir), _losses(t_mesh.tcfg.exp_dir)
    assert len(ref) == len(got) == 2
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_trainer_mesh_fsdp_shards_state(corpus, tmp_path):
    """fsdp actually shards: large trainable leaves are laid out over
    "data", the train step PRESERVES that layout on its output params
    (no silent all-replicate after step 1 — adafactor's factored stats
    are tiny, so params + grads are where ZeRO's memory win lives), and
    the batch rides P("data")."""
    from desta25_audio_tpu.data.dataset import data_loader

    tr = _build(corpus, tmp_path, "fsdp", mesh="on", mesh_model=2,
                fsdp=True)
    trainable, frozen = tr.model.split_params()
    trainable, frozen = tr._shard_state(trainable, frozen)
    n_sharded = sum(1 for leaf in jax.tree.leaves(trainable)
                    if not leaf.sharding.is_fully_replicated)
    assert n_sharded > 0, "no trainable leaf actually fsdp-sharded"

    batch = next(iter(data_loader(tr.train_dataset, tr.collate_fn, 4,
                                  epoch=0)))
    with tr._mesh_ctx():
        db = tr._device_batch(batch)
        assert not db["input_ids"].sharding.is_fully_replicated
        opt_state = tr.optimizer.init(trainable)
        new_tr, _, metrics = tr.train_step(trainable, frozen, opt_state,
                                           db)
    assert np.isfinite(float(metrics["lm_loss"]))
    kept = sum(1 for a, b in zip(jax.tree.leaves(trainable),
                                 jax.tree.leaves(new_tr))
               if not a.sharding.is_fully_replicated
               and not b.sharding.is_fully_replicated)
    assert kept == n_sharded, "train step dropped the fsdp layout"

    db2 = tr._device_batch({"scalarish": np.zeros((3,), np.float32)})
    assert db2["scalarish"].sharding.is_fully_replicated  # 3 % 4 != 0


def test_trainer_mesh_batch_divisibility_error(corpus, tmp_path):
    with pytest.raises(ValueError, match="not divisible"):
        _build(corpus, tmp_path, "bad", mesh="on", mesh_model=1,
               mesh_pipe=1, fsdp=False)  # batch 4 over data=8


def test_trainer_mesh_off_by_default(corpus, tmp_path):
    tr = _build(corpus, tmp_path, "off")
    assert tr.mesh is None
