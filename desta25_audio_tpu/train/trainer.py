"""Training loop — the HF ``Trainer`` + ``DeSTA25Trainer`` replacement.

Reference behavior preserved (desta/trainer/desta_trainer.py,
examples/train/train_desta.py): epoch loop with optional max_steps,
eval-before-train + initial checkpoint on fresh runs, empty-batch skip with
zero loss, loss decomposition logging, eval loop with generation +
ConsecutiveWordsAccuracy + per-category report JSON (config dump + git
commit), epoch checkpoints, auto-resume from ``checkpoint-latest``.

One jitted train step (data-parallel over the active mesh);
metrics are fetched asynchronously (host logging never blocks the device
stream more than once per log interval).
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ckpt.checkpoint import restore_train_state, save_train_state
from ..config import DeSTA25Config
from ..data.dataset import AudioTextDataset, CollateFn, data_loader
from ..eval.metrics import ConsecutiveWordsAccuracyMetric
from ..generate.decode import llm_generate
from ..models.desta import DeSTA25AudioModel
from ..parallel.mesh import current_mesh, make_mesh, use_mesh
from ..parallel.sharding import (
    apply_sharding,
    fsdp_partition_specs,
    llm_partition_specs,
    replicated_specs,
    whisper_partition_specs,
)
from .optimizer import OptimizerConfig, make_optimizer
from .step import make_eval_step, make_train_step

logger = logging.getLogger(__name__)


@dataclass
class TrainerConfig:
    exp_dir: str = "exp"
    max_epochs: int = 2
    max_steps: int = -1
    log_every_n_steps: int = 10
    val_check_interval: float = 1.0   # fraction of epoch, or >1 = steps
    eval_max_new_tokens: int = 16
    eval_do_sample: bool = False
    save_strategy: str = "epoch"
    keep_checkpoints: int = 3
    remat: bool = False
    # GPipe pipeline parallelism: microbatch count when the active mesh
    # has a "pipe" axis (parallel/pipeline.py); 0 = off
    pipeline_microbatches: int = 0
    # Megatron-style sequence parallelism: residual stream seq-sharded
    # over the "model" mesh axis between decoder blocks (no-op off-mesh)
    sequence_parallel: bool = False
    # Device mesh: "off" (default) = single-program placement, the caller
    # may still install a mesh around train(); "auto" = build a
    # (data, model[, pipe]) mesh over all visible devices when more than
    # one is present or any parallel feature below is requested; "on" =
    # always build one.  The trainer then shards the frozen towers
    # (tensor-parallel over "model" when mesh_model > 1), the batch over
    # "data", and — with fsdp — the trainable params + optimizer state
    # over "data" (ZeRO-3).
    mesh: str = "off"
    mesh_model: int = 1   # tensor-parallel size ("model" axis)
    mesh_pipe: int = 1    # pipeline stages ("pipe" axis, GPipe)
    fsdp: bool = False    # shard trainable params + opt state over "data"
    eval_before_train: bool = True
    eval_max_batches: int = -1
    num_workers: int = 0  # >0 enables the prefetching thread-pool loader
    seed: int = 0
    # Halve the batch size and restart the epoch on device OOM, like the
    # reference's TrainingArguments(auto_find_batch_size=True)
    # (train_desta.py:161).  Only fires before the first successful step —
    # with static shapes, a step that ran once cannot OOM later.
    auto_find_batch_size: bool = True


class MetricsLogger:
    """JSONL metrics writer + optional wandb (desta_trainer.py:60-100)."""

    def __init__(self, exp_dir: str, use_wandb: bool = False,
                 wandb_kwargs: Optional[Dict] = None):
        os.makedirs(exp_dir, exist_ok=True)
        self.path = os.path.join(exp_dir, "metrics.jsonl")
        self.wandb = None
        if use_wandb and jax.process_index() == 0:
            try:
                import wandb
                self.wandb = wandb
                wandb.init(**(wandb_kwargs or {}))
            except Exception:  # noqa: BLE001
                logger.warning("wandb unavailable; falling back to JSONL")

    def log(self, metrics: Dict[str, Any], step: int):
        if jax.process_index() != 0:
            return
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()
                                if np.isscalar(v) or np.ndim(v) == 0}}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.wandb is not None:
            self.wandb.log(rec, step=step)


def _is_oom(e: Exception) -> bool:
    s = str(e)
    return ("RESOURCE_EXHAUSTED" in s or "Out of memory" in s
            or "out of memory" in s or "OOM" in s)


def _git_commit() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5).stdout.strip()
    except Exception:  # noqa: BLE001
        return "unknown"


class DeSTA25Trainer:
    def __init__(self, model: DeSTA25AudioModel,
                 train_dataset: AudioTextDataset,
                 eval_dataset: Optional[AudioTextDataset],
                 collate_fn: CollateFn,
                 optimizer_config: OptimizerConfig,
                 trainer_config: TrainerConfig,
                 logger_: Optional[MetricsLogger] = None):
        self.model = model
        self.config = model.config
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.collate_fn = collate_fn
        self.opt_cfg = optimizer_config
        self.tcfg = trainer_config
        self.metrics = logger_ or MetricsLogger(trainer_config.exp_dir)
        self.accuracy = ConsecutiveWordsAccuracyMetric()

        # Device mesh (opt-in; see TrainerConfig.mesh).  Built here so the
        # jitted steps below trace with the mesh semantics in place.
        tc = trainer_config
        want_mesh = (tc.mesh == "on" or tc.mesh_model > 1
                     or tc.mesh_pipe > 1 or tc.fsdp
                     or (tc.mesh == "auto" and len(jax.devices()) > 1))
        if tc.mesh not in ("off", "auto", "on"):
            raise ValueError(f"trainer.mesh={tc.mesh!r} "
                             "(expected 'off', 'auto', or 'on')")
        self.mesh = (make_mesh(n_model=tc.mesh_model, n_pipe=tc.mesh_pipe)
                     if tc.mesh != "off" and want_mesh else None)
        if self.mesh is not None:
            bs = collate_fn.data_cfg.batch_size
            n_data = self.mesh.shape["data"]
            if bs % n_data:
                raise ValueError(
                    f"batch_size={bs} not divisible by the mesh's data "
                    f"axis ({n_data}); pick a divisible batch size or a "
                    f"larger mesh_model/mesh_pipe")

        self.optimizer = make_optimizer(optimizer_config)
        self.train_step = make_train_step(
            self.config, self.optimizer,
            remat=trainer_config.remat,
            pipeline_microbatches=trainer_config.pipeline_microbatches,
            sequence_parallel=trainer_config.sequence_parallel)
        self.eval_step = make_eval_step(
            self.config,
            remat=trainer_config.remat,
            pipeline_microbatches=trainer_config.pipeline_microbatches,
            sequence_parallel=trainer_config.sequence_parallel)
        self.global_step = 0

    # -- helpers ----------------------------------------------------------

    def _mesh_ctx(self):
        """Install the trainer-owned mesh (no-op when mesh="off", so a
        caller-installed ``use_mesh`` context stays in charge)."""
        if self.mesh is None:
            import contextlib
            return contextlib.nullcontext(current_mesh())
        return use_mesh(self.mesh)

    def _device_batch(self, batch: Dict[str, Any]) -> Dict[str, jnp.ndarray]:
        out = {k: jnp.asarray(v) for k, v in batch.items()
               if isinstance(v, np.ndarray)}
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            n_data = self.mesh.shape["data"]
            # leading-dim "data" sharding where divisible (input_ids etc.
            # are [B, ...]; audio/trans are [N_clips, ...] — N tracks B
            # through the collate but replicate defensively when it
            # doesn't divide), everything else replicated
            out = {
                k: jax.device_put(v, NamedSharding(
                    self.mesh,
                    P("data", *([None] * (v.ndim - 1)))
                    if v.ndim >= 1 and v.shape[0] % n_data == 0 else P()))
                for k, v in out.items()
            }
        return out

    def _shard_state(self, trainable, frozen):
        """Apply parameter shardings for the trainer-owned mesh: frozen
        towers tensor-parallel over "model", trainable replicated (or
        ZeRO-3 "data"-sharded with fsdp)."""
        if self.mesh is None:
            return trainable, frozen
        with use_mesh(self.mesh):
            frozen = dict(frozen)
            for key, spec_fn in (("llm", llm_partition_specs),
                                 ("whisper", whisper_partition_specs)):
                if key in frozen:
                    frozen[key] = apply_sharding(frozen[key],
                                                 spec_fn(frozen[key]))
            for key in frozen:
                if key not in ("llm", "whisper"):
                    frozen[key] = apply_sharding(
                        frozen[key], replicated_specs(frozen[key]))
            trainable = apply_sharding(
                trainable,
                fsdp_partition_specs(trainable) if self.tcfg.fsdp
                else replicated_specs(trainable))
        return trainable, frozen

    def _steps_per_epoch(self) -> int:
        return max(len(self.train_dataset)
                   // self.collate_fn.data_cfg.batch_size, 1)

    # -- train ------------------------------------------------------------

    def train(self, resume_from_checkpoint: Optional[str] = None):
        with self._mesh_ctx():
            return self._train_impl(resume_from_checkpoint)

    def _train_impl(self, resume_from_checkpoint: Optional[str] = None):
        trainable, frozen = self.model.split_params()
        trainable, frozen = self._shard_state(trainable, frozen)
        # init AFTER sharding so state derived from params starts on the
        # right devices (adafactor's factored stats are tiny; the fsdp
        # memory win is params + grads, preserved by the jitted step)
        opt_state = self.optimizer.init(trainable)
        start_epoch = 0
        if resume_from_checkpoint:
            trainable, opt_state, self.global_step = restore_train_state(
                resume_from_checkpoint, trainable, opt_state)
            trainable, frozen = self._shard_state(trainable, frozen)
            start_epoch = self.global_step // self._steps_per_epoch()
            logger.info("resumed from step %d (epoch %d)",
                        self.global_step, start_epoch)
        elif self.tcfg.eval_before_train and self.eval_dataset is not None:
            # eval-before-train + initial checkpoint (train_desta.py:222-228)
            self.model.params = {**frozen, **trainable}
            self.evaluate(tag="initial")
            save_train_state(self.tcfg.exp_dir, 0, trainable, opt_state,
                             self.config, keep=self.tcfg.keep_checkpoints)

        bs = self.collate_fn.data_cfg.batch_size
        spe = self._steps_per_epoch()
        val_every = (int(self.tcfg.val_check_interval) if
                     self.tcfg.val_check_interval > 1.0 else
                     max(int(spe * self.tcfg.val_check_interval), 1))
        t_last = time.time()

        # max_steps takes precedence over max_epochs (reference
        # desta25_*.yaml trainer section: "precedence over max_epochs")
        max_epochs = (10 ** 9 if self.tcfg.max_steps > 0
                      else self.tcfg.max_epochs)
        stepped_ok = False
        for epoch in range(start_epoch, max_epochs):
            while True:  # auto_find_batch_size retry (restarts the epoch)
                bs = self.collate_fn.data_cfg.batch_size
                if self.tcfg.num_workers > 0:
                    from ..data.prefetch import PrefetchLoader
                    loader = PrefetchLoader(
                        self.train_dataset, self.collate_fn, bs,
                        epoch=epoch, num_workers=self.tcfg.num_workers)
                else:
                    loader = data_loader(self.train_dataset,
                                         self.collate_fn, bs, epoch=epoch)
                try:
                    for batch in loader:
                        if batch.get("_empty_batch"):
                            logger.warning("empty batch at step %d; "
                                           "skipped", self.global_step)
                            continue
                        db = self._device_batch(batch)
                        if (self.config.use_lora
                                and self.config.lora_dropout > 0):
                            # per-step adapter-dropout key (peft train())
                            db["lora_rng"] = jax.random.PRNGKey(
                                self.global_step)
                        trainable, opt_state, metrics = self.train_step(
                            trainable, frozen, opt_state, db)
                        if not stepped_ok:
                            # force materialization so an allocation
                            # failure surfaces here, not at a later fetch
                            jax.block_until_ready(metrics)
                            stepped_ok = True
                        self.global_step += 1

                        if (self.global_step
                                % self.tcfg.log_every_n_steps == 0):
                            m = {k: float(v) for k, v in
                                 jax.device_get(metrics).items()}
                            dt = time.time() - t_last
                            m["steps_per_sec"] = (
                                self.tcfg.log_every_n_steps / dt
                                if dt > 0 else 0.0)
                            m["epoch"] = epoch
                            t_last = time.time()
                            self.metrics.log({f"train/{k}": v
                                              for k, v in m.items()},
                                             self.global_step)

                        if (self.eval_dataset is not None
                                and self.global_step % val_every == 0):
                            self.model.params = {**frozen, **trainable}
                            self.evaluate(
                                tag=f"ep={epoch}-step={self.global_step}")

                        if 0 < self.tcfg.max_steps <= self.global_step:
                            break
                except Exception as e:  # noqa: BLE001
                    if (not self.tcfg.auto_find_batch_size or stepped_ok
                            or bs <= 1 or not _is_oom(e)):
                        raise
                    new_bs = max(bs // 2, 1)
                    logger.warning(
                        "device OOM at batch_size=%d; retrying the epoch "
                        "at batch_size=%d (auto_find_batch_size)", bs,
                        new_bs)
                    self.collate_fn.data_cfg.batch_size = new_bs
                    spe = self._steps_per_epoch()
                    val_every = (int(self.tcfg.val_check_interval) if
                                 self.tcfg.val_check_interval > 1.0 else
                                 max(int(spe
                                         * self.tcfg.val_check_interval),
                                     1))
                    continue
                break
            if self.tcfg.save_strategy == "epoch":
                save_train_state(self.tcfg.exp_dir, self.global_step,
                                 trainable, opt_state, self.config,
                                 keep=self.tcfg.keep_checkpoints)
            if 0 < self.tcfg.max_steps <= self.global_step:
                break

        self.model.params = {**frozen, **trainable}
        save_train_state(self.tcfg.exp_dir, self.global_step, trainable,
                         opt_state, self.config,
                         keep=self.tcfg.keep_checkpoints)
        return self.model

    # -- eval -------------------------------------------------------------

    def evaluate(self, tag: str = "val") -> Dict[str, float]:
        """Loss/ppl + generation eval with per-category accuracy report
        (desta_trainer.py:104-251)."""
        with self._mesh_ctx():
            return self._evaluate_impl(tag)

    def _evaluate_impl(self, tag: str = "val") -> Dict[str, float]:
        assert self.eval_dataset is not None
        tk = self.model.tokenizer
        losses: List[float] = []
        results: List[Dict[str, Any]] = []
        self.accuracy.reset()

        bs = self.collate_fn.data_cfg.batch_size
        n_batches = 0
        for batch in data_loader(self.eval_dataset, self.collate_fn, bs,
                                 drop_last=False):
            if batch.get("_empty_batch"):
                continue
            db = self._device_batch(batch)
            m = self.eval_step(self.model.params, db)
            losses.append(float(m["lm_loss"]))

            # generation from the context-only view
            gen_batch = dict(db)
            gen_batch["input_ids"] = db["context_input_ids"]
            gen_batch["attention_mask"] = db["context_attention_mask"]
            gen_batch["kind"] = db["context_kind"]
            gen_batch["aidx"] = db["context_aidx"]
            gen_batch["pos"] = db["context_pos"]
            texts = self._predict_step(gen_batch)

            for i, meta in enumerate(batch["metadata"]):
                label = meta.get("response", "")
                pred = texts[i]
                ok = self.accuracy.update(pred, label)
                results.append({
                    "context": meta.get("prompt", ""),
                    "label": label, "prediction": pred, "correct": ok,
                    "dataset": meta.get("dataset", "unknown"),
                })
            n_batches += 1
            if 0 < self.tcfg.eval_max_batches <= n_batches:
                break

        report = self._save_results(results, losses, tag)
        self.metrics.log({f"val/{k}": v for k, v in report.items()
                          if isinstance(v, (int, float))}, self.global_step)
        return report

    def _predict_step(self, db: Dict[str, jnp.ndarray]) -> List[str]:
        from ..audio.mel import log_mel, pad_or_trim
        enc_cfg = self.config.encoder_config
        wav = pad_or_trim(db["audio"], enc_cfg.expected_mel_frames * 160)
        mel = log_mel(wav, enc_cfg.num_mel_bins, layout="btm"
                      ).astype(self.model.dtype)
        embeds, _ = self.model._prepare_jit(
            self.model.params, db["input_ids"], mel, db["trans_ids"],
            db["kind"], db["aidx"], db["pos"])
        tk = self.model.tokenizer
        tokens, _ = llm_generate(
            self.model.params["llm"], self.config.llm_config, embeds,
            db["attention_mask"], jax.random.PRNGKey(self.tcfg.seed),
            max_new_tokens=self.tcfg.eval_max_new_tokens,
            do_sample=self.tcfg.eval_do_sample,
            eos_ids=self.model._terminators(), pad_id=tk.pad_token_id,
            lora=self.model.params.get("lora"))
        return tk.batch_decode(np.asarray(tokens), skip_special_tokens=True)

    def _save_results(self, results, losses, tag: str) -> Dict[str, Any]:
        loss = float(np.mean(losses)) if losses else 0.0
        report: Dict[str, Any] = {
            "loss": loss,
            "ppl": float(np.exp(loss)) if losses else 0.0,
            "accuracy": self.accuracy.compute(),
            "n_samples": len(results),
        }
        per_cat: Dict[str, List[bool]] = {}
        for r in results:
            per_cat.setdefault(r["dataset"], []).append(r["correct"])
        for cat, oks in sorted(per_cat.items()):
            report[f"accuracy/{cat}"] = float(np.mean(oks))

        if jax.process_index() == 0:
            os.makedirs(self.tcfg.exp_dir, exist_ok=True)
            base = os.path.join(self.tcfg.exp_dir, f"val@{tag}")
            with open(base + ".jsonl", "w") as f:
                for r in results:
                    f.write(json.dumps(r) + "\n")
            full = dict(report)
            full["config"] = self.config.to_dict()
            full["git_commit"] = _git_commit()
            full["step"] = self.global_step
            with open(base + "-report.json", "w") as f:
                json.dump(full, f, indent=2)
        logger.info("eval %s: %s", tag,
                    {k: v for k, v in report.items()
                     if isinstance(v, (int, float))})
        return report
