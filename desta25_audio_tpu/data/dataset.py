"""JSONL audio-text dataset + fixed-shape collation.

Reference: ``BaseAudioTextDataset`` / ``BaseCollateFn``
(desta/trainer/data/simple_dataset.py).  Schema (prompt-only mode,
simple_dataset.py:306-320): fields ``id`` (relative audio path), ``prompt``,
``response``; ``messages``/``seed_description`` are ignored.

Design differences (deliberate: static shapes for jit):

- Preprocessing (chat template + placeholder expansion) is *lazy and
  deterministic* per item — no rank-0 save_to_disk / lock-file barrier
  (simple_dataset.py:361-452 exists to serialize an HF-datasets cache
  race; with stateless preprocessing there is nothing to cache).
- Multi-host sharding: each JAX process reads a strided slice of the
  manifest (``process_index``/``process_count``), the GSPMD equivalent of
  DistributedSampler.
- Collation pads every batch to a *fixed* [B, max_seq_length] so the jitted
  train step compiles once; audio decode failures skip samples (stats
  logged) and a fully-failed batch returns ``{"_empty_batch": True}``
  exactly like the reference (simple_dataset.py:152-172).
- The mel transform runs on device inside the train step; collate emits raw
  padded waveforms.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..audio.io import AudioSegment
from ..config import DeSTA25Config
from ..models.splice import (
    SpliceEntry,
    build_splice_maps,
    expand_audio_placeholders,
)

logger = logging.getLogger(__name__)


@dataclass
class DataConfig:
    """Mirrors the reference dataset YAML schema
    (examples/train/config/dataset/*.yaml)."""

    manifest_filepaths: Sequence[str] = field(default_factory=list)
    data_root: str = ""
    batch_size: int = 8
    max_seq_length: int = 300
    system_prompt: Optional[str] = None
    shuffle: bool = True
    seed: int = 42
    num_audio_samples: int = 480000  # 30 s @ 16 kHz
    trans_max_tokens: int = 64


def _resolve_audio_filepath(path: str) -> str:
    """Fallback to .wav extension (simple_dataset.py:103-114); URLs are
    downloaded to the local cache first (lulutils resolve_filepath
    behavior, simple_dataset.py:20)."""
    if path.startswith(("http://", "https://")):
        from desta25_audio_tpu.utils.misc import resolve_filepath
        return resolve_filepath(path)
    if os.path.exists(path):
        return path
    alt = path + ".wav"
    if os.path.exists(alt):
        return alt
    root, _ = os.path.splitext(path)
    alt = root + ".wav"
    if os.path.exists(alt):
        return alt
    raise FileNotFoundError(path)


class AudioTextDataset:
    """Prompt-only dataset: one audio per sample, target = response + eos."""

    def __init__(self, config: DeSTA25Config, data_cfg: DataConfig,
                 tokenizer, shard_by_process: bool = True):
        self.config = config
        self.data_cfg = data_cfg
        self.tokenizer = tokenizer
        self.audio_locator = config.audio_locator
        self.placeholder_token = config.placeholder_token
        self.skip_reasons = {"empty_prompt": 0, "audio_file_not_found": 0,
                             "no_audio_markers": 0, "empty_response": 0}

        from desta25_audio_tpu.utils.misc import resolve_filepath
        rows: List[Dict[str, Any]] = []
        for path in data_cfg.manifest_filepaths:
            # URL manifests download to the local cache
            # (reference simple_dataset.py:365 via lulutils)
            with open(resolve_filepath(path)) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        rows.append(json.loads(line))
        if shard_by_process:
            import jax
            rows = rows[jax.process_index()::jax.process_count()]
        self.rows = rows
        logger.info("loaded %d rows from %d manifests", len(rows),
                    len(data_cfg.manifest_filepaths))

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> Optional[Dict[str, Any]]:
        return self.preprocess(self.rows[idx])

    def preprocess(self, row: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Prompt-only preprocessing (simple_dataset.py:574-743).
        Returns None for skipped samples (with reason stats)."""
        tk = self.tokenizer
        prompt = (row.get("prompt") or "").strip()
        if not prompt:
            self.skip_reasons["empty_prompt"] += 1
            return None
        response = row.get("response") or ""
        if not response:
            self.skip_reasons["empty_response"] += 1
            return None
        if self.audio_locator not in prompt:
            user_content = f"{prompt} {self.audio_locator}"
        else:
            user_content = prompt

        messages = []
        if self.data_cfg.system_prompt:
            messages.append({"role": "system",
                             "content": self.data_cfg.system_prompt})
        messages.append({"role": "user", "content": user_content})
        context = tk.apply_chat_template(messages, tokenize=False,
                                         add_generation_prompt=True)

        try:
            audio_path = _resolve_audio_filepath(
                os.path.join(self.data_cfg.data_root, row["id"]))
        except FileNotFoundError:
            self.skip_reasons["audio_file_not_found"] += 1
            return None

        K = self.config.audio_token_size
        transcription = ""  # training uses empty transcriptions
        trans_size = len(tk.tokenize(transcription,
                                     add_special_tokens=False))
        # Prefer <start_audio>...<end_audio> blocks when present (the
        # training-stage marker format, simple_dataset.py:674-699), else
        # expand the bare locator.
        if "<start_audio>" in context and "<end_audio>" in context:
            from ..models.splice import expand_audio_blocks
            audio_context, starts = expand_audio_blocks(
                context, [K], [trans_size], self.placeholder_token, tk)
        elif self.audio_locator in context:
            toks, starts = expand_audio_placeholders(
                tk.tokenize(context), self.audio_locator, [K], [trans_size],
                self.placeholder_token)
            audio_context = tk.convert_tokens_to_string(toks)
        else:
            self.skip_reasons["no_audio_markers"] += 1
            return None
        eos = getattr(tk, "eos_token", None) or ""
        item = {
            "audio_context": audio_context,
            "start_positions": starts,
            "processed_audios": [{"audio": audio_path,
                                  "text": transcription}],
            "transcription_list": [transcription],
            "target": response + eos,
            "metadata": row,
        }
        # optional ORCA prosody fields ride through to the collate fn
        # (simple_dataset.py:266-299)
        for prosody_key in ("f0_energy_global", "f0_energy_local"):
            if prosody_key in row:
                item[prosody_key] = row[prosody_key]
        return item

    def iter_valid(self, epoch: int = 0) -> Iterator[Dict[str, Any]]:
        order = np.arange(len(self.rows))
        if self.data_cfg.shuffle:
            np.random.default_rng(self.data_cfg.seed + epoch).shuffle(order)
        for i in order:
            item = self.preprocess(self.rows[int(i)])
            if item is not None:
                yield item


class CollateFn:
    """Batch builder producing fixed-shape numpy arrays + splice maps."""

    def __init__(self, config: DeSTA25Config, data_cfg: DataConfig,
                 tokenizer):
        self.config = config
        self.data_cfg = data_cfg
        self.tokenizer = tokenizer
        assert tokenizer.padding_side == "left", \
            f"padding_side must be left, got {tokenizer.padding_side}"

    def _tokenize_fixed(self, texts: List[str]) -> Dict[str, np.ndarray]:
        tk = self.tokenizer
        L = self.data_cfg.max_seq_length
        ids = np.full((len(texts), L), tk.pad_token_id, np.int32)
        mask = np.zeros((len(texts), L), np.int32)
        for i, t in enumerate(texts):
            e = tk.encode(t, add_special_tokens=False)[:L]
            if e:
                ids[i, L - len(e):] = e
                mask[i, L - len(e):] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def __call__(self, batch: List[Dict[str, Any]]) -> Dict[str, Any]:
        # Decode audio first; drop samples whose audio fails to decode.
        valid, waveforms = [], []
        for item in batch:
            try:
                segs = [AudioSegment.from_file(
                    a["audio"], target_sr=16000,
                    channel_selector="average").samples
                    for a in item["processed_audios"]]
            except Exception as e:  # noqa: BLE001
                logger.warning("skipping sample, audio decode error: %s", e)
                continue
            valid.append(item)
            waveforms.append(segs)
        if not valid:
            return {"_empty_batch": True}
        batch = valid

        L = self.data_cfg.max_seq_length
        tk = self.tokenizer
        full = self._tokenize_fixed(
            [it["audio_context"] + it["target"] for it in batch])
        ctx = self._tokenize_fixed([it["audio_context"] for it in batch])

        labels = np.full_like(full["input_ids"], -100)
        entries, ctx_entries = [], []
        flat_audio: List[np.ndarray] = []
        trans_texts: List[str] = []
        audio_idx = 0
        for i, item in enumerate(batch):
            ctx_tok_len = len(tk.tokenize(item["audio_context"]))
            pad_len = L - int(full["attention_mask"][i].sum())
            start_answer = pad_len + ctx_tok_len
            labels[i, start_answer:] = full["input_ids"][i, start_answer:]
            # answer region only where attended (truncation safety)
            labels[i][full["attention_mask"][i] == 0] = -100

            ctx_pad = L - int(ctx["attention_mask"][i].sum())
            for j, start in enumerate(item["start_positions"]):
                trans = item["transcription_list"][j]
                # Clamp to the static transcription buffer: trans_ids is
                # capped at trans_max_tokens below, and a longer splice
                # entry would silently repeat the final embedding
                # (models/splice.py index clamp).  Tail placeholder
                # positions past the clamp stay text-embedded.
                tlen = min(
                    len(tk.tokenize(trans, add_special_tokens=False)),
                    self.data_cfg.trans_max_tokens)
                entries.append(SpliceEntry(
                    i, start + pad_len, audio_idx,
                    self.config.audio_token_size, tlen))
                ctx_entries.append(SpliceEntry(
                    i, start + ctx_pad, audio_idx,
                    self.config.audio_token_size, tlen))
                flat_audio.append(waveforms[i][j])
                trans_texts.append(trans)
                audio_idx += 1

        N = len(flat_audio)
        audio = np.zeros((N, self.data_cfg.num_audio_samples), np.float32)
        for i, w in enumerate(flat_audio):
            n = min(len(w), audio.shape[1])
            audio[i, :n] = w[:n]

        Ttr = self.data_cfg.trans_max_tokens
        trans_ids = np.zeros((N, Ttr), np.int32)
        trans_mask = np.zeros((N, Ttr), np.int32)
        for i, t in enumerate(trans_texts):
            e = tk.encode(t, add_special_tokens=False)[:Ttr]
            trans_ids[i, :len(e)] = e
            trans_mask[i, :len(e)] = 1

        kind, aidx, pos = build_splice_maps(len(batch), L, entries)
        ckind, caidx, cpos = build_splice_maps(len(batch), L, ctx_entries)

        out_prosody = self._collate_prosody(batch)

        return {
            **out_prosody,
            "input_ids": full["input_ids"],
            "attention_mask": full["attention_mask"],
            "labels": labels,
            "audio": audio,
            "trans_ids": trans_ids,
            "trans_mask": trans_mask,
            "kind": kind, "aidx": aidx, "pos": pos,
            "context_input_ids": ctx["input_ids"],
            "context_attention_mask": ctx["attention_mask"],
            "context_kind": ckind, "context_aidx": caidx,
            "context_pos": cpos,
            "metadata": [it["metadata"] for it in batch],
        }

    @staticmethod
    def _collate_prosody(batch: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Optional ORCA prosody fields (simple_dataset.py:266-299):
        f0_energy_global [B, 4] and f0_energy_local [B, T, 2], zero-filled
        for samples that lack them.  The local length is padded to a
        multiple of 8 (static-shape friendliness) rather than the ragged
        max the reference uses."""
        out: Dict[str, Any] = {}
        if any("f0_energy_global" in it for it in batch):
            g = np.zeros((len(batch), 4), np.float32)
            for i, it in enumerate(batch):
                if "f0_energy_global" in it:
                    g[i] = np.asarray(it["f0_energy_global"], np.float32)
            out["f0_energy_global"] = g
        if any("f0_energy_local" in it for it in batch):
            max_len = max(len(it.get("f0_energy_local", ()))
                          for it in batch)
            max_len = -(-max(max_len, 1) // 8) * 8
            loc = np.zeros((len(batch), max_len, 2), np.float32)
            for i, it in enumerate(batch):
                if "f0_energy_local" in it:
                    t = np.asarray(it["f0_energy_local"], np.float32)
                    loc[i, :t.shape[0]] = t[:max_len]
            out["f0_energy_local"] = loc
        return out


def data_loader(dataset: AudioTextDataset, collate: CollateFn,
                batch_size: int, epoch: int = 0,
                drop_last: bool = True) -> Iterator[Dict[str, Any]]:
    """Simple host-side loader (single-threaded; grain/thread pool variant
    can slot in here without touching the trainer)."""
    buf: List[Dict[str, Any]] = []
    for item in dataset.iter_valid(epoch):
        buf.append(item)
        if len(buf) == batch_size:
            yield collate(buf)
            buf = []
    if buf and not drop_last:
        yield collate(buf)
