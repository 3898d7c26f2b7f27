"""DeSTA25AudioModel — the public model API.

Preserves the reference surface (modeling_desta25.py:698-1747):
``DeSTA25AudioModel.from_pretrained(...)``, ``generate(messages=...)`` with
audio dicts, ``forward`` for training, trainable-only ``state_dict``.

Architecture:
- host phase A: audio decode + VAD (CPU), mel + Whisper-ASR greedy decode
  (device, jitted) for speech clips lacking transcriptions;
- host phase B: chat template, ``<start_audio><|AUDIO|><end_audio>`` wrap,
  placeholder expansion, left-pad tokenization, splice-map construction;
- device phase C: one jitted program — mel -> encoder taps -> connector ->
  splice into the embedding stream -> prefill -> while-loop decode.

The two-phase host/device split exists because ASR output length changes
the token layout (SURVEY §7 "ASR-inside-generate").
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..audio.io import AudioSegment
from ..audio.mel import log_mel, pad_or_trim
from ..audio.vad import has_speech
from ..config import DeSTA25Config
from ..data.tokenizer import build_tokenizer
from ..generate.decode import llm_generate, whisper_transcribe
from ..models import llm as jllm
from ..models import whisper as jw
from ..models.perception import perception_apply
from ..models.qformer import init_qformer_connector
from ..models.splice import (
    SpliceEntry,
    apply_splice,
    build_splice_maps,
    expand_audio_placeholders,
)

logger = logging.getLogger(__name__)


@dataclass
class GenerationOutput:
    """Reference GenerationOutput (modeling_desta25.py:492-496)."""

    audios: list
    generated_ids: list
    text: List[str]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class DeSTA25AudioModel:
    """Top-level LALM: frozen Whisper + frozen LLM + trainable connector."""

    def __init__(self, config: DeSTA25Config, params: Optional[Dict] = None,
                 seed: int = 0, tokenizer=None):
        self.config = config
        self.llm_cfg = config.llm_config
        self.enc_cfg = config.encoder_config
        self.audio_locator = config.audio_locator
        self.placeholder_token = config.placeholder_token
        self.dtype = (jnp.bfloat16 if config.dtype == "bfloat16"
                      else jnp.float32)

        if params is None:
            params = self.init_params(jax.random.PRNGKey(seed))
        self.params = params
        self._tokenizer = tokenizer
        self._whisper_tokenizer = None
        self._gen_key = jax.random.PRNGKey(seed + 1)
        # Optional ASR temperature-fallback cascade: set to a (possibly
        # empty) kwargs dict for whisper_transcribe_with_fallback; None
        # keeps the reference's single greedy pass.
        self.asr_fallback: Optional[Dict[str, Any]] = None
        # jitted phase-C prepare (perception + splice): eager execution
        # would dispatch every op individually
        self._prepare_jit = jax.jit(self.prepare_inputs_embeds)
        # audio-feature cache (serving): None = off; see
        # enable_audio_cache().  The cached path splits phase C into a
        # perception program over cache MISSES only + a splice program.
        self.audio_cache = None
        self._perception_jit = jax.jit(
            lambda p, mel: perception_apply(p, mel, self.config))
        self._splice_jit = jax.jit(self.prepare_inputs_embeds_from_feats)

    # -- params -----------------------------------------------------------

    def init_params(self, key) -> Dict[str, Any]:
        # One jitted program: eager init would dispatch hundreds of small
        # ops one by one.
        return jax.jit(self._init_params)(key)

    def _init_params(self, key) -> Dict[str, Any]:
        kw, kl, kc, klo = jax.random.split(key, 4)
        params: Dict[str, Any] = {
            "whisper": jw.init_whisper(kw, self.enc_cfg, dtype=self.dtype),
            "llm": jllm.init_llm(kl, self.llm_cfg, dtype=self.dtype),
        }
        if self.config.llm_quant == "int8":
            from ..ops.quant import quantize_llm_params
            params["llm"] = quantize_llm_params(params["llm"])
        if self.config.resolved_encoder_quant(inference=False) == "int8":
            from ..ops.quant import quantize_encoder_params
            params["whisper"]["encoder"] = quantize_encoder_params(
                params["whisper"]["encoder"])
        if self.config.connector_mode == "qformer_1":
            params["connector"] = init_qformer_connector(
                kc, self.config, dtype=jnp.float32)
        elif self.config.connector_mode == "orca_hybrid":
            from .orca import init_orca_connector, init_orca_cross_attns
            params["connector"] = init_orca_connector(
                kc, self.config, dtype=jnp.float32)
            if self.config.orca_deep_injection_enabled:
                params["orca_cross_attns"] = init_orca_cross_attns(
                    kc, self.config,
                    dtype=jnp.dtype(self.config.orca_xattn_dtype))
        else:
            raise NotImplementedError(self.config.connector_mode)
        if self.config.use_lora:
            params["lora"] = jllm.init_lora(
                klo, self.llm_cfg, self.config.lora_rank)
        return params

    def merge_lora_for_serving(self, quantize: bool = True) -> None:
        """Fold the LoRA adapters into the LLM weights and drop them
        (peft ``merge_and_unload``) — a serving transform that lets the
        tower decode without the per-layer adapter matmuls and be
        int8-quantized.  quantize=True additionally int8-quantizes the
        merged tower (requires an unquantized base).  Exact at
        inference; do NOT train or save checkpoints afterwards."""
        lora = self.params.get("lora")
        if lora is None:
            return
        merged = jllm.merge_lora(self.params["llm"], lora,
                                 self.config.lora_scale)
        if quantize:
            from ..ops.quant import quantize_llm_params
            merged = jax.jit(quantize_llm_params)(merged)
        # drop the adapters only once the merge succeeded — a failed
        # merge (e.g. already-quantized base) must not silently strip
        # the LoRA deltas from the model
        self.params["llm"] = merged
        del self.params["lora"]

    def trainable_keys(self) -> Tuple[str, ...]:
        """Which top-level param subtrees train (reference
        configure_trainable_parameters, modeling_desta25.py:1439-1463:
        everything except LLM and Whisper)."""
        keys = [k for k in self.params
                if k not in ("whisper", "llm")]
        return tuple(keys)

    def split_params(self):
        """(trainable, frozen) param trees."""
        trainable = {k: self.params[k] for k in self.trainable_keys()}
        frozen = {k: v for k, v in self.params.items()
                  if k not in trainable}
        return trainable, frozen

    # -- tokenizers -------------------------------------------------------

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            self._tokenizer = build_tokenizer(
                self.config.llm_model_id, self.placeholder_token,
                chat_template=self.llm_cfg.chat_template)
        return self._tokenizer

    @property
    def whisper_tokenizer(self):
        if self._whisper_tokenizer is None:
            if self.config.encoder_model_id.startswith("test/"):
                class _CharASR:
                    @staticmethod
                    def batch_decode(ids_batch, skip_special_tokens=True):
                        return ["".join(chr(i) for i in ids
                                        if int(i) < 128)
                                for ids in np.asarray(ids_batch)]
                self._whisper_tokenizer = _CharASR()
            else:
                from transformers import AutoProcessor
                self._whisper_tokenizer = AutoProcessor.from_pretrained(
                    self.config.encoder_model_id)
        return self._whisper_tokenizer

    # -- device programs --------------------------------------------------

    def _mel(self, audio_batch: np.ndarray) -> jnp.ndarray:
        """[N, samples] -> [N, frames, n_mels] log-mel (device, jitted)."""
        if not hasattr(self, "_mel_jit"):
            def f(a):
                x = pad_or_trim(a, self.enc_cfg.expected_mel_frames * 160)
                return log_mel(x, self.enc_cfg.num_mel_bins, layout="btm"
                               ).astype(self.dtype)
            self._mel_jit = jax.jit(f)
        return self._mel_jit(jnp.asarray(audio_batch))

    def _asr(self, audio_batch: np.ndarray, max_new_tokens: int = 128
             ) -> List[str]:
        mel = self._mel(audio_batch)
        # Real checkpoints: suppress the special-token block
        # (language/task/timestamps via suppress_from) plus the canonical
        # non-speech id list and begin-suppression, mirroring HF
        # generation_config (modeling_desta25.py:1586-1594 inherits it).
        # Nano test vocabs keep everything decodable.
        if self.config.encoder_model_id.startswith("test/"):
            sup = dict(suppress_from=None)
        else:
            from ..generate.decode import (
                WHISPER_BEGIN_SUPPRESS_TOKEN_IDS,
                WHISPER_NON_SPEECH_TOKEN_IDS,
            )
            sup = dict(
                suppress_from=self.enc_cfg.decoder_start_token_id,
                suppress_ids=WHISPER_NON_SPEECH_TOKEN_IDS,
                begin_suppress_ids=WHISPER_BEGIN_SUPPRESS_TOKEN_IDS)
        if self.asr_fallback is not None:
            from ..generate.decode import whisper_transcribe_with_fallback
            texts, _, _ = whisper_transcribe_with_fallback(
                self.params["whisper"], self.enc_cfg, mel,
                self._asr_detokenize, max_new_tokens=max_new_tokens,
                **sup, **self.asr_fallback)
            return texts
        ids, _ = whisper_transcribe(self.params["whisper"], self.enc_cfg,
                                    mel, max_new_tokens=max_new_tokens,
                                    **sup)
        return self._asr_detokenize(ids)

    def _asr_detokenize(self, ids) -> List[str]:
        return self.whisper_tokenizer.batch_decode(
            np.asarray(ids), skip_special_tokens=True)

    def prepare_inputs_embeds(self, params, input_ids, mel, trans_ids,
                              kind, aidx, pos):
        """Device-side: perception + splice (jit-traceable).

        Returns (inputs_embeds [B, T, D], aux) where aux carries ORCA local
        tokens (or None)."""
        text_embeds = jllm.embed_tokens(params["llm"], input_ids)
        if mel is None:
            return text_embeds, None
        audio_feats, local_tokens = perception_apply(params, mel,
                                                     self.config)
        trans_embeds = jax.lax.stop_gradient(
            jllm.embed_tokens(params["llm"], trans_ids))
        embeds = apply_splice(text_embeds, audio_feats, trans_embeds,
                              kind, aidx, pos)
        return embeds, (audio_feats, local_tokens)

    def prepare_inputs_embeds_from_feats(self, params, input_ids,
                                         audio_feats, trans_ids, kind,
                                         aidx, pos):
        """Splice-only device program: like ``prepare_inputs_embeds`` but
        taking precomputed per-clip connector tokens (audio-feature cache
        path) instead of mel."""
        text_embeds = jllm.embed_tokens(params["llm"], input_ids)
        trans_embeds = jax.lax.stop_gradient(
            jllm.embed_tokens(params["llm"], trans_ids))
        return apply_splice(text_embeds, audio_feats, trans_embeds,
                            kind, aidx, pos)

    def enable_audio_cache(self, capacity: int = 64) -> None:
        """Turn on the per-clip feature cache (file decode + VAD + ASR +
        perception skipped on hits; models/feature_cache.py).  Serving
        default; one-shot generate() leaves it off."""
        from .feature_cache import AudioFeatureCache
        if capacity <= 0:
            self.audio_cache = None
        elif self.audio_cache is None \
                or self.audio_cache.capacity != capacity:
            self.audio_cache = AudioFeatureCache(capacity)

    # -- generate ---------------------------------------------------------

    def generate(self, messages, temperature: float = 0.7,
                 top_p: float = 0.9, do_sample: bool = True,
                 max_new_tokens: int = 512,
                 auto_chunk_long_audio: bool = False,
                 speculative_k: int = 0) -> GenerationOutput:
        """Reference-compatible inference entry point
        (modeling_desta25.py:1491-1721).

        auto_chunk_long_audio: split clips longer than Whisper's 30 s
        window into overlapping windows spliced as consecutive audio
        blocks (extension; the reference truncates at 30 s — SURVEY §5).
        Only audios without a user transcription are chunked.

        speculative_k: >= 2 enables n-gram speculative decoding
        (generate/speculative.py): k-token drafts verified in one T=k
        cached forward per step.  Works for greedy AND sampled decoding
        (token-matching coupling — the emitted distribution is identical
        to plain sampling) and with ORCA deep injection.  A model with
        LoRA adapters decodes with the plain loop (merge them first,
        ``merge_lora_for_serving``).
        """
        if isinstance(messages, list):
            messages_list = ([messages] if isinstance(messages[0], dict)
                             else messages)
        else:
            raise ValueError(
                "messages should be a list of dicts or a list of lists.")
        cleanup_paths: List[str] = []
        if auto_chunk_long_audio:
            messages_list = self._chunk_long_audios(messages_list,
                                                    cleanup_paths)
        try:
            return self._generate_impl(messages_list, temperature, top_p,
                                       do_sample, max_new_tokens,
                                       speculative_k)
        finally:
            for p in cleanup_paths:
                try:
                    os.unlink(p)
                except OSError:
                    pass

    def _chunk_long_audios(self, messages_list, cleanup_paths):
        """Split >30 s clips into window chunks, duplicating locators."""
        import tempfile

        from ..audio.chunking import WINDOW, chunk_audio
        from ..audio.io import write_wav
        out_list = []
        for msgs in messages_list:
            new_msgs = []
            for message in msgs:
                audios = message.get("audios", [])
                if not audios:
                    new_msgs.append(message)
                    continue
                new_audios = []
                n_chunks = []
                for audio in audios:
                    if audio.get("text") is not None:
                        new_audios.append(audio)
                        n_chunks.append(1)
                        continue
                    seg = AudioSegment.from_file(
                        audio["audio"], target_sr=16000,
                        channel_selector="average")
                    if seg.num_samples <= WINDOW:
                        new_audios.append(audio)
                        n_chunks.append(1)
                        continue
                    chunks = chunk_audio(seg.samples)
                    for c in chunks:
                        f = tempfile.NamedTemporaryFile(
                            suffix=".wav", delete=False)
                        write_wav(f.name, c)
                        cleanup_paths.append(f.name)
                        new_audios.append({"audio": f.name, "text": None})
                    n_chunks.append(len(chunks))
                from ..audio.chunking import expand_message_for_chunks
                content = expand_message_for_chunks(
                    message["content"], self.audio_locator, n_chunks)
                new_msgs.append({**message, "content": content,
                                 "audios": new_audios})
            out_list.append(new_msgs)
        return out_list

    def _prepare_generation_inputs(self, messages_list):
        """Host phases A+B + device perception/splice for a batch of
        conversations — the serving engine's entry point.

        Returns (inputs_embeds, attention_mask, inject_tokens,
        prompt_ids) where inject_tokens are the ORCA deep-injection audio
        tokens (None unless the model is an ORCA checkpoint with deep
        injection and the batch carries audio) and prompt_ids [B, T]
        (host np.int32) are the context token ids with each audio's
        TRANSCRIPTION ids substituted at its splice positions — the
        n-gram history that lets speculative decoding win on
        transcription echo (VERDICT r2 #2; audio-feature positions keep
        the placeholder id, which never matches generated text).
        Text-only batches take the plain chat-template embedding path
        (modeling_desta25.py:1686-1703)."""
        prep = self._run_generation_phases(messages_list,
                                           return_prompt_ids=True)
        if prep is None:
            tk = self.tokenizer
            texts = tk.apply_chat_template(messages_list, tokenize=False,
                                           add_generation_prompt=True)
            if isinstance(texts, str):
                texts = [texts]
            enc = tk(texts, padding="longest", add_special_tokens=False)
            ids_np = np.asarray(enc["input_ids"], np.int32)
            input_ids = jnp.asarray(ids_np)
            attn_mask = jnp.asarray(
                np.asarray(enc["attention_mask"], np.int32))
            embeds = jllm.embed_tokens(self.params["llm"], input_ids)
            return embeds, attn_mask, None, ids_np
        embeds, attn_mask, aux, _audios, _trans, prompt_ids = prep
        return (embeds, jnp.asarray(attn_mask),
                self._orca_inject_tokens(aux), prompt_ids)

    def _orca_inject_tokens(self, aux):
        """Deep-injection kv tokens from perception aux, or None when the
        config/checkpoint doesn't deep-inject (modeling_desta25.py:736-754:
        injection needs ORCA mode + local branch + wrapped layers)."""
        if not (self.config.is_orca
                and self.config.orca_deep_injection_enabled
                and "orca_cross_attns" in self.params
                and aux is not None and aux[1] is not None):
            return None
        audio_feats, local_tokens = aux
        if self.config.orca_global_cross_attn:
            return jnp.concatenate([audio_feats, local_tokens], axis=1)
        return local_tokens

    def _run_generation_phases(self, messages_list,
                               return_prompt_ids: bool = False):
        tk = self.tokenizer
        all_audios: List[str] = []
        all_transcriptions: List[Optional[str]] = []
        for msgs in messages_list:
            for message in msgs:
                content = message["content"]
                audios = message.get("audios", [])
                assert len(audios) == content.count(self.audio_locator), \
                    "audio count does not match (<|AUDIO|>) count"
                for audio in audios:
                    all_audios.append(audio["audio"])
                    all_transcriptions.append(audio.get("text"))

        if not all_audios:
            return None  # caller takes the text-only path

        # --- phase A: audio decode + VAD + ASR --------------------------
        # (with the audio-feature cache enabled, hits skip all of it:
        # file decode, VAD, ASR — models/feature_cache.py)
        N = len(all_audios)
        cache = self.audio_cache
        keys: List[Any] = [None] * N
        centries: List[Optional[Dict[str, Any]]] = [None] * N
        samples: List[Optional[np.ndarray]] = [None] * N
        speech_flags = [True] * N

        def _load(i):
            if samples[i] is None:
                seg = AudioSegment.from_file(all_audios[i],
                                             target_sr=16000,
                                             channel_selector="average")
                samples[i] = seg.samples
            return samples[i]

        asr_indices = []
        for i, (path, trans) in enumerate(zip(all_audios,
                                              all_transcriptions)):
            if not os.path.exists(path):
                raise ValueError(f"Audio file {path} does not exist.")
            if cache is not None:
                keys[i] = cache.key(path)
                centries[i] = cache.get(keys[i])
            if centries[i] is not None:
                speech = centries[i]["speech"]
            else:
                speech = has_speech(_load(i))
            speech_flags[i] = speech
            if not speech:
                all_transcriptions[i] = " "
            elif trans is None:
                hit_text = (centries[i] or {}).get("asr_text")
                if hit_text is not None:
                    all_transcriptions[i] = hit_text
                else:
                    # ASR runs even on a feature-cache hit when the entry
                    # has no transcription yet (lazy fill)
                    asr_indices.append(i)
        max_len = self.enc_cfg.expected_mel_frames * 160
        asr_set = set(asr_indices)

        def _batch(idxs, pad_to=None):
            ab = np.zeros((pad_to or len(idxs), max_len), np.float32)
            for j, i in enumerate(idxs):
                s = _load(i)
                ab[j, :min(len(s), max_len)] = s[:max_len]
            return ab

        if asr_indices:
            texts = self._asr(_batch(asr_indices))
            for i, text in zip(asr_indices, texts):
                all_transcriptions[i] = text.strip()
                if centries[i] is not None:
                    centries[i]["asr_text"] = text.strip()

        # --- phase B: tokenize + expand + splice maps -------------------
        K = self.config.audio_token_size
        audio_size_list = [K] * len(all_audios)
        transcription_size_list = [
            len(tk.tokenize(t, add_special_tokens=False))
            for t in all_transcriptions
        ]

        context_list: List[str] = []
        start_positions_list: List[List[int]] = []
        consumed = 0
        per_row_counts = []
        for msgs in messages_list:
            ctx = tk.apply_chat_template(msgs, tokenize=False,
                                         add_generation_prompt=True)
            ctx = ctx.replace(
                self.audio_locator,
                f"<start_audio>{self.audio_locator}<end_audio>")
            n_here = ctx.count(self.audio_locator)
            toks, starts = expand_audio_placeholders(
                tk.tokenize(ctx), self.audio_locator,
                audio_size_list[consumed:consumed + n_here],
                transcription_size_list[consumed:consumed + n_here],
                self.placeholder_token)
            consumed += n_here
            per_row_counts.append(n_here)
            context_list.append(tk.convert_tokens_to_string(toks))
            start_positions_list.append(starts)

        enc = tk(context_list, padding="longest", truncation=True,
                 add_special_tokens=False)
        input_ids = np.asarray(enc["input_ids"], np.int32)
        attn_mask = np.asarray(enc["attention_mask"], np.int32)
        B, T = input_ids.shape

        entries = []
        audio_idx = 0
        for b in range(B):
            pad_len = int(T - attn_mask[b].sum())
            for s in start_positions_list[b]:
                entries.append(SpliceEntry(
                    batch_idx=b, start=s + pad_len, audio_idx=audio_idx,
                    audio_size=K,
                    trans_len=transcription_size_list[audio_idx]))
                audio_idx += 1
        kind, aidx, pos = build_splice_maps(B, T, entries)

        trans_max = max(1, _round_up(max(transcription_size_list + [1]), 8))
        trans_ids = np.zeros((len(all_audios), trans_max), np.int32)
        for i, t in enumerate(all_transcriptions):
            ids = tk.encode(t, add_special_tokens=False)[:trans_max]
            trans_ids[i, :len(ids)] = ids

        # --- phase C: device program ------------------------------------
        if cache is None:
            # legacy fused path: ONE perception+splice program
            mel = self._mel(_batch(list(range(N))))
            embeds, aux = self._prepare_jit(
                self.params, jnp.asarray(input_ids), mel,
                jnp.asarray(trans_ids), jnp.asarray(kind),
                jnp.asarray(aidx), jnp.asarray(pos))
        else:
            # cached path: perception over cache MISSES only (padded to a
            # power of two so it compiles for a handful of shapes), then
            # a splice-only program over the assembled per-clip features
            miss = [i for i in range(N) if centries[i] is None]
            if miss:
                P = 1 << (len(miss) - 1).bit_length()
                mel = self._mel(_batch(miss, pad_to=P))
                feats_m, local_m = self._perception_jit(self.params, mel)
                for j, i in enumerate(miss):
                    entry = {"speech": speech_flags[i],
                             "asr_text": (all_transcriptions[i]
                                          if i in asr_set else None),
                             "feats": feats_m[j],
                             "local": (None if local_m is None
                                       else local_m[j])}
                    cache.put(keys[i], entry)
                    centries[i] = entry
            audio_feats = jnp.stack([e["feats"] for e in centries])
            local_tokens = None
            if centries[0]["local"] is not None:
                local_tokens = jnp.stack([e["local"] for e in centries])
            aux = (audio_feats, local_tokens)
            embeds = self._splice_jit(
                self.params, jnp.asarray(input_ids), audio_feats,
                jnp.asarray(trans_ids), jnp.asarray(kind),
                jnp.asarray(aidx), jnp.asarray(pos))
        if return_prompt_ids:
            # transcription token ids substituted at their splice
            # positions (kind==2) — the text the model is most likely to
            # echo, and exactly what n-gram drafting feeds on
            # pos at non-transcription positions (e.g. kind==1 audio
            # slots) ranges over audio_token_size, past trans_max —
            # clamp before the gather (np.where evaluates both arms)
            pos_c = np.minimum(pos, trans_ids.shape[1] - 1)
            prompt_ids = np.where(kind == 2, trans_ids[aidx, pos_c],
                                  input_ids).astype(np.int32)
            return (embeds, attn_mask, aux, all_audios,
                    all_transcriptions, prompt_ids)
        return embeds, attn_mask, aux, all_audios, all_transcriptions

    def _generate_impl(self, messages_list, temperature, top_p, do_sample,
                       max_new_tokens,
                       speculative_k: int = 0) -> GenerationOutput:
        tk = self.tokenizer
        prep = self._run_generation_phases(messages_list,
                                           return_prompt_ids=True)
        if prep is None:
            return self._generate_text_only(
                messages_list, temperature, top_p, do_sample,
                max_new_tokens, speculative_k)
        (embeds, attn_mask, aux, all_audios, all_transcriptions,
         prompt_ids) = prep
        self._gen_key, key = jax.random.split(self._gen_key)
        inject_kwargs = {}
        inject_tokens = self._orca_inject_tokens(aux)
        if inject_tokens is not None:
            inject_kwargs = dict(
                inject_params=self.params["orca_cross_attns"],
                inject_tokens=inject_tokens,
                inject_scale=self.config.orca_audio_position_scale,
                inject_heads=self.llm_cfg.num_attention_heads)
        if speculative_k >= 2 and self.params.get("lora") is None:
            from ..generate.speculative import llm_generate_spec
            # left-padded rows -> left-aligned history; transcription ids
            # are already substituted at splice positions (prompt-lookup
            # wins exactly on transcription echo — VERDICT r2 #2)
            am = jnp.asarray(attn_mask)
            lens = jnp.sum(am, axis=1).astype(jnp.int32)
            Tp = prompt_ids.shape[1]
            aligned = jax.vmap(lambda r, n: jnp.roll(r, n - Tp))(
                jnp.asarray(prompt_ids), lens)
            tokens, n_gen = llm_generate_spec(
                self.params["llm"], self.llm_cfg, embeds, am, key,
                max_new_tokens=max_new_tokens,
                eos_ids=self._terminators(), pad_id=tk.pad_token_id,
                speculative_k=speculative_k,
                temperature=temperature, top_p=top_p,
                do_sample=do_sample,
                prompt_ids=aligned, prompt_lens=lens, **inject_kwargs)
        else:
            tokens, n_gen = llm_generate(
                self.params["llm"], self.llm_cfg, embeds,
                jnp.asarray(attn_mask), key,
                max_new_tokens=max_new_tokens, temperature=temperature,
                top_p=top_p, do_sample=do_sample,
                eos_ids=self._terminators(), pad_id=tk.pad_token_id,
                lora=self.params.get("lora"),
                lora_scale=self.config.lora_scale, **inject_kwargs)
        tokens = np.asarray(tokens)
        texts = tk.batch_decode(tokens, skip_special_tokens=True)
        return GenerationOutput(
            text=texts,
            audios=[(a, t) for a, t in zip(all_audios, all_transcriptions)],
            generated_ids=tokens.tolist(),
        )

    def _terminators(self) -> Tuple[int, ...]:
        tk = self.tokenizer
        terms = {tk.eos_token_id}
        for tok in ("<|eot_id|>", "<|im_end|>", "<|end_of_text|>",
                    "<|endoftext|>"):
            try:
                tid = tk.convert_tokens_to_ids(tok)
            except Exception:
                continue
            if tid is not None and tid >= 0:
                terms.add(int(tid))
        return tuple(sorted(terms))

    def _generate_text_only(self, messages_list, temperature, top_p,
                            do_sample, max_new_tokens,
                            speculative_k: int = 0) -> GenerationOutput:
        """Plain LLM chat path (modeling_desta25.py:1686-1721)."""
        tk = self.tokenizer
        texts = tk.apply_chat_template(messages_list, tokenize=False,
                                       add_generation_prompt=True)
        if isinstance(texts, str):
            texts = [texts]
        enc = tk(texts, padding="longest", add_special_tokens=False)
        input_ids = jnp.asarray(np.asarray(enc["input_ids"], np.int32))
        attn_mask = jnp.asarray(np.asarray(enc["attention_mask"], np.int32))
        embeds = jllm.embed_tokens(self.params["llm"], input_ids)
        self._gen_key, key = jax.random.split(self._gen_key)
        if speculative_k >= 2 and self.params.get("lora") is None:
            from ..generate.speculative import llm_generate_spec
            # left-padded rows -> left-aligned history for n-gram lookup
            lens = jnp.sum(attn_mask, axis=1).astype(jnp.int32)
            Tp = input_ids.shape[1]
            aligned = jax.vmap(lambda r, n: jnp.roll(r, n - Tp))(
                input_ids, lens)
            tokens, _ = llm_generate_spec(
                self.params["llm"], self.llm_cfg, embeds, attn_mask, key,
                max_new_tokens=max_new_tokens,
                eos_ids=self._terminators(), pad_id=tk.pad_token_id,
                speculative_k=speculative_k,
                temperature=temperature, top_p=top_p,
                do_sample=do_sample,
                prompt_ids=aligned, prompt_lens=lens)
        else:
            tokens, _ = llm_generate(
                self.params["llm"], self.llm_cfg, embeds, attn_mask, key,
                max_new_tokens=max_new_tokens, temperature=temperature,
                top_p=top_p, do_sample=do_sample,
                eos_ids=self._terminators(),
                pad_id=tk.pad_token_id, lora=self.params.get("lora"),
                lora_scale=self.config.lora_scale)
        tokens = np.asarray(tokens)
        return GenerationOutput(
            text=tk.batch_decode(tokens, skip_special_tokens=True),
            audios=[],
            generated_ids=tokens.tolist(),
        )

    # -- persistence ------------------------------------------------------

    def save_pretrained(self, path: str):
        from ..ckpt.desta_io import save_trainable_safetensors
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            f.write(self.config.to_json())
        trainable, _ = self.split_params()
        save_trainable_safetensors(
            trainable, self.config, os.path.join(path, "model.safetensors"))

    @classmethod
    def from_pretrained(cls, path: str, weights_root: Optional[str] = None,
                        seed: int = 0,
                        config_overrides: Optional[Dict[str, Any]] = None,
                        **kwargs) -> "DeSTA25AudioModel":
        """Load config + trainable weights from ``path``; frozen Whisper/LLM
        weights come from converted HF checkpoints under ``weights_root``
        (or env DESTA_WEIGHTS), falling back to random init with a
        warning (hub access is not assumed).

        ``config_overrides`` replaces DeSTA25Config fields after the
        checkpoint's config.json loads — e.g. ``{"encoder_quant": "none"}``
        for the runbook's int8-vs-bf16 MMAU gate (docs/real_weights.md §6b)
        without editing the checkpoint."""
        from ..ckpt.desta_io import load_frozen_tower, load_trainable_safetensors
        with open(os.path.join(path, "config.json")) as f:
            config = DeSTA25Config.from_json(f.read())
        if config_overrides:
            config = dataclasses.replace(config, **config_overrides)
        model = cls(config, seed=seed, **kwargs)
        weights_root = weights_root or os.environ.get("DESTA_WEIGHTS")
        if weights_root:
            for tower, model_id in (("whisper", config.encoder_model_id),
                                    ("llm", config.llm_model_id)):
                loaded = load_frozen_tower(
                    tower, model_id, weights_root, config, model.dtype,
                    quant=(config.llm_quant if tower == "llm"
                           else config.resolved_encoder_quant(
                               inference=True)))
                if loaded is not None:
                    model.params[tower] = loaded
                else:
                    logger.warning("no local weights for %s (%s); keeping "
                                   "random init", tower, model_id)
        st = os.path.join(path, "model.safetensors")
        if os.path.exists(st):
            try:
                model.params = load_trainable_safetensors(
                    model.params, config, st)
            except ValueError as e:
                if "tapped layers" not in str(e):
                    raise
                # Shape-driven reconfiguration (reference load_state_dict,
                # modeling_desta25.py:1312-1354): the checkpoint's tap count
                # decides between selected-layer and all-layer taps.
                from safetensors.numpy import load_file
                sd = load_file(st)
                n_taps_ckpt = int(
                    sd["perception.connector.global_layer_weights"].shape[1])
                all_layers = (n_taps_ckpt
                              == config.encoder_config.encoder_layers)
                logger.warning(
                    "checkpoint has %d tapped layers; reconfiguring "
                    "connector with orca_use_all_layers=%s", n_taps_ckpt,
                    all_layers)
                config = dataclasses.replace(
                    config, orca_use_all_layers=all_layers)
                model = cls(config, seed=seed, **kwargs)
                if weights_root:
                    for tower, model_id in (
                            ("whisper", config.encoder_model_id),
                            ("llm", config.llm_model_id)):
                        loaded = load_frozen_tower(
                            tower, model_id, weights_root, config,
                            model.dtype,
                            quant=(config.llm_quant if tower == "llm"
                                   else config.resolved_encoder_quant(
                                       inference=True)))
                        if loaded is not None:
                            model.params[tower] = loaded
                model.params = load_trainable_safetensors(
                    model.params, config, st)
        model._apply_orca_xattn_quant()
        model._apply_inference_encoder_quant()
        return model

    def _apply_inference_encoder_quant(self) -> None:
        """encoder_quant="auto" resolves to int8 on the inference path:
        quantize the (frozen, never-trained) encoder unless the loader
        already delivered int8 leaves."""
        if self.config.resolved_encoder_quant(inference=True) != "int8":
            return
        enc = self.params["whisper"]["encoder"]
        if "q" in enc["layers"]["fc1"]:  # loader already quantized
            return
        from ..ops.quant import quantize_encoder_params
        self.params["whisper"]["encoder"] = jax.jit(
            quantize_encoder_params)(enc)

    def _apply_orca_xattn_quant(self) -> None:
        """config.orca_xattn_quant="int8": quantize the gated
        cross-attention stack for serving (applied AFTER checkpoint
        weights load — the trainable loader needs the float "w" leaves).
        It halves the injection weights each decode step reads."""
        if (self.config.orca_xattn_quant == "int8"
                and "orca_cross_attns" in self.params):
            from ..ops.quant import is_quantized, quantize_orca_cross_attns
            if not is_quantized(
                    self.params["orca_cross_attns"]["layers"]["q"]):
                self.params["orca_cross_attns"] = jax.jit(
                    quantize_orca_cross_attns)(
                        self.params["orca_cross_attns"])
