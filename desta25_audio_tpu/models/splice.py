"""Audio-token splice: placeholder expansion + embedding-stream scatter.

The reference overwrites slices of ``inputs_embeds`` per audio in a Python
loop (modeling_desta25.py:1014-1045).  That is ragged and host-driven; this
equivalent precomputes three dense index maps on the host during
collation/generation and performs the splice on device as two batched
gathers + selects — fully static shapes, jit-friendly, no per-audio loop.

Host: :func:`expand_audio_placeholders` (token-level expansion identical to
``_prepare_audio_context_and_start_positions``, modeling_desta25.py:99-123)
and :func:`build_splice_maps`.
Device: :func:`apply_splice`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import jax.numpy as jnp
import numpy as np


def expand_audio_placeholders(
    token_list: Sequence[str],
    audio_locator: str,
    audio_size_list: Sequence[int],
    transcription_size_list: Sequence[int],
    placeholder_token: str,
) -> Tuple[List[str], List[int]]:
    """Expand each locator token into audio_size + transcription_size
    placeholder copies; record the start position of each block."""
    assert len(audio_size_list) == len(transcription_size_list), (
        audio_size_list, transcription_size_list)
    audio_size_list = list(audio_size_list)
    transcription_size_list = list(transcription_size_list)
    result: List[str] = []
    start_positions: List[int] = []
    for tok in token_list:
        if tok == audio_locator:
            trans_size = transcription_size_list.pop(0)
            audio_size = audio_size_list.pop(0)
            start_positions.append(len(result))
            result.extend([placeholder_token] * (audio_size + trans_size))
        else:
            result.append(tok)
    return result, start_positions


def expand_audio_blocks(
    text: str,
    audio_size_list: Sequence[int],
    transcription_size_list: Sequence[int],
    placeholder_token: str,
    tokenizer,
    start_tag: str = "<start_audio>",
    end_tag: str = "<end_audio>",
) -> Tuple[str, List[int]]:
    """Block-marker variant of the placeholder expansion: replace every
    ``<start_audio>...<end_audio>`` span (content discarded) with
    audio_size + transcription_size placeholder tokens, recording start
    positions (reference ``_prepare_audio_context_with_start_end_tags``,
    simple_dataset.py:41-100)."""
    import re
    pattern = re.escape(start_tag) + r".*?" + re.escape(end_tag)
    matches = list(re.finditer(pattern, text, re.DOTALL))

    result: List[str] = []
    start_positions: List[int] = []
    last_end = 0
    for i, m in enumerate(matches):
        prefix = text[last_end:m.start()]
        if prefix:
            result.extend(tokenizer.tokenize(prefix,
                                             add_special_tokens=False))
        start_positions.append(len(result))
        if i < len(audio_size_list) and i < len(transcription_size_list):
            total = audio_size_list[i] + transcription_size_list[i]
            result.extend([placeholder_token] * total)
        last_end = m.end()
    suffix = text[last_end:]
    if suffix:
        result.extend(tokenizer.tokenize(suffix, add_special_tokens=False))
    return tokenizer.convert_tokens_to_string(result), start_positions


@dataclass
class SpliceEntry:
    """One audio occurrence: row ``batch_idx`` at token offset ``start``
    (already left-pad adjusted), ``audio_idx`` into the flat audio batch,
    ``audio_size`` spliced audio tokens followed by ``trans_len``
    transcription-embedding tokens."""

    batch_idx: int
    start: int
    audio_idx: int
    audio_size: int
    trans_len: int


def build_splice_maps(batch: int, seq_len: int,
                      entries: Sequence[SpliceEntry]):
    """Build (kind, audio_idx, pos) uint/int32 maps of shape [B, T].

    kind: 0=text, 1=audio token, 2=transcription embedding.
    pos: index into the audio-token axis (kind 1) or transcription axis
    (kind 2).
    """
    kind = np.zeros((batch, seq_len), np.int32)
    aidx = np.zeros((batch, seq_len), np.int32)
    pos = np.zeros((batch, seq_len), np.int32)
    for e in entries:
        a_end = min(e.start + e.audio_size, seq_len)
        t_end = min(e.start + e.audio_size + e.trans_len, seq_len)
        if e.start >= seq_len:
            continue
        sl = slice(e.start, a_end)
        kind[e.batch_idx, sl] = 1
        aidx[e.batch_idx, sl] = e.audio_idx
        pos[e.batch_idx, sl] = np.arange(a_end - e.start)
        if a_end < t_end:
            sl = slice(a_end, t_end)
            kind[e.batch_idx, sl] = 2
            aidx[e.batch_idx, sl] = e.audio_idx
            pos[e.batch_idx, sl] = np.arange(t_end - a_end)
    return kind, aidx, pos


def apply_splice(text_embeds: jnp.ndarray, audio_feats: jnp.ndarray,
                 trans_embeds: jnp.ndarray, kind: jnp.ndarray,
                 aidx: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """Device-side splice.

    text_embeds: [B, T, D]; audio_feats: [N, K, D];
    trans_embeds: [N, T_tr, D] (padded); kind/aidx/pos: [B, T] int32.
    """
    ga = audio_feats[aidx, jnp.minimum(pos, audio_feats.shape[1] - 1)]
    gt = trans_embeds[aidx, jnp.minimum(pos, trans_embeds.shape[1] - 1)]
    ga = ga.astype(text_embeds.dtype)
    gt = gt.astype(text_embeds.dtype)
    k = kind[..., None]
    return jnp.where(k == 1, ga, jnp.where(k == 2, gt, text_embeds))
