#!/usr/bin/env python3
"""Smoke run of DeSTA2.5-Audio on NVIDIA GPUs, through the entry points a
user calls, at the published widths with random weights from a seed.

    python3 chip_smoke.py               # one card: every phase below
    python3 chip_smoke.py --four-cards  # four cards: dp x tp train step
                                        # and TP=4 decode, each against
                                        # the same work on one card

One card:
  1. op parity at real widths against float32 references computed under
     ``jax.default_matmul_precision("highest")``: attention through
     ``ops.attention.mha``, the int8 decode matmul and the W8A8
     projection, the log-mel frontend on a 30 s clip;
  2. ``DeSTA25AudioModel.generate`` on the reference flagship
     (whisper-large-v3 + 6-layer Q-Former + Llama-3.1-8B, bf16, depth
     cut to ``LLM_LAYERS`` / ``ENCODER_LAYERS``), each greedy token
     checked against an uncached forward;
  3. ``ContinuousBatchingEngine`` answering 4 requests on 8 slots: the bf16
     tower, then the int8 tower with and without ``speculative_k=4``
     (identical greedy tokens required);
  4. the Qwen3-4B ORCA-hybrid flagship answering 2 requests through the
     engine (deep injection through ``extra_layer_fn``);
  5. three connector train steps at the flagship geometry (batch 12,
     sequence 300); the loss must stay finite.

The script needs one process and opens the card once.  It exits non-zero
without a result when JAX finds no GPU, and non-zero when any phase fails.
Its last stdout line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from desta25_audio_tpu.utils.compilation_cache import (  # noqa: E402
    setup_compilation_cache,
)


# ---------------------------------------------------------------------------
# Sizes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Sizes:
    """What the smoke runs.  ``config(mode)`` builds the DeSTA25Config of
    a connector mode ("qformer_1" or "orca_hybrid")."""
    config: Callable[[str], object]
    # attention parity: (name, B, Tq, Tk, H, Hkv, Dh, causal, padded)
    attn: Tuple[Tuple, ...]
    qmm_k: int = 4096
    qmm_n: int = 4096
    qmm_decode_rows: int = 8
    qmm_prefill_rows: int = 1536
    n_requests: int = 4
    n_slots: int = 8
    max_new: int = 12
    max_ctx: int = 256
    ctx_bucket: int = 64
    spec_k: int = 4
    train_batch: int = 12
    train_seq: int = 300
    train_steps: int = 3
    tp_prompt: int = 64
    tp_new: int = 16


# Depth cut at the published widths: XLA's compile time grows with the
# number of layers, and every phase must compile and run inside the
# smoke's time limit.  Widths, heads, vocabularies, the 1500-frame
# encoder context and the four connector taps stay as published.
LLM_LAYERS = 4
ENCODER_LAYERS = 8


def _flagship_config(mode: str, llm_layers: int = LLM_LAYERS,
                     encoder_layers: int = ENCODER_LAYERS):
    from desta25_audio_tpu.train.bench_utils import flagship_config
    return flagship_config(mode, llm_num_hidden_layers=llm_layers,
                           encoder_num_layers=encoder_layers)


FULL = Sizes(
    config=_flagship_config,
    attn=(
        # whisper-large-v3 encoder self-attention
        ("encoder-b1", 1, 1500, 1500, 20, 20, 64, False, False),
        ("encoder-b8", 8, 1500, 1500, 20, 20, 64, False, False),
        # Q-Former cross-attention: 64 queries over 1500 frames, B=8 x
        # 4 taps
        ("qformer-cross", 32, 64, 1500, 20, 20, 64, False, False),
        # Llama-3.1-8B prefill: causal, GQA 32/8, left-padded
        ("llm-prefill", 4, 512, 512, 32, 8, 128, True, True),
    ),
)
# The four-card phases compile each program twice (one card, then the
# mesh) and run on four cards at once: half the depth again.
FULL_FOUR_CARDS = dataclasses.replace(
    FULL, config=functools.partial(_flagship_config, llm_layers=2,
                                   encoder_layers=4))

# Tolerances, each against a float32 reference at highest precision:
# bf16 attention on unit-scale inputs keeps ~3 significant digits after
# the f32 softmax; int8 products carry the weight quantization (shared
# by the reference) plus bf16 operand rounding, and W8A8 adds the
# activation quantization (1/254 of each row's range per element).
TOL_ATTN = 2e-2
TOL_INT8 = 1e-2
TOL_W8A8 = 2e-2
TOL_MEL = 1e-3
# A greedy token counts as the reference's choice when its logit is
# within this fraction of the largest logit of the reference's argmax
# (bf16 activations through the full tower reorder sums between paths).
TIE_FRAC = 1e-2


# ---------------------------------------------------------------------------
# Bookkeeping
# ---------------------------------------------------------------------------


class CompileStats:
    """Backend compile seconds and persistent-cache hits/misses, from
    JAX's monitoring events."""

    def __init__(self):
        self.secs = 0.0
        self.hits = 0
        self.misses = 0
        jax.monitoring.register_event_duration_secs_listener(self._dur)
        jax.monitoring.register_event_listener(self._event)

    def _dur(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.secs += duration

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1

    def snapshot(self):
        return self.secs, self.hits, self.misses


def check(label: str, err: float, tol: float) -> bool:
    ok = bool(np.isfinite(err)) and err <= tol
    print(f"  {label}: err={err:.3e} tol={tol:.0e} {'ok' if ok else 'FAIL'}")
    return ok


def rel_err(got, ref) -> float:
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def run_phases(phases: Sequence[Tuple[str, Callable[[], bool]]],
               stats: CompileStats) -> bool:
    ok_all = True
    for name, fn in phases:
        print(f"phase {name}", flush=True)
        t0 = time.perf_counter()
        c0 = stats.snapshot()
        try:
            ok = bool(fn())
        except Exception:  # noqa: BLE001 - reported, fails the run
            traceback.print_exc()
            ok = False
        gc.collect()
        c1 = stats.snapshot()
        print(f"  phase {name}: {'ok' if ok else 'FAIL'} "
              f"wall={time.perf_counter() - t0:.1f}s "
              f"compile={c1[0] - c0[0]:.1f}s "
              f"cache_hits={c1[1] - c0[1]} cache_misses={c1[2] - c0[2]}",
              flush=True)
        ok_all &= ok
    return ok_all


# ---------------------------------------------------------------------------
# Phase 1: op parity
# ---------------------------------------------------------------------------


def phase_ops(sz: Sizes) -> bool:
    import jax.numpy as jnp

    from desta25_audio_tpu.audio.mel import log_mel, log_mel_np_precise
    from desta25_audio_tpu.ops import attention
    from desta25_audio_tpu.ops.core import mha as ref_mha
    from desta25_audio_tpu.ops.quant import (
        dequantize_weight,
        quant_matmul,
        quantize_weight,
    )

    ok = True
    key = jax.random.PRNGKey(0)
    for name, B, Tq, Tk, H, Hkv, D, causal, padded in sz.attn:
        kq, kk, kv, key = jax.random.split(key, 4)
        q = jax.random.normal(kq, (B, Tq, H, D), jnp.bfloat16)
        k = jax.random.normal(kk, (B, Tk, Hkv, D), jnp.bfloat16)
        v = jax.random.normal(kv, (B, Tk, Hkv, D), jnp.bfloat16)
        kv_mask = None
        mask = jnp.ones((B, 1, Tq, Tk), bool)
        if padded:
            lens = Tk - (jnp.arange(B) * Tk) // (2 * B)
            kv_mask = (jnp.arange(Tk)[None, :]
                       >= (Tk - lens)[:, None]).astype(jnp.int32)
            mask = mask & (kv_mask[:, None, None, :] > 0)
        if causal:
            mask = mask & jnp.tril(jnp.ones((Tq, Tk), bool))[None, None]
        impl = attention.implementation(jax.default_backend(), q.dtype, D,
                                        Tq, Tk, padded)
        got = jax.jit(lambda q, k, v, m: attention.mha(
            q, k, v, kv_mask=m, causal=causal))(q, k, v, kv_mask)
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(lambda q, k, v: ref_mha(
                q.astype(jnp.float32), k.astype(jnp.float32),
                v.astype(jnp.float32), mask=mask))(q, k, v)
        valid = np.asarray(mask.any(-1)[:, 0])          # [B, Tq]
        err = float(np.abs(np.asarray(got, np.float32)[valid]
                           - np.asarray(ref)[valid]).max())
        ok &= check(f"attention {name} [{impl}] max_abs", err, TOL_ATTN)
        del got, ref

    K, N = sz.qmm_k, sz.qmm_n
    kw, kx, kp = jax.random.split(key, 3)
    leaf = quantize_weight(jax.random.normal(kw, (K, N)) * 0.02)
    w32 = dequantize_weight(leaf, jnp.float32)
    for label, M, w8a8, tol in (
            ("int8 decode matmul", sz.qmm_decode_rows, True, TOL_INT8),
            ("w8a8 projection", sz.qmm_prefill_rows, True, TOL_W8A8)):
        x = jax.random.normal(kx, (M, K), jnp.bfloat16)
        got = jax.jit(lambda x, l: quant_matmul(
            x, l, out_dtype=jnp.float32, w8a8=w8a8))(x, leaf)
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(lambda x, w: x.astype(jnp.float32) @ w)(x, w32)
        ok &= check(f"{label} M={M} K={K} N={N} max_rel",
                    rel_err(got, ref), tol)

    n = 30 * 16000
    t = np.arange(n) / 16000.0
    rng = np.random.default_rng(0)
    clip = (0.4 * np.sin(2 * np.pi * (200 + 300 * t / 30) * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)[None]
    got = jax.jit(lambda a: log_mel(a, 128, layout="bmt"))(jnp.asarray(clip))
    ref = log_mel_np_precise(clip, 128)
    ok &= check("log_mel 30 s x 128 mels max_abs",
                float(np.abs(np.asarray(got) - ref).max()), TOL_MEL)
    return ok


# ---------------------------------------------------------------------------
# Shared model helpers
# ---------------------------------------------------------------------------


def write_clips(d: str, n: int) -> List[str]:
    """n synthetic 30 s clips: a voiced harmonic tone with syllable-rate
    amplitude modulation and noise, a different pitch per clip."""
    from desta25_audio_tpu.audio.io import write_wav
    t = np.arange(30 * 16000) / 16000.0
    rng = np.random.default_rng(1)
    paths = []
    for i in range(n):
        f0 = 120.0 + 25.0 * i
        sig = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in (1, 2, 3))
        sig = sig * (0.5 + 0.5 * np.sin(2 * np.pi * 4.0 * t)) * 0.3
        sig = sig + 0.01 * rng.standard_normal(t.shape)
        p = os.path.join(d, f"clip{i}.wav")
        write_wav(p, sig.astype(np.float32))
        paths.append(p)
    return paths


def conversations(paths: Sequence[str]) -> List[list]:
    return [[{"role": "user",
              "content": f"Clip {i}: what do you hear? <|AUDIO|>",
              "audios": [{"audio": p,
                          "text": f"a voiced tone, clip number {i}"}]}]
            for i, p in enumerate(paths)]


def build_model(cfg, seed: int = 0):
    """The model at ``cfg``'s widths with random weights from ``seed``
    and the repo's CharTokenizer (no checkpoint or tokenizer files)."""

    from desta25_audio_tpu import DeSTA25AudioModel
    from desta25_audio_tpu.data.tokenizer import CharTokenizer
    from desta25_audio_tpu.utils.fast_init import random_tree_like
    t0 = time.perf_counter()
    tok = CharTokenizer(chat_template=cfg.llm_config.chat_template)
    model = DeSTA25AudioModel(cfg, params={}, tokenizer=tok)
    model.params = jax.block_until_ready(random_tree_like(
        jax.random.PRNGKey(seed), model._init_params))
    print(f"    {cfg.llm_model_id} ({cfg.llm_config.num_hidden_layers} "
          f"layers) + {cfg.encoder_model_id} "
          f"({cfg.encoder_config.encoder_layers} layers): random weights "
          f"in {time.perf_counter() - t0:.1f}s")
    return model


def _inject_fn(cfg, inject):
    """extra_layer_fn of the ORCA deep injection from (xattn stack,
    per-layer audio K, V), or None."""
    if inject is None:
        return None

    from desta25_audio_tpu.models.orca import gated_cross_attention_apply
    xattn, inj_k, inj_v = inject

    def extra(idx, h):
        lp = jax.tree.map(lambda x: x[idx], xattn["layers"])
        return gated_cross_attention_apply(
            lp, h, None, cfg.num_attention_heads,
            cached_kv=(inj_k[idx], inj_v[idx]))
    return extra


@functools.partial(jax.jit, static_argnames=("cfg",))
def reference_logits(params, embeds, mask, ids, inject, *, cfg):
    """Teacher-forced logits [B, n, V] at the n generated positions of
    ``ids`` [B, n] after the prompt ``embeds`` [B, T, D] (mask [B, T]):
    one uncached forward over prompt + ids[:, :-1]."""
    import jax.numpy as jnp

    from desta25_audio_tpu.models import llm as jllm
    T = mask.shape[1]
    new = jllm.embed_tokens(params, ids[:, :-1]).astype(embeds.dtype)
    full = jnp.concatenate(
        [mask, jnp.ones((mask.shape[0], ids.shape[1] - 1), mask.dtype)], 1)
    lg, _, _ = jllm.llm_apply(
        params, cfg, inputs_embeds=jnp.concatenate([embeds, new], 1),
        attention_mask=full, extra_layer_fn=_inject_fn(cfg, inject))
    return lg[:, T - 1:].astype(jnp.float32)


def greedy_tokens_agree(model, convs, tokens, inject: bool = False,
                        tie: float = TIE_FRAC):
    """Every emitted greedy token must be the reference's argmax (up to a
    tie within ``tie`` of the largest logit), the reference being
    :func:`reference_logits` over the same prompt and the tokens before
    it.  tokens: one id list per conversation.  Returns (ok, logits)."""
    import jax.numpy as jnp

    t0 = time.perf_counter()
    cfg = model.llm_cfg
    prep = model._run_generation_phases(convs)
    embeds, mask, aux = prep[0], jnp.asarray(prep[1]), prep[2]
    n = max(len(t) for t in tokens)
    ids = np.zeros((len(tokens), n), np.int32)
    for b, t in enumerate(tokens):
        ids[b, :len(t)] = t
    inj = None
    if inject:
        from desta25_audio_tpu.models.orca import precompute_cross_kv
        from desta25_audio_tpu.ops.rope import fractional_rope_apply
        xattn = model.params["orca_cross_attns"]
        roped = fractional_rope_apply(
            model._orca_inject_tokens(aux),
            model.config.orca_audio_position_scale, cfg.rope_theta)
        inj = (xattn, *precompute_cross_kv(xattn, roped))
    lg = np.asarray(reference_logits(model.params["llm"], embeds, mask,
                                     jnp.asarray(ids), inj, cfg=cfg))
    ok, n_exact, n_tok, worst = True, 0, 0, 0.0
    for b, t in enumerate(tokens):
        for j, tokid in enumerate(t):
            row = lg[b, j]
            gap = float(row.max() - row[tokid])
            worst = max(worst, gap / (np.abs(row).max() + 1e-12))
            n_exact += int(row.argmax() == tokid)
            n_tok += 1
            ok &= gap <= tie * np.abs(row).max()
    print(f"    greedy vs uncached reference: "
          f"{n_exact}/{n_tok} exact argmax, worst gap {worst:.2e} of "
          f"max|logit| (tie bound {tie:.0e}) {'ok' if ok else 'FAIL'}, "
          f"{time.perf_counter() - t0:.1f}s")
    return ok and n_tok > 0, lg


def same_up_to_tie(a: List[list], b: List[list], ref_a: np.ndarray,
                   tie: float = TIE_FRAC) -> bool:
    """Token lists a and b agree, or first differ where the reference
    logits of a's trajectory tie (b's token within ``tie`` of the max):
    two valid roundings of the same greedy decode."""
    ok, n_same = True, 0
    for r, (x, y) in enumerate(zip(a, b)):
        j = next((i for i, (u, v) in enumerate(zip(x, y)) if u != v), None)
        if j is None:
            n_same += int(len(x) == len(y))
            ok &= len(x) == len(y)
            continue
        row = ref_a[r, j]
        gap = float(row.max() - row[y[j]])
        is_tie = gap <= tie * np.abs(row).max()
        print(f"    request {r}: first differs at token {j}, gap "
              f"{gap / (np.abs(row).max() + 1e-12):.2e} of max|logit| -> "
              f"{'tie' if is_tie else 'MISMATCH'}")
        ok &= is_tie
    print(f"    identical token lists: {n_same}/{len(a)}")
    return ok


def serve(model, convs, sz: Sizes, spec_k: int = 0, cache_slack: int = 0):
    """Engine answers every conversation (greedy, admitted together);
    returns per-request token lists in submission order.  cache_slack
    widens the slot cache (a plain engine given the speculative engine's
    cache length shares its prefill program)."""
    from desta25_audio_tpu.serve.engine import ContinuousBatchingEngine
    # two steps per tick so a request spans several ticks; speculation
    # forced on every tick after admission (no adaptive fallback)
    eng = ContinuousBatchingEngine(
        model, n_slots=sz.n_slots, max_ctx=sz.max_ctx + cache_slack,
        max_new_tokens=sz.max_new, ctx_bucket=sz.ctx_bucket,
        steps_per_tick=2, speculative_k=spec_k, adaptive_spec=False)
    assert eng.speculative_k == spec_k
    rids = eng.submit_many(convs)
    t0 = time.perf_counter()
    eng.run_until_done()
    wall = time.perf_counter() - t0
    info = eng.results()
    toks = [list(eng.finished[r]) for r in rids]
    reasons = [info[r]["finish_reason"] for r in rids]
    print(f"    engine spec_k={spec_k}: {len(rids)} requests, "
          f"{sum(map(len, toks))} tokens, finish={reasons}, "
          f"spec_ticks={eng._n_spec_ticks} plain_ticks={eng._n_plain_ticks}"
          f", wall {wall:.1f}s incl. compile")
    assert all(r in ("eos", "length") for r in reasons), reasons
    assert all(toks), toks
    assert eng._n_spec_ticks > 0 or not spec_k, "speculation never ran"
    return toks


# ---------------------------------------------------------------------------
# Phases 2-5
# ---------------------------------------------------------------------------


def phase_generate_and_serve(sz: Sizes, clips: List[str]) -> Dict[str, bool]:
    """Phases 2 and 3 share the flagship model (one 8B init)."""

    from desta25_audio_tpu.ops.quant import quantize_llm_params

    results = {}
    model = build_model(sz.config("qformer_1"))
    # the per-clip feature cache: perception runs once, in generate, and
    # the engines and reference checks splice the cached audio tokens
    model.enable_audio_cache(64)
    convs = conversations(clips[:sz.n_requests])

    print("phase 2: generate (flagship, bf16)", flush=True)
    try:
        out = model.generate(convs, do_sample=False,
                             max_new_tokens=sz.max_new)
        pad = model.tokenizer.pad_token_id
        toks = [[t for t in ids if t != pad] for ids in out.generated_ids]
        print(f"    generated {[len(t) for t in toks]} tokens")
        results["generate"] = greedy_tokens_agree(model, convs, toks)[0]
    except Exception:  # noqa: BLE001 - reported, fails the run
        traceback.print_exc()
        results["generate"] = False

    print("phase 3: serve (bf16 tower, then int8 tower +- speculation)",
          flush=True)
    try:
        toks = serve(model, convs, sz)
        ok = greedy_tokens_agree(model, convs, toks)[0]
        model.params["llm"] = jax.jit(quantize_llm_params)(
            model.params["llm"])
        gc.collect()
        plain = serve(model, convs, sz, cache_slack=sz.spec_k)
        ok_plain, ref = greedy_tokens_agree(model, convs, plain)
        spec = serve(model, convs, sz, spec_k=sz.spec_k)
        print("    int8 speculative tokens vs plain tokens:")
        same = same_up_to_tie(plain, spec, ref)
        results["serve"] = ok and ok_plain and same
    except Exception:  # noqa: BLE001 - reported, fails the run
        traceback.print_exc()
        results["serve"] = False
    return results


def phase_orca(sz: Sizes, clips: List[str]) -> bool:
    model = build_model(sz.config("orca_hybrid"))
    convs = conversations(clips[:2])
    toks = serve(model, convs, sz)
    return greedy_tokens_agree(model, convs, toks, inject=True)[0]


def phase_train(sz: Sizes, stats_out: Dict[str, str]) -> bool:
    from desta25_audio_tpu.train.bench_utils import build_train_setup
    cfg, step, trainable, frozen, opt_state, batch = build_train_setup(
        sz.config("qformer_1"), sz.train_batch, sz.train_seq)
    compiled = step.lower(trainable, frozen, opt_state, batch).compile()
    ma = compiled.memory_analysis()
    if ma is not None:
        g = 1 << 30
        stats_out["train_step"] = (
            f"args {ma.argument_size_in_bytes / g:.2f} GiB, "
            f"out {ma.output_size_in_bytes / g:.2f} GiB, "
            f"temp {ma.temp_size_in_bytes / g:.2f} GiB")
        print(f"    memory_analysis(train step): {stats_out['train_step']}")
    losses = []
    for _ in range(sz.train_steps):
        trainable, opt_state, metrics = compiled(trainable, frozen,
                                                 opt_state, batch)
        losses.append(float(metrics["loss"]))
    print(f"    batch {sz.train_batch} x seq {sz.train_seq}: "
          f"losses {[round(x, 4) for x in losses]}")
    return bool(np.isfinite(losses).all())


def run_one_card(sz: Sizes, stats: CompileStats) -> bool:
    mem: Dict[str, str] = {}
    with tempfile.TemporaryDirectory() as d:
        clips = write_clips(d, max(sz.n_requests, 2))
        shared: Dict[str, bool] = {}

        def gen_serve():
            shared.update(phase_generate_and_serve(sz, clips))
            return shared["generate"] and shared["serve"]

        ok = run_phases([
            ("1 ops", lambda: phase_ops(sz)),
            ("2+3 generate+serve", gen_serve),
            ("4 orca", lambda: phase_orca(sz, clips)),
            ("5 train", lambda: phase_train(sz, mem)),
        ], stats)
    return ok


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------


def phase_dp_tp_train(setup, devices) -> bool:
    """Loss and connector gradients of one train batch on a (data=2,
    model=2) mesh against the same batch on one card.  setup: what
    ``build_train_setup`` returns."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from desta25_audio_tpu.parallel.mesh import make_mesh, use_mesh
    from desta25_audio_tpu.parallel.sharding import (
        apply_sharding,
        llm_partition_specs,
        replicated_specs,
        whisper_partition_specs,
    )
    from desta25_audio_tpu.train.step import _forward

    cfg, _, trainable, frozen, _, batch = setup

    def loss_fn(tr, fr, b):
        return _forward({**fr, **tr}, b, cfg, remat=True, training=True)[0]

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    loss1, g1 = grad_fn(trainable, frozen, batch)
    loss1, g1 = float(loss1), jax.device_get(g1)

    mesh = make_mesh(n_data=2, n_model=2, devices=devices[:4])
    with use_mesh(mesh):
        fr = {"llm": apply_sharding(frozen["llm"],
                                    llm_partition_specs(frozen["llm"])),
              "whisper": apply_sharding(
                  frozen["whisper"],
                  whisper_partition_specs(frozen["whisper"]))}
        tr = apply_sharding(trainable, replicated_specs(trainable))
        b = {k: jax.device_put(v, NamedSharding(
                mesh, P("data", *([None] * (v.ndim - 1)))))
             for k, v in batch.items()}
        loss4, g4 = jax.jit(jax.value_and_grad(loss_fn))(tr, fr, b)
        loss4, g4 = float(loss4), jax.device_get(g4)
    flat1 = np.concatenate([np.ravel(x).astype(np.float64)
                            for x in jax.tree.leaves(g1)])
    flat4 = np.concatenate([np.ravel(x).astype(np.float64)
                            for x in jax.tree.leaves(g4)])
    gerr = float(np.linalg.norm(flat4 - flat1) / np.linalg.norm(flat1))
    print(f"    loss one card {loss1:.6f}, 2x2 mesh {loss4:.6f}")
    # bf16 activations through the full tower, reduced in another order
    # across the mesh: a loss within 1e-2 relative, gradients within 5e-2
    ok = check("dp x tp loss rel", abs(loss4 - loss1) / abs(loss1), 1e-2)
    ok &= check("dp x tp connector grad rel L2", gerr, 5e-2)
    return ok and np.isfinite(loss1)


def phase_tp_decode(sz: Sizes, cfg, params, devices) -> bool:
    """Greedy decode of the LLM ``params`` (config ``cfg``) with the
    tower sharded over a 4-way "model" axis, each token checked against
    an uncached one-card forward."""
    import jax.numpy as jnp

    from desta25_audio_tpu.generate.decode import llm_generate
    from desta25_audio_tpu.models import llm as jllm
    from desta25_audio_tpu.parallel.mesh import make_mesh, use_mesh
    from desta25_audio_tpu.parallel.sharding import (
        apply_sharding,
        llm_partition_specs,
    )

    B, T = 2, sz.tp_prompt
    ids = jnp.asarray(np.random.default_rng(0).integers(
        10, cfg.vocab_size - 10, (B, T)), jnp.int32)
    mask = jnp.ones((B, T), jnp.int32)

    def gen(p):
        out, _ = llm_generate(p, cfg, jllm.embed_tokens(p, ids), mask,
                              jax.random.PRNGKey(0), max_new_tokens=sz.tp_new,
                              do_sample=False, eos_ids=(), pad_id=-1)
        return np.asarray(out)

    one = gen(params)
    mesh = make_mesh(n_data=1, n_model=4, devices=devices[:4])
    with use_mesh(mesh):
        sharded = apply_sharding(params, llm_partition_specs(params))
        four = gen(sharded)
    del sharded
    print(f"    TP=4 tokens == one-card tokens: "
          f"{int((four == one).sum())}/{four.size}")

    @jax.jit
    def forward(p, toks):
        lg, _, _ = jllm.llm_apply(
            p, cfg, input_ids=jnp.concatenate([ids, toks[:, :-1]], 1))
        return lg[:, T - 1:].astype(jnp.float32)

    lg = np.asarray(forward(params, jnp.asarray(four)))
    rows = np.take_along_axis(lg, four[..., None], -1)[..., 0]
    gap = (lg.max(-1) - rows) / np.abs(lg).max(-1)
    return check("TP=4 greedy tokens, worst gap to one-card argmax "
                 "(fraction of max|logit|)", float(gap.max()), TIE_FRAC)


def run_four_cards(sz: Sizes, stats: CompileStats, devices) -> bool:
    """Both phases share one random flagship (its LLM is the one TP=4
    decodes)."""
    from desta25_audio_tpu.train.bench_utils import build_train_setup
    setup: list = []

    def train():
        setup.extend(build_train_setup(sz.config("qformer_1"),
                                       sz.train_batch, sz.train_seq))
        return phase_dp_tp_train(setup, devices)

    def decode():
        cfg, frozen = setup[0], setup[3]
        return phase_tp_decode(sz, cfg.llm_config, frozen["llm"], devices)

    return run_phases([("dp x tp train step", train),
                       ("TP=4 decode", decode)], stats)


# ---------------------------------------------------------------------------


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phases")
    args = ap.parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)

    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX's default backend is {jax.default_backend()}",
              file=sys.stderr)
        return 2
    cache_dir = setup_compilation_cache()
    devices = jax.devices()
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"needs {need} GPUs, JAX sees {len(devices)}", file=sys.stderr)
        return 2
    print(f"gpu: {gpu_name_and_power()}")
    print(f"jax {jax.__version__}, {len(devices)} x "
          f"{devices[0].device_kind}, compile cache {cache_dir}", flush=True)
    stats = CompileStats()
    t0 = time.perf_counter()
    if args.four_cards:
        ok = run_four_cards(FULL_FOUR_CARDS, stats, devices)
    else:
        ok = run_one_card(FULL, stats)
    print(f"total wall {time.perf_counter() - t0:.1f}s, compile "
          f"{stats.secs:.1f}s (set-up), persistent cache hits "
          f"{stats.hits} misses {stats.misses}")
    print(json.dumps({"ok": bool(ok), "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
