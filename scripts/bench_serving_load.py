"""REAL-engine serving-under-load benchmark (flagship 8B int8).

Everything before this ran engine-SHAPED programs (the jitted tick math
without the host loop).  This drives the actual
`serve.engine.ContinuousBatchingEngine` — host bookkeeping, batched
perception at submit, bucketed admission prefill overlapping the
in-flight tick, slot reuse — with a steady arrival stream, and reports:

  - sustained tok/s at the configured slot count
  - per-request TTFT (submit -> first token; includes perception +
    queue wait + admission prefill)
  - inter-token latency per request at tick granularity (tokens arrive
    in bursts of steps_per_tick per slot; p50/p99 of per-token gaps)
  - tick-duration p50/p99 split by ticks that did vs didn't admit
    (quantifies the admission prefill stall on active slots)

Weights are random (fast_init); the tokenizer is the offline
CharTokenizer (the HF Llama tokenizer needs hub access) — token
IDENTITY is meaningless here, only timing matters.

    python scripts/bench_serving_load.py [n_slots] [n_requests]
           (--orca: the ORCA flagship — Qwen3-4B int8 + gated
           cross-attention deep injection per slot)
"""
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from desta25_audio_tpu.config import DeSTA25Config
from desta25_audio_tpu.data.tokenizer import CharTokenizer
from desta25_audio_tpu.models.desta import DeSTA25AudioModel
from desta25_audio_tpu.serve.engine import ContinuousBatchingEngine
from desta25_audio_tpu.utils.compilation_cache import setup_compilation_cache
from desta25_audio_tpu.utils.fast_init import random_tree_like

setup_compilation_cache()

ARGS = [a for a in sys.argv[1:] if not a.startswith("-")]
ORCA = "--orca" in sys.argv[1:]
# --spec K: speculative verify ticks (n-gram drafting)
SPEC_K = 0
for a in sys.argv[1:]:
    if a.startswith("--spec"):
        SPEC_K = int(a.split("=")[1]) if "=" in a else 4
# pipelined ticks are the engine default; --no-pipeline measures the
# sequential engine
PIPELINE = "--no-pipeline" not in sys.argv[1:]
# --no-adaptive forces speculation on every tick (A/B the acceptance-
# EMA controller)
ADAPTIVE = "--no-adaptive" not in sys.argv[1:]
# --repetitive: init weights at tiny scale so greedy continuations fall
# into short cycles — the transcription-echo/JSON/list regime where the
# bigram drafter accepts ~Kd tokens/step (same proxy as
# scripts/bench_serving_spec.py's scale=0.001 workload)
REPETITIVE = "--repetitive" in sys.argv[1:]
# --burst: submit every request up front (saturated drain, no arrival
# schedule) — the regime where the adaptive engine's quiet gate lets
# speculation resume after the admission burst (r5)
BURST = "--burst" in sys.argv[1:]
N_SLOTS = int(ARGS[0]) if len(ARGS) > 0 else 8
N_REQUESTS = int(ARGS[1]) if len(ARGS) > 1 else 48
MAX_NEW = 48
for a in sys.argv[1:]:
    # --max-new=N: generation budget per request (burst+spec regimes
    # need long drains — at 48 tokens a plain engine drains 8 slots in
    # 6 ticks and the quiet gate's warmup eats the verify win)
    if a.startswith("--max-new"):
        MAX_NEW = int(a.split("=", 1)[1])
ARRIVAL_GROUP = 2        # requests per arrival batch
ARRIVE_EVERY = 2         # ticks between arrival batches


def build_model(orca: bool = False):
    """Flagship serving model with fast-init weights.  orca=True builds
    the reference's ORCA flagship (Qwen3-4B + hybrid connector + gated
    cross-attention deep injection)."""
    if orca:
        cfg = DeSTA25Config(
            llm_model_id="Qwen/Qwen3-4B-Instruct-2507",
            encoder_model_id="openai/whisper-large-v3",
            connector_mode="orca_hybrid", prompt_size=64,
            dtype="bfloat16", llm_quant="int8",
            orca_global_num_tokens=64, orca_local_downsample=4,
            orca_local_kernel_size=5, orca_audio_position_scale=2.5,
            orca_gate_init=0.1, orca_xattn_dtype="bfloat16")
    else:
        cfg = DeSTA25Config(
            llm_model_id="DeSTA-ntu/Llama-3.1-8B-Instruct",
            encoder_model_id="openai/whisper-large-v3",
            connector_mode="qformer_1", qformer_num_hidden_layers=6,
            prompt_size=64, dtype="bfloat16", llm_quant="int8")
    shape_model = DeSTA25AudioModel.__new__(DeSTA25AudioModel)
    # build the param tree by shape, then fill it with fast random init
    shape_model.config = cfg
    shape_model.llm_cfg = cfg.llm_config
    shape_model.enc_cfg = cfg.encoder_config
    shape_model.dtype = jnp.bfloat16
    pshape = jax.eval_shape(
        lambda k: DeSTA25AudioModel._init_params(shape_model, k),
        jax.random.PRNGKey(0))
    params = random_tree_like(jax.random.PRNGKey(1), lambda k: pshape,
                              scale=0.001 if REPETITIVE else 0.02)
    if orca and "orca_cross_attns" in params:
        # serving transform: int8 injection weights halve the ~2.8 GB/step
        # gated-cross-attention weight stream (ops/quant.py)
        from desta25_audio_tpu.ops.quant import quantize_orca_cross_attns
        params["orca_cross_attns"] = jax.jit(quantize_orca_cross_attns)(
            params["orca_cross_attns"])
    # serving deployment default (encoder_quant="auto" -> int8 at the
    # inference entry): W8A8 encoder FFN and attention projections
    from desta25_audio_tpu.ops.quant import quantize_encoder_params
    params = dict(params)
    params["whisper"] = dict(params["whisper"])
    params["whisper"]["encoder"] = jax.jit(quantize_encoder_params)(
        params["whisper"]["encoder"])
    jax.block_until_ready(params)
    return DeSTA25AudioModel(cfg, params=params,
                             tokenizer=CharTokenizer())


def main():
    t0 = time.time()
    model = build_model(ORCA)
    print(f"model init ({'orca' if ORCA else 'qformer'}) "
          f"{time.time()-t0:.0f}s", file=sys.stderr)

    eng = ContinuousBatchingEngine(
        model, n_slots=N_SLOTS, max_ctx=256, max_new_tokens=MAX_NEW,
        ctx_bucket=128, steps_per_tick=8, speculative_k=SPEC_K,
        adaptive_spec=ADAPTIVE, pipeline_ticks=PIPELINE)
    if SPEC_K:
        assert eng.speculative_k == SPEC_K, "spec ticks not eligible here"

    from desta25_audio_tpu.audio.io import write_wav
    clip = (0.1 * np.random.default_rng(0).standard_normal(16000 * 30)
            ).astype(np.float32)
    clip_path = "/tmp/bench_load_clip.wav"
    write_wav(clip_path, clip)

    def msgs(i):
        return [{"role": "user",
                 "content": f"describe clip {i}: <|AUDIO|>",
                 "audios": [{"audio": clip_path,
                             "text": "someone is speaking over noise"}]}]

    # timing hooks
    first_tok_t = {}
    burst_t = {}

    def on_token(rid, tok):
        now = time.time()
        first_tok_t.setdefault(rid, now)
        ts = burst_t.setdefault(rid, [])
        # tokens land in bursts (K per tick per slot); record burst edges
        # (bursts are >= one tick apart; within-burst callbacks are ~us)
        if not ts or now - ts[-1] > 5e-3:
            ts.append(now)

    eng.on_token = on_token

    def run_pass(tag):
        """Submit N_REQUESTS on the fixed arrival schedule and drain.
        The first pass compiles every program the schedule reaches
        (perception/prefill at each group size, the tick program); the
        second, identical pass is the measurement."""
        first_tok_t.clear()
        burst_t.clear()
        submit_t = {}
        pending = list(range(N_REQUESTS))
        nfirst = len(pending) if BURST else N_SLOTS
        first = pending[:nfirst]
        pending = pending[nfirst:]
        t_start = time.time()
        ts = time.time()
        for rid in eng.submit_many([msgs(i) for i in first]):
            submit_t[rid] = ts
        tick_durs = []
        ticks = 0
        while True:
            admit_now = bool(pending) and ticks % ARRIVE_EVERY == 0
            if admit_now:
                grp = pending[:ARRIVAL_GROUP]
                pending = pending[ARRIVAL_GROUP:]
                ts = time.time()
                for rid in eng.submit_many([msgs(i) for i in grp]):
                    submit_t[rid] = ts
            t1 = time.time()
            eng.step()
            tick_durs.append((time.time() - t1, admit_now))
            ticks += 1
            if not pending and not eng.queue \
                    and all(r is None for r in eng.slot_req):
                break
            if ticks > 10000:
                raise RuntimeError("engine did not drain")
        t_total = time.time() - t_start
        total_tokens = sum(len(eng.finished[r]) for r in submit_t)
        print(f"{tag} pass: {ticks} ticks {t_total:.1f}s", file=sys.stderr)
        return submit_t, tick_durs, ticks, t_total, total_tokens

    run_pass("warmup")  # compiles all programs on the real schedule
    submit_t, tick_durs, ticks, t_total, total_tokens = run_pass("timed")

    ttfts = sorted((first_tok_t[r] - submit_t[r]) * 1e3
                   for r in submit_t if r in first_tok_t)
    gaps = []
    for r, ts in burst_t.items():
        if r not in submit_t:
            continue
        # K tokens land per burst: per-token latency inside a burst is
        # burst_gap / K (they were produced sequentially on-device)
        gaps.extend((b - a) * 1e3 / eng.steps_per_tick
                    for a, b in zip(ts, ts[1:]))
    gaps.sort()

    def pct(xs, q):
        return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else float("nan")

    d_admit = sorted(d for d, a in tick_durs if a)
    d_plain = sorted(d for d, a in tick_durs if not a)
    print(f"slots={N_SLOTS} requests={N_REQUESTS} max_new={MAX_NEW} "
          f"K={eng.steps_per_tick} ticks={ticks}")
    print(f"throughput      {total_tokens / t_total:8.1f} tok/s "
          f"({total_tokens} tokens in {t_total:.1f}s)")
    print(f"TTFT ms         p50 {pct(ttfts, 0.5):7.1f}   "
          f"p99 {pct(ttfts, 0.99):7.1f}")
    print(f"per-token ms    p50 {pct(gaps, 0.5):7.2f}   "
          f"p99 {pct(gaps, 0.99):7.2f}  (burst gap / K)")
    print(f"tick ms (admit) p50 {pct(d_admit, 0.5)*1e3:7.1f}   "
          f"p99 {pct(d_admit, 0.99)*1e3:7.1f}   n={len(d_admit)}")
    print(f"tick ms (plain) p50 {pct(d_plain, 0.5)*1e3:7.1f}   "
          f"p99 {pct(d_plain, 0.99)*1e3:7.1f}   n={len(d_plain)}")
    if SPEC_K:
        print(f"tick mix        spec={eng._n_spec_ticks} "
              f"plain={eng._n_plain_ticks} "
              f"(adaptive={'on' if ADAPTIVE else 'off'}, "
              f"spec_live={eng._spec_live}, "
              f"acceptance_ema={eng._spec_ema:.2f})")


if __name__ == "__main__":
    main()
