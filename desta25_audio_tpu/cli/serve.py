"""Serving CLI — HTTP front-end over the continuous-batching engine.

    python -m desta25_audio_tpu.cli.serve --model ckpt/ \\
        [--host 127.0.0.1] [--port 8000] [--slots 16] \\
        [--max-ctx 256] [--max-new-tokens 256] [--steps-per-tick 8] \\
        [--speculative-k 4] [--pipeline-ticks] [--on-overflow error]

The reference has no serving stack (its generate() is a blocking HF
call); see docs/serve.md for the API (POST /v1/generate with the
generate() message schema, SSE streaming, DELETE /v1/requests/<id>,
GET /v1/health).  LoRA checkpoints are merge-and-unloaded so the tower
decodes without the adapter matmuls and can be int8-quantized.
"""

from __future__ import annotations

import argparse
import logging

logger = logging.getLogger(__name__)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True,
                        help="checkpoint dir (save_pretrained output)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--slots", type=int, default=16)
    parser.add_argument("--max-ctx", type=int, default=256)
    parser.add_argument("--max-new-tokens", type=int, default=256)
    parser.add_argument("--ctx-bucket", type=int, default=128)
    parser.add_argument("--steps-per-tick", type=int, default=8)
    parser.add_argument("--speculative-k", type=int, default=0)
    parser.add_argument("--pipeline-ticks", action="store_true")
    parser.add_argument("--on-overflow", choices=["error", "truncate"],
                        default="error")
    parser.add_argument("--audio-cache", type=int, default=64,
                        help="per-clip feature cache capacity (0 = off)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from ..utils.compilation_cache import setup_compilation_cache
    setup_compilation_cache()
    from ..models.desta import DeSTA25AudioModel
    from ..serve.engine import ContinuousBatchingEngine
    from ..serve.http import serve_http

    model = DeSTA25AudioModel.from_pretrained(args.model)
    if "lora" in model.params:
        logger.info("merging LoRA adapters for serving")
        model.merge_lora_for_serving()
    engine = ContinuousBatchingEngine(
        model, n_slots=args.slots, max_ctx=args.max_ctx,
        max_new_tokens=args.max_new_tokens, ctx_bucket=args.ctx_bucket,
        steps_per_tick=args.steps_per_tick,
        speculative_k=args.speculative_k,
        pipeline_ticks=args.pipeline_ticks,
        on_overflow=args.on_overflow,
        audio_cache=args.audio_cache)
    logger.info("serving on http://%s:%d (%d slots)", args.host,
                args.port, args.slots)
    serve_http(engine, args.host, args.port)


if __name__ == "__main__":
    main()
