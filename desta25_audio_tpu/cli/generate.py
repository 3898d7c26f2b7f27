"""Inference CLI — one-shot generate over a checkpoint.

    python -m desta25_audio_tpu.cli.generate --model ckpt/ \\
        --audio clip.wav --prompt "Describe this audio: <|AUDIO|>" \\
        [--system "Focus on the audio clips."] [--transcription "..."] \\
        [--max-new-tokens 128] [--sample --temperature 0.7 --top-p 0.9] \\
        [--chunk-long-audio]

Mirrors the reference README's quickstart usage (README.md:50-82).
"""

from __future__ import annotations

import argparse
import json
import logging


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True,
                        help="checkpoint dir (save_pretrained output)")
    parser.add_argument("--audio", action="append", default=[],
                        help="audio file (repeatable; one per <|AUDIO|>)")
    parser.add_argument("--prompt", required=True)
    parser.add_argument("--system", default=None)
    parser.add_argument("--transcription", action="append", default=[],
                        help="known transcription per audio (optional; "
                             "omitted -> VAD+ASR)")
    parser.add_argument("--max-new-tokens", type=int, default=128)
    parser.add_argument("--sample", action="store_true")
    parser.add_argument("--temperature", type=float, default=0.7)
    parser.add_argument("--top-p", type=float, default=0.9)
    parser.add_argument("--chunk-long-audio", action="store_true")
    parser.add_argument("--json", action="store_true",
                        help="print the full GenerationOutput as JSON")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from ..utils.compilation_cache import setup_compilation_cache
    setup_compilation_cache()
    from ..models.desta import DeSTA25AudioModel
    model = DeSTA25AudioModel.from_pretrained(args.model)

    prompt = args.prompt
    if args.audio and "<|AUDIO|>" not in prompt:
        prompt = prompt + " " + " ".join(["<|AUDIO|>"] * len(args.audio))

    audios = []
    for i, path in enumerate(args.audio):
        text = (args.transcription[i]
                if i < len(args.transcription) else None)
        audios.append({"audio": path, "text": text})

    messages = []
    if args.system:
        messages.append({"role": "system", "content": args.system})
    user = {"role": "user", "content": prompt}
    if audios:
        user["audios"] = audios
    messages.append(user)

    out = model.generate(
        messages, max_new_tokens=args.max_new_tokens,
        do_sample=args.sample, temperature=args.temperature,
        top_p=args.top_p, auto_chunk_long_audio=args.chunk_long_audio)
    if args.json:
        print(json.dumps({"text": out.text, "audios": out.audios,
                          "generated_ids": out.generated_ids}))
    else:
        print(out.text[0])


if __name__ == "__main__":
    main()
