"""Audio-feature cache for serving: skips file decode, VAD, ASR and the
whole perception tower (mel -> encoder -> Q-Former) for clips already
seen.  Multi-turn conversations resubmit the same clip every turn, and
perception is a large part of a single request's TTFT — a hit turns
that into a host dict lookup plus a device splice.

The reference recomputes perception on every generate() call
(modeling_desta25.py:1491-1568); this cache is new framework surface,
opt-in via ``DeSTA25AudioModel.enable_audio_cache()`` and ON by default
in the serving engine / cli.serve.

Keys are file identity (abspath, mtime_ns, size) — no content hashing,
so an in-place overwrite that preserves both mtime_ns and size would
serve stale features (the usual stat-cache caveat; touching the file or
writing a new one invalidates).  Entries hold device arrays: connector
tokens [K, d_llm] (a few hundred KB), ORCA local tokens when present,
the VAD verdict, and — lazily — the ASR transcription (filled only once
a request actually needs it, so clips always submitted with a user
transcription never pay an ASR pass).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple


class AudioFeatureCache:
    """Thread-safe LRU: {file identity -> per-clip perception entry}.

    Entry dict fields:
      speech: bool          VAD verdict
      asr_text: str|None    lazily-filled ASR transcription
      feats: [K, d] device  connector audio tokens
      local: [Ta, d]|None   ORCA local tokens (deep injection)
    """

    def __init__(self, capacity: int = 64):
        self.capacity = int(capacity)
        self._d: "OrderedDict[Tuple, Dict[str, Any]]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(path: str) -> Tuple[str, int, int]:
        st = os.stat(path)
        return (os.path.abspath(path), st.st_mtime_ns, st.st_size)

    def get(self, key) -> Optional[Dict[str, Any]]:
        with self._lock:
            e = self._d.get(key)
            if e is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return e

    def put(self, key, entry: Dict[str, Any]) -> None:
        with self._lock:
            self._d[key] = entry
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
