"""Small utilities (reference desta/utils/utils.py + lulutils usage:
``run(cmd)``, ``resolve_filepath`` with URL support, ``get_unique_filepath``
— SURVEY §2.8)."""

from __future__ import annotations

import os
import shlex
import subprocess
from typing import Optional


def run(cmd: str, check: bool = True) -> str:
    """Run a shell command, return stdout (desta/utils/utils.py)."""
    proc = subprocess.run(shlex.split(cmd), capture_output=True, text=True)
    if check and proc.returncode != 0:
        raise RuntimeError(
            f"command failed ({proc.returncode}): {cmd}\n{proc.stderr}")
    return proc.stdout


def resolve_filepath(path: str, cache_dir: Optional[str] = None) -> str:
    """Resolve a local path or URL to a local file.

    URLs are downloaded to ``cache_dir`` (or ~/.cache/desta25_audio) — only
    when network egress exists; in sealed environments a clear error is
    raised instead of a silent hang."""
    if not path.startswith(("http://", "https://")):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return path
    cache_dir = cache_dir or os.path.expanduser("~/.cache/desta25_audio")
    os.makedirs(cache_dir, exist_ok=True)
    local = os.path.join(cache_dir, os.path.basename(path.split("?")[0]))
    if os.path.exists(local):
        return local
    import urllib.request
    try:
        urllib.request.urlretrieve(path, local)  # noqa: S310
    except Exception as e:  # noqa: BLE001
        raise RuntimeError(
            f"could not download {path} (no network egress?): {e}") from e
    return local


def get_unique_filepath(path: str) -> str:
    """Return ``path`` or, if it exists, ``stem-1.ext``, ``stem-2.ext``, ..."""
    if not os.path.exists(path):
        return path
    stem, ext = os.path.splitext(path)
    i = 1
    while os.path.exists(f"{stem}-{i}{ext}"):
        i += 1
    return f"{stem}-{i}{ext}"
