"""Append-only metrics.jsonl, as toycrystals_tpu/utils/metrics.py writes it:
one JSON object per line, e.g. {"epoch": N, "loss": x}."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any


def ensure_file(path: str | Path) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    if not p.exists():
        p.touch()


def append_jsonl(path: str | Path, obj: dict[str, Any]) -> None:
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(obj) + "\n")


def truncate_jsonl(path: str | Path, key: str, max_value: int) -> None:
    """Drop the rows with row[key] > max_value (atomic rewrite).

    Used on --resume when the checkpoint cadence (--ckpt-every N) lags the
    per-epoch appends: rows past the restored epoch would otherwise be
    written twice by the epochs trained again.
    """
    p = Path(path)
    if not p.exists():
        return
    kept = []
    with open(p, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line and json.loads(line).get(key, 0) <= max_value:
                kept.append(line)
    tmp = p.with_suffix(p.suffix + ".tmp")
    tmp.write_text("".join(k + "\n" for k in kept), encoding="utf-8")
    tmp.replace(p)
