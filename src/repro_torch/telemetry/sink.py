"""Host-side trace sink: structured JSONL round events and the verbose
reporter.

:class:`TraceSink` merges each round's ``RoundRecord``, ``CommStats`` and
telemetry into one flat JSON object per line, and owns the trainer's
verbose reporting, routed through :mod:`logging` (``repro_torch.telemetry``)
so test harnesses and deployments can capture it.
"""
from __future__ import annotations

import json
import logging
from typing import IO, Any, Dict, List, Optional

logger = logging.getLogger("repro_torch.telemetry")


def _json_default(obj: Any):
    """Coerce tensors and numpy values that ``json`` cannot serialise.

    0-d tensors and arrays (and numpy scalars) become Python scalars via
    ``.item()``; anything with ``.tolist()`` becomes a nested list (a tensor
    on the card is copied to the host first). Everything else keeps json's
    TypeError, so junk still fails loudly.
    """
    if getattr(obj, "is_cuda", False):
        obj = obj.cpu()
    item = getattr(obj, "item", None)
    if item is not None and getattr(obj, "ndim", None) == 0:
        return item()
    tolist = getattr(obj, "tolist", None)
    if tolist is not None:
        return tolist()
    raise TypeError(f"Object of type {type(obj).__name__} is not JSON serializable")


class TraceSink:
    """Collects structured round events; optionally persists them as JSONL.

    ``emit(event)`` appends a dict to ``events`` and, when a path was given,
    writes it as one JSON line, flushed at once (a crashed run still leaves
    a readable trace). ``report(msg)`` is the human channel: it logs at
    INFO and prints when no handler would show the message.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = str(path) if path is not None else None
        self.events: List[Dict[str, Any]] = []
        self._fh: Optional[IO[str]] = None
        if self.path is not None:
            self._fh = open(self.path, "w")

    def emit(self, event: Dict[str, Any]) -> None:
        self.events.append(event)
        if self._fh is not None:
            self._fh.write(json.dumps(event, default=_json_default) + "\n")
            self._fh.flush()

    def report(self, msg: str) -> None:
        logger.info(msg)
        # the root logger's default (WARNING) swallows INFO: print unless
        # someone routed the logger somewhere
        if not logger.isEnabledFor(logging.INFO):
            print(msg)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "TraceSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL trace written by :class:`TraceSink`."""
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]
