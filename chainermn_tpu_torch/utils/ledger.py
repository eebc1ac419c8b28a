"""Append-only fsynced JSONL ledgers: the machine-readable record a dead
control loop leaves behind.

Counterpart of ``chainermn_tpu/utils/ledger.py``, the same file format,
so each package reads the other's ledgers.  The training supervisor
writes ``supervisor_ledger.jsonl`` through it, the serving fleet
(:mod:`~chainermn_tpu_torch.serving.fleet`) ``fleet_ledger.jsonl`` and
its request journal:

- **Append-only, fsynced.**  One JSON object per line; every append
  flushes and fsyncs before it returns, so an entry that was written
  survives the writer dying the next instant (an ``os._exit`` from a
  chaos kill site included).  The entry order is the event order.
- **Tolerant read.**  :meth:`Ledger.read` returns every parseable line
  and skips a torn tail, the footprint of a writer killed mid-append.
- **Self-describing entries.**  Every entry carries ``event`` (the type)
  and ``t`` (wall-clock seconds); everything else is the writer's
  schema.
"""

import json
import os
import time


class Ledger:
    """Append-only JSONL event log: one JSON object per line, fsynced per
    append."""

    def __init__(self, path):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def append(self, event, **fields):
        rec = dict(fields, event=event, t=round(time.time(), 3))
        with open(self.path, 'a') as f:
            f.write(json.dumps(rec, default=repr, sort_keys=True) + '\n')
            f.flush()
            os.fsync(f.fileno())
        return rec

    @staticmethod
    def read(path):
        """Every parseable entry (a torn tail is skipped; a missing file
        reads as empty)."""
        out = []
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            pass
        return out


def events(entries, kind):
    """The entries of one event type, in ledger order."""
    return [e for e in entries if e.get('event') == kind]
