"""Time-indexed transcript store (sqlite).

Counterpart of the JAX repository's experimental/fm_streaming_rag/
timestamps.py: every embedded chunk is also recorded with its wall-clock
timestamp, so that "what was said in the last five minutes" retrieves by
time, not similarity. Timestamps are epoch floats; the database path is
injectable (":memory:" by default).
"""
from __future__ import annotations

import sqlite3
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class TimedDoc:
    content: str
    tstamp: float
    source_id: str
    metadata: Dict = field(default_factory=dict)


class TimestampDB:
    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS messages ("
                "id INTEGER PRIMARY KEY, text TEXT, tstamp REAL, source_id TEXT)"
            )
            self._conn.commit()

    def insert_docs(self, texts: List[str], source_id: str, tstamp: float | None = None) -> None:
        tnow = time.time() if tstamp is None else tstamp
        with self._lock:
            self._conn.executemany(
                "INSERT INTO messages (text, tstamp, source_id) VALUES (?, ?, ?)",
                [(text, tnow, source_id) for text in texts],
            )
            self._conn.commit()

    def _rows(self, query: str, args: tuple) -> List[TimedDoc]:
        with self._lock:
            rows = self._conn.execute(query, args).fetchall()
        return [TimedDoc(content=r[1], tstamp=r[2], source_id=r[3]) for r in rows]

    def recent(self, since_tstamp: float) -> List[TimedDoc]:
        """All entries at or after ``since_tstamp``, oldest first."""
        return self._rows(
            "SELECT * FROM messages WHERE tstamp >= ? ORDER BY tstamp ASC",
            (since_tstamp,),
        )

    def past(self, tstamp: float, window: float = 90.0) -> List[TimedDoc]:
        """Entries within ``window`` seconds of ``tstamp``, oldest first."""
        return self._rows(
            "SELECT * FROM messages WHERE tstamp BETWEEN ? AND ? ORDER BY tstamp ASC",
            (tstamp - window, tstamp + window),
        )

    def count(self) -> int:
        with self._lock:
            return int(self._conn.execute("SELECT COUNT(*) FROM messages").fetchone()[0])

    def close(self) -> None:
        with self._lock:
            self._conn.close()
