"""SQLite run logger — counterpart of ``vq_tpu/utils/run_logger.py``, with
the same schema, so either package reads the other's databases.

Same `runs` table and columns as reference src/haag_vq/utils/run_logger.py:71-115
(timestamp, git branch/commit, package version, method, dataset, cli_command,
metrics_json, config_json, sweep_id) so existing tooling / the reference's
plot suite can read our databases.  Adds a `host_rank` column for pod-wide
runs (SURVEY.md §5: "add per-host rank tagging"); the ALTER TABLE migration
pattern mirrors the reference's backwards-compatibility approach.
"""

from __future__ import annotations

import json
import os
import shlex
import sqlite3
import subprocess
import sys
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

import numpy as np


def _to_native(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _to_native(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_native(v) for v in obj]
    if isinstance(obj, (np.integer, np.floating)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def _git_info() -> tuple:
    try:
        branch = subprocess.check_output(
            ["git", "rev-parse", "--abbrev-ref", "HEAD"], stderr=subprocess.DEVNULL
        ).decode().strip()
        commit = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL
        ).decode().strip()
        return branch, commit
    except Exception:
        return "unknown", "unknown"


_COLUMNS = [
    ("config_json", "TEXT"),
    ("sweep_id", "TEXT"),
    ("host_rank", "INTEGER"),
]


def _ensure_schema(cursor: sqlite3.Cursor) -> None:
    cursor.execute(
        """
        CREATE TABLE IF NOT EXISTS runs (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            timestamp TEXT,
            git_branch TEXT,
            git_commit TEXT,
            package_version TEXT,
            method TEXT,
            dataset TEXT,
            cli_command TEXT,
            metrics_json TEXT
        )
        """
    )
    for col, typ in _COLUMNS:
        try:
            cursor.execute(f"ALTER TABLE runs ADD COLUMN {col} {typ}")
        except sqlite3.OperationalError:
            pass  # column exists


def log_run(
    method: str,
    dataset: str,
    metrics: Dict[str, Any],
    config: Optional[Dict[str, Any]] = None,
    sweep_id: Optional[str] = None,
    db_path: Optional[str] = None,
    host_rank: int = 0,
) -> None:
    """Append one benchmark run. db_path priority: param > $DB_PATH > default."""
    if db_path is None:
        db_path = os.getenv("DB_PATH", "logs/benchmark_runs.db")
    db_dir = os.path.dirname(db_path)
    if db_dir:
        os.makedirs(db_dir, exist_ok=True)

    branch, commit = _git_info()
    try:
        from vq_tpu_torch import __version__ as pkg_version
    except Exception:
        pkg_version = "dev"
    cli_command = " ".join(shlex.quote(a) for a in sys.argv)

    conn = sqlite3.connect(db_path)
    try:
        cur = conn.cursor()
        _ensure_schema(cur)
        cur.execute(
            """
            INSERT INTO runs (timestamp, git_branch, git_commit, package_version,
                              method, dataset, cli_command, metrics_json,
                              config_json, sweep_id, host_rank)
            VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)
            """,
            (
                datetime.now(timezone.utc).isoformat(),
                branch,
                commit,
                pkg_version,
                method,
                dataset,
                cli_command,
                json.dumps(_to_native(metrics)),
                json.dumps(_to_native(config)) if config else "{}",
                sweep_id,
                host_rank,
            ),
        )
        conn.commit()
    finally:
        conn.close()


def load_runs(
    db_path: Optional[str] = None, sweep_id: Optional[str] = None
) -> List[Dict[str, Any]]:
    """Read runs back as dicts with metrics/config JSON decoded (the
    reference's _load_runs_from_db, visualization/plot.py:122-157)."""
    if db_path is None:
        db_path = os.getenv("DB_PATH", "logs/benchmark_runs.db")
    conn = sqlite3.connect(db_path)
    conn.row_factory = sqlite3.Row
    try:
        cur = conn.cursor()
        if sweep_id:
            rows = cur.execute(
                "SELECT * FROM runs WHERE sweep_id = ? ORDER BY id", (sweep_id,)
            ).fetchall()
        else:
            rows = cur.execute("SELECT * FROM runs ORDER BY id").fetchall()
    finally:
        conn.close()
    out = []
    for r in rows:
        d = dict(r)
        d["metrics"] = json.loads(d.pop("metrics_json") or "{}")
        d["config"] = json.loads(d.pop("config_json") or "{}")
        out.append(d)
    return out
