"""Structured logging for the I/O planes, replacing the ad-hoc
``HYDRABADGER_LOG`` parsing that lived in ``__main__``.

Still stdlib ``logging`` underneath — per-module level filters
(``HYDRABADGER_LOG=hydrabadger_tpu_torch.net=debug``), the reference's
env_logger aliases (``trace``/``off``/``warn``) and the one-letter
level format are all preserved — but the plane gains two structured
capabilities:

  * ``get_logger(name)`` returns a logger whose records accept
    ``extra={"obs": {...}}`` key-value payloads rendered as trailing
    ``key=value`` pairs — grep-able structure without a JSON dependency;
  * :func:`attach_recorder` mirrors warning+ records into a
    :class:`~..obs.recorder.Recorder` as instant ``log`` events
    (level, logger, rendered message), so a ``--trace`` dump interleaves
    the warnings with the spans they explain.  Records are stamped by
    the handler (logging IS an I/O boundary), not by consensus code.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
_ALIASES = {"TRACE": "DEBUG", "OFF": "CRITICAL", "WARN": "WARNING"}


class StructuredFormatter(logging.Formatter):
    """Base format plus trailing ``key=value`` pairs from
    ``extra={"obs": {...}}``."""

    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        fields = getattr(record, "obs", None)
        if fields:
            pairs = " ".join(f"{k}={v}" for k, v in sorted(fields.items()))
            return f"{base} [{pairs}]"
        return base


def resolve_level(name: str) -> int:
    """env_logger level names -> stdlib levels (unknown -> INFO)."""
    name = _ALIASES.get(name.upper(), name.upper())
    level = logging.getLevelName(name)
    return level if isinstance(level, int) else logging.INFO


def setup_from_env(default: str = "info", stream=None) -> None:
    """Configure root logging from ``HYDRABADGER_LOG``: either a bare
    level or comma-separated ``module=level`` filters (the reference's
    env_logger recipe, gdb-node:27)."""
    spec = os.environ.get("HYDRABADGER_LOG", default)
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(StructuredFormatter(_FORMAT))
    root = logging.getLogger()
    root.handlers = [handler]
    root.setLevel(logging.WARNING)
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        if "=" in clause:
            mod, _, level = clause.partition("=")
            logging.getLogger(mod).setLevel(resolve_level(level))
        else:
            root.setLevel(resolve_level(clause))


def get_logger(name: str) -> logging.Logger:
    """The structured logger for one module; a plain stdlib logger, so
    all HYDRABADGER_LOG filters keep working."""
    return logging.getLogger(name)


class _RecorderHandler(logging.Handler):
    def __init__(self, recorder, level: int):
        super().__init__(level)
        self._recorder = recorder

    def emit(self, record: logging.LogRecord) -> None:
        try:
            # logging is an I/O boundary with its own moment: the event
            # goes straight into the stamped ring on the RECORDER'S
            # clock (its declared domain, incl. any injected node
            # skew).  Routing through stamp() here would flush the
            # consensus cores' pending events early with the log
            # record's time — and on the wrong clock domain when the
            # recorder stamps perf_counter (sim/router.py).
            self._recorder.emit_stamped(
                "log",
                None,
                level=record.levelname,
                logger=record.name,
                message=record.getMessage(),
            )
        except Exception:  # pragma: no cover - never break the app on obs
            pass


def attach_recorder(
    recorder, level: int = logging.WARNING, logger_name: str = "hydrabadger_tpu_torch"
) -> Optional[logging.Handler]:
    """Mirror ``level``+ records under ``logger_name`` into ``recorder``
    as instant events; returns the handler (detach by removing it)."""
    if recorder is None or not getattr(recorder, "enabled", False):
        return None
    handler = _RecorderHandler(recorder, level)
    logging.getLogger(logger_name).addHandler(handler)
    return handler
