"""Structured logging setup: text or JSON formats over stdlib logging
(reference: pkg/logging/log.go — logr over zap/klog, the
``loggingFormat`` flag in cmd/internal/flag.go:35)."""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Dict

FORMAT_TEXT = 'text'
FORMAT_JSON = 'json'


class JSONFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out: Dict[str, Any] = {
            'ts': time.strftime('%Y-%m-%dT%H:%M:%SZ',
                                time.gmtime(record.created)),
            'level': record.levelname.lower(),
            'logger': record.name,
            'msg': record.getMessage(),
        }
        extra = getattr(record, 'kv', None)
        if extra:
            out.update(extra)
        if record.exc_info:
            out['error'] = self.formatException(record.exc_info)
        return json.dumps(out)


def setup(fmt: str = FORMAT_TEXT, level: int = logging.INFO
          ) -> logging.Logger:
    root = logging.getLogger('kyverno')
    root.setLevel(level)
    root.handlers = []
    handler = logging.StreamHandler(sys.stderr)
    if fmt == FORMAT_JSON:
        handler.setFormatter(JSONFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            '%(asctime)s %(levelname)s %(name)s %(message)s'))
    root.addHandler(handler)
    return root


def with_values(logger: logging.Logger, msg: str, level: int = logging.INFO,
                **kv) -> None:
    """logr-style key/value logging."""
    logger.log(level, msg, extra={'kv': kv})
