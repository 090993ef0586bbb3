"""Structured logging, the TPU-side stand-in for HPS_TRITON_LOG
(reference hps_backend/include/triton_common.hpp:37-44)."""

from __future__ import annotations

import logging
import os
import sys
import threading

_CONFIGURED = False
_CONFIG_LOCK = threading.Lock()


def get_logger(name: str = "hps_tpu") -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        with _CONFIG_LOCK:  # two frontends starting concurrently must not
            if not _CONFIGURED:  # each add a handler (duplicated lines)
                level = os.environ.get("HPS_TPU_LOG_LEVEL", "INFO").upper()
                if level not in logging._nameToLevel:
                    # A typo'd level must not crash every import in the
                    # package (get_logger runs at module top level).
                    print(
                        f"hps_tpu: unknown HPS_TPU_LOG_LEVEL {level!r}; "
                        "using INFO", file=sys.stderr,
                    )
                    level = "INFO"
                h = logging.StreamHandler(sys.stderr)
                h.setFormatter(
                    logging.Formatter(
                        "%(asctime)s %(levelname).1s %(name)s: %(message)s",
                        "%H:%M:%S",
                    )
                )
                root = logging.getLogger("hps_tpu")
                root.addHandler(h)
                root.setLevel(level)
                # Keep our lines out of the root logger: an app that
                # configures root (pytest, absl) would double-print
                # everything otherwise.
                root.propagate = False
                _CONFIGURED = True
    return logging.getLogger(name)
