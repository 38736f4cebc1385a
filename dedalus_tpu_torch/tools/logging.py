"""
Logging setup (counterpart of dedalus_tpu/tools/logging.py).

Root logger configuration from the [logging] config section: a stdout
handler at `stdout_level`, plus an optional file handler at `file_level`
under `filename`.log.
"""

import atexit
import logging
import pathlib
import sys

from .config import config


def _resolve_level(name):
    name = (name or "none").lower()
    if name == "none":
        return None
    return getattr(logging, name.upper())


def _close_handlers(handlers):
    root = logging.getLogger("dedalus_tpu_torch")
    for handler in handlers:
        try:
            root.removeHandler(handler)
            handler.flush()
            handler.close()
        except Exception:
            pass


def setup_logging(force=False):
    """Configure the dedalus_tpu_torch root logger from config; idempotent."""
    root = logging.getLogger("dedalus_tpu_torch")
    if root.handlers and not force:
        return root
    section = config["logging"]
    stdout_level = _resolve_level(section.get("stdout_level", "info"))
    file_level = _resolve_level(section.get("file_level", "none"))
    formatter = logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s :: %(message)s")
    root.setLevel(logging.DEBUG)
    if stdout_level is not None:
        handler = logging.StreamHandler(sys.stdout)
        handler.setLevel(stdout_level)
        handler.setFormatter(formatter)
        root.addHandler(handler)
    if file_level is not None:
        path = pathlib.Path(section.get("filename", "logs/dedalus_tpu_torch"))
        path.parent.mkdir(parents=True, exist_ok=True)
        handler = logging.FileHandler(f"{path}.log")
        handler.setLevel(file_level)
        handler.setFormatter(formatter)
        root.addHandler(handler)
        atexit.register(_close_handlers, [handler])
    return root
