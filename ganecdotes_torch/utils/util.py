"""Logging and config loading (port of ganecdotes_tpu/utils/util.py
``get_logger`` and ``load_config``)."""

import importlib.util
import logging
import os
import sys


def get_logger(name, logfile=None, level=logging.INFO):
    """Logger with a stdout handler and an optional file handler; calling it
    again replaces the handlers rather than adding more."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    logger.handlers = []
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if logfile is not None:
        os.makedirs(os.path.dirname(os.path.abspath(logfile)), exist_ok=True)
        fh = logging.FileHandler(logfile)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def load_config(config_path, config_name="config"):
    """Execute a python config file and return it as a module: its
    attributes are the hyperparameters."""
    spec = importlib.util.spec_from_file_location(config_name, config_path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
