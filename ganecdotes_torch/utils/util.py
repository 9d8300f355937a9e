"""Logging, config loading, seeding, the config CLI and the e-mail alert
(port of ganecdotes_tpu/utils/util.py)."""

import argparse
import importlib.util
import logging
import os
import random
import sys

import numpy as np
import torch


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


def seed_everything(seed=42):
    """Seed Python's, numpy's and torch's global generators with ``seed``
    (ref lib/util/util.py:21-28) and return a ``torch.Generator`` seeded
    alike, for the port's code, which draws from generators passed in."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def _parse_bool(s):
    """'true'/'false' and the usual spellings (``type=bool`` would read
    'False' as True)."""
    if isinstance(s, bool):
        return s
    if s.lower() in ("1", "true", "yes", "on"):
        return True
    if s.lower() in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {s!r}")


class ConfigLoader:
    """Every scalar attribute of a config file as a ``--<name>`` flag with
    the config's value as its default (ref lib/util/util.py:87-135);
    ``parse`` writes the parsed values back into the config module."""

    def __init__(self, config_path, config_name="config", description=""):
        self.config = load_config(config_path, config_name)
        self.parser = argparse.ArgumentParser(description=description)
        for key in dir(self.config):
            if key.startswith("__"):
                continue
            val = getattr(self.config, key)
            if isinstance(val, bool):
                self.parser.add_argument(f"--{key}", default=val,
                                         type=_parse_bool, required=False)
            elif isinstance(val, (int, float, str)):
                self.parser.add_argument(f"--{key}", default=val,
                                         type=type(val), required=False)

    def parse(self, argv=None):
        args, _ = self.parser.parse_known_args(argv)
        for key, val in vars(args).items():
            setattr(self.config, key, val)
        return self.config


def send_email_notification(body, pswd, receiver=None, sender=None,
                            subject="Email Auto-alert",
                            smtp_host="smtp.gmail.com", smtp_port=465):
    """Send a plain-text alert over SMTP with SSL (ref lib/util/util.py
    :224-259). The password is passed in, never stored; a missing address
    or an SMTP failure raises."""
    import smtplib
    import time
    from email.mime.multipart import MIMEMultipart
    from email.mime.text import MIMEText

    if not (sender and receiver):
        raise ValueError("send_email_notification requires sender and receiver")
    msg = MIMEMultipart()
    msg["From"] = sender
    msg["To"] = receiver
    msg["Subject"] = subject or ("ganecdotes alert: " + time.strftime(
        "%m-%d-%Y %H:%M:%S", time.localtime()))
    msg.attach(MIMEText(body))
    server = smtplib.SMTP_SSL(smtp_host, smtp_port)
    try:
        server.ehlo()
        server.login(sender, pswd)
        server.sendmail(sender, receiver, msg.as_string())
    finally:
        server.close()
