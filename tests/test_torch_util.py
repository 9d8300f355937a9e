"""The port's utils/util.py against the JAX package's: seeding, the config
CLI and the e-mail alert (a fake SMTP class; nothing leaves the process)."""

import random
import smtplib

import numpy as np
import pytest
import torch

from ganecdotes_tpu.utils import util as jutil
from ganecdotes_torch.utils import util as tutil

CONFIG = """
lr = 0.002
batch_size = 8
name = 'baggan'
augment = True
res2chlmap = {4: 16}
"""


def test_seed_everything_seeds_python_numpy_and_torch():
    g = tutil.seed_everything(7)
    ours = (random.random(), np.random.rand(), torch.rand(()).item())
    jutil.seed_everything(7)
    assert (random.random(), np.random.rand()) == ours[:2]  # the same streams
    tutil.seed_everything(7)
    assert torch.rand(()).item() == ours[2]
    assert isinstance(g, torch.Generator)
    assert torch.equal(torch.rand(3, generator=g),
                       torch.rand(3, generator=torch.Generator().manual_seed(7)))


@pytest.mark.parametrize("argv", [
    [],
    ["--lr", "0.01", "--batch_size", "4", "--name", "x", "--augment", "false"],
    ["--augment", "yes", "--unknown", "1"],
])
def test_config_loader_flags_match_jax(tmp_path, argv):
    path = tmp_path / "cfg.py"
    path.write_text(CONFIG)
    ours = tutil.ConfigLoader(str(path)).parse(argv)
    theirs = jutil.ConfigLoader(str(path)).parse(argv)
    for key in ("lr", "batch_size", "name", "augment", "res2chlmap"):
        assert getattr(ours, key) == getattr(theirs, key), key
        assert type(getattr(ours, key)) is type(getattr(theirs, key)), key
    with pytest.raises(SystemExit):
        tutil.ConfigLoader(str(path)).parse(["--augment", "maybe"])


class _FakeSMTP:
    sent = []

    def __init__(self, host, port):
        self.log = [("connect", host, port)]

    def ehlo(self):
        self.log.append(("ehlo",))

    def login(self, user, pswd):
        self.log.append(("login", user, pswd))

    def sendmail(self, sender, receiver, text):
        self.log.append(("sendmail", sender, receiver))
        self.text = text

    def close(self):
        self.log.append(("close",))
        _FakeSMTP.sent.append(self)


def test_send_email_notification_matches_jax(monkeypatch):
    monkeypatch.setattr(smtplib, "SMTP_SSL", _FakeSMTP)
    kw = dict(receiver="to@example.com", sender="from@example.com",
              subject="done", smtp_host="smtp.example.com", smtp_port=2465)
    tutil.send_email_notification("run finished", "pw", **kw)
    jutil.send_email_notification("run finished", "pw", **kw)
    ours, theirs = _FakeSMTP.sent[-2:]
    assert ours.log == theirs.log == [
        ("connect", "smtp.example.com", 2465), ("ehlo",),
        ("login", "from@example.com", "pw"),
        ("sendmail", "from@example.com", "to@example.com"), ("close",)]
    for fake in (ours, theirs):
        assert "Subject: done" in fake.text and "run finished" in fake.text
    with pytest.raises(ValueError, match="sender and receiver"):
        tutil.send_email_notification("x", "pw", receiver="to@example.com")
