"""Faults planted under a serving cell's timed path (``control.py
--fault``, and the CPU tests): each wraps the call into the server, and a
run with one of them has to come out not correct. A serving cell runs on
one card and carries no state from request to request, so a step that
returns its state unchanged and a lost exchange between cards have no
place here."""

import torch


def half_batch(serve):
    """Half of the batch left out: the rest served twice."""
    def broken(z):
        h = z.shape[0] // 2
        img, labels, z0 = serve(z[:h])
        n = z.shape[0] - h
        return torch.cat([img, img[:n]]), torch.cat([labels, labels[:n]]), z0
    return broken


def image_altered(serve):
    """One pixel of the last image moved by the image's largest value."""
    def broken(z):
        img, labels, z0 = serve(z)
        img = img.clone()
        img[-1, 3, 5] += img.abs().max()
        return img, labels, z0
    return broken


def labels_altered(serve):
    """The last image's labels shifted by one class."""
    def broken(z):
        img, labels, z0 = serve(z)
        labels = labels.clone()
        labels[-1] = (labels[-1] + 1) % 12
        return img, labels, z0
    return broken


def z0_altered(serve):
    """The cluster map shifted by one cluster."""
    def broken(z):
        img, labels, z0 = serve(z)
        return img, labels, (z0 + 1) % 16
    return broken


FAULTS = {f.__name__: f for f in (half_batch, image_altered, labels_altered,
                                  z0_altered)}
