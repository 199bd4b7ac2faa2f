"""Twin of ``__graft_entry__.entry()``: the port's flagship step and a batch.

``entry()`` returns ``(fn, example_args)``: the batched ed25519 verify and
a deterministic 256-row batch signed with the port's pure-Python signer
(44-byte messages, the width of a transaction signature's signable
payload). ``fn(*example_args)`` runs on the card; pass ``device="cpu"``
for the plain versions.
"""

from __future__ import annotations

import hashlib

from .crypto import ed25519_host
from .ops.ed25519 import ed25519_verify_batch


def example_batch(b: int) -> tuple[list, list, list]:
    pks, sigs, msgs = [], [], []
    for i in range(b):
        seed = hashlib.sha256(b"graft-entry" + i.to_bytes(4, "little")).digest()
        msg = b"CTSG" + hashlib.sha256(seed).digest() + bytes(8)
        pks.append(ed25519_host.public_from_seed(seed))
        sigs.append(ed25519_host.sign(seed, msg))
        msgs.append(msg)
    return pks, sigs, msgs


def entry():
    """(fn, example_args) for one 256-row batch."""
    return ed25519_verify_batch, example_batch(256)
