"""Twin of ``__graft_entry__.entry()``: the port's flagship step and a batch.

``entry()`` returns ``(fn, example_args)``: the batched ed25519 verify and
a deterministic 256-row batch signed with the port's pure-Python signer
(44-byte messages, the width of a transaction signature's signable
payload). ``fn(*example_args)`` runs on the card; pass ``device="cpu"``
for the plain versions. ``entry(tier)`` binds an ``Ed25519Tier``: kernel B's
16-entry window with ``Ed25519Tier(8192, 4)``, kernel G with
``Ed25519Tier(4096, 8)`` or ``Ed25519Tier(4096, 4)``.
"""

from __future__ import annotations

import functools
import hashlib

from .crypto import ed25519_host
from .ops.ed25519 import Ed25519Tier, ed25519_verify_batch


def example_batch(b: int) -> tuple[list, list, list]:
    pks, sigs, msgs = [], [], []
    for i in range(b):
        seed = hashlib.sha256(b"graft-entry" + i.to_bytes(4, "little")).digest()
        msg = b"CTSG" + hashlib.sha256(seed).digest() + bytes(8)
        pks.append(ed25519_host.public_from_seed(seed))
        sigs.append(ed25519_host.sign(seed, msg))
        msgs.append(msg)
    return pks, sigs, msgs


def entry(tier: Ed25519Tier | None = None):
    """(fn, example_args) for one 256-row batch, verified with the ladder
    of ``tier`` (the default tier when None)."""
    fn = ed25519_verify_batch if tier is None else functools.partial(
        ed25519_verify_batch, tier=tier)
    return fn, example_batch(256)
