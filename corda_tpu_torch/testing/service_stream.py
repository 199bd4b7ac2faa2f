"""Seeded traffic for the verifier service (``verifier/service.py``).

``service_stream(n)`` builds ``n`` signed Cash moves with a state
resolver over the issue they spend, the ``allowed_missing`` set of each
(the notary's key, which signs later), and the outcome each must come to
(the oracle, from construction):

- about three quarters single-signer ed25519 moves;
- an eighth owned by composite keys: AND over an ed25519 and a secp256k1
  leaf, 2-of-3 over two ed25519 leaves and a secp256k1 one, and a nested
  weighted tree (an ed25519 leaf of weight 2, an OR of an ed25519 and a
  secp256k1 leaf, an ed25519 leaf; threshold 3), each signed by a
  rotating set of leaves that fulfils it;
- a few each of SPHINCS and BLS signers;
- single-signer ECDSA moves for the rest, secp256k1 and secp256r1 in
  equal numbers, as the reference's mixed-scheme shape has them
  (``MIXED_COMPOSITION`` in bench.py: 512 rows of each curve);
- moves whose contract (``ATTACHED_CASH``) is carried as attachment
  source in an in-memory ``AttachmentStore``, their states pinned to its
  hash by a ``HashAttachmentConstraint``;
- one transaction of each of ``SERVICE_KINDS`` at known positions.

The ed25519 signatures are made in one ``ed25519_sign_batch`` on
``device`` (the card unless ``device="cpu"``), over ids computed by
``compute_tx_ids`` there; every id cache is left cold. The others are
signed on the host. ``service_outcome`` names what a future came to, in
either package, so that two runs compare transaction for transaction.
"""

from __future__ import annotations

import dataclasses
import hashlib
import random

from .generated_ledger import sign_tx_ids

# (kind, the exception its future must fail with), in stream order
SERVICE_KINDS = (
    ("composite_threshold_short", "SignaturesMissingException"),
    ("forged_leaf_signature", "InvalidSignatureError"),
    ("bls_wrong_message", "InvalidSignatureError"),
    ("hostile_attachment", "TransactionVerificationException"),
    ("hash_constraint_broken", "TransactionVerificationException"),
    ("composite_as_signer", "CryptoError"),
    ("unknown_contract", "TransactionVerificationException"),
)

ATTACHED_CASH = "attached.Cash"

# the counterparty's contract, carried as attachment source and never
# registered: conserved positive amounts, input owners among the signers
ATTACHED_CASH_SOURCE = b'''
class AttachedCash:
    def verify(self, tx):
        ins = tx.input_states()
        outs = tx.output_states()
        if not outs:
            raise ValueError("an attached-cash transaction must create outputs")
        for s in outs:
            if s.amount.quantity <= 0:
                raise ValueError("amounts must be positive")
        if ins and sum(s.amount.quantity for s in ins) != sum(
                s.amount.quantity for s in outs):
            raise ValueError("value not conserved")
        signers = set()
        for c in tx.commands:
            for k in c.signers:
                signers.add(k)
        for s in ins:
            if s.owner.owning_key not in signers:
                raise ValueError("input owners must sign")

CONTRACTS = {"attached.Cash": AttachedCash}
'''
# the same name over code that accepts anything: a state pinned to the
# honest code's hash must refuse it
ROGUE_CASH_SOURCE = (b"class AttachedCash:\n    def verify(self, tx):\n        pass\n"
                     b'CONTRACTS = {"attached.Cash": AttachedCash}\n')
# a contract the restriction gate refuses (an import)
HOSTILE_SOURCE = (b"import os\nclass Hostile:\n    def verify(self, tx):\n        pass\n"
                  b'CONTRACTS = {"attached.Hostile": Hostile}\n')


class AttachmentStore:
    """Content-addressed attachment blobs in memory. ``get`` is the
    fetcher ``attachment_code.set_attachment_fetcher`` takes; it reads
    the raw hash, so one store serves either package's ``SecureHash``."""

    def __init__(self):
        self._blobs: dict[bytes, bytes] = {}

    def put(self, data: bytes):
        from ..crypto import sha256

        h = sha256(data)
        self._blobs[h.bytes] = data
        return h

    def get(self, att_hash):
        return self._blobs.get(att_hash.bytes)


def service_outcome(result):
    """What one verification came to: None, or the exception's type name
    and its failing keys as (scheme id, encoded) pairs (the signer of an
    invalid signature, the unfulfilled keys of a missing-signature error,
    none otherwise). Either package's exceptions read the same."""
    if result is None:
        return None
    if hasattr(result, "missing"):
        keys = result.missing
    elif hasattr(result, "sig"):
        keys = {result.sig.by}
    else:
        keys = ()
    return (type(result).__name__,
            frozenset((k.scheme_id, bytes(k.encoded)) for k in keys))


def future_outcome(fut, timeout: float = 600.0):
    """``service_outcome`` of a verifier future."""
    err = fut.exception(timeout=timeout)
    return service_outcome(err)


@dataclasses.dataclass
class ServiceStream:
    """The transactions, each one's kind, ``allowed_missing`` set and
    expected outcome (``service_outcome``'s form), the resolver over the
    issue they spend, the attachment store their attached contracts come
    from, and the wire transactions behind the resolver."""

    stxs: list
    kinds: list
    allowed: list
    expected: list
    resolve: object
    store: AttachmentStore
    issue: object           # WireTransaction
    notary: object          # Party


def _keypair(scheme_id: int, tag: bytes, seed: int):
    from ..crypto import derive_keypair_from_entropy

    return derive_keypair_from_entropy(
        scheme_id, hashlib.sha256(tag + seed.to_bytes(8, "big")).digest())


def _counts(n: int, sphincs: int, bls: int, attachments: int) -> dict:
    composite = n // 8
    counts = {
        "composite_and": composite - 2 * (composite // 3),
        "composite_2of3": composite // 3,
        "composite_nested": composite // 3,
        "sphincs": sphincs, "bls": bls, "attachment": attachments,
    }
    left = n - sum(counts.values()) - len(SERVICE_KINDS)
    if left < 0:
        raise ValueError(f"{n} transactions cannot hold this mix")
    counts["ed25519"] = min(n * 3 // 4, left - left // 8)
    ecdsa = left - counts["ed25519"]
    counts["secp256r1"] = ecdsa // 2
    counts["secp256k1"] = ecdsa - counts["secp256r1"]
    return counts


def service_stream(n: int, *, seed: int = 0, device=None, sphincs: int = 4, bls: int = 2,
                   attachments: int = 32) -> ServiceStream:
    """``n`` moves of the mix above (``sphincs``, ``bls`` and
    ``attachments`` of those kinds, the adversarial kinds included in
    ``n``), from ``seed``; see the module docstring."""
    from ..crypto import (
        BLS_BLS12381,
        COMPOSITE_KEY,
        ECDSA_SECP256K1_SHA256,
        ECDSA_SECP256R1_SHA256,
        EDDSA_ED25519_SHA512,
        SPHINCS256_SHA256,
        CompositeKeyBuilder,
        SignatureMetadata,
        TransactionSignature,
        sign_tx_id,
    )
    from ..finance import CASH_PROGRAM_ID, CashState, Issue, Move
    from ..ledger import (
        Amount,
        AnonymousParty,
        CordaX500Name,
        HashAttachmentConstraint,
        Issued,
        Party,
        PartyAndReference,
        PrivacySalt,
        SignedTransaction,
        TransactionBuilder,
    )
    from ..ops.txid import compute_tx_ids
    from . import _party, state_resolver

    rng = random.Random(seed)
    alice, akp = _party(b"Service Alice")
    bob, _bkp = _party(b"Service Bob")
    notary, _nkp = _party(b"Service Notary")
    token = Issued(PartyAndReference(alice, b"\x05"), "GBP")
    ed = [_keypair(EDDSA_ED25519_SHA512, b"leaf-ed%d" % i, seed) for i in range(6)]
    k1 = [_keypair(ECDSA_SECP256K1_SHA256, b"leaf-k1%d" % i, seed) for i in range(3)]
    trees = {
        "composite_and": CompositeKeyBuilder().add(ed[0].public).add(k1[0].public).build(),
        "composite_2of3": CompositeKeyBuilder().add(ed[1].public).add(ed[2].public)
        .add(k1[1].public).build(2),
    }
    inner = CompositeKeyBuilder().add(ed[3].public).add(k1[2].public).build(1)
    trees["composite_nested"] = (CompositeKeyBuilder().add(ed[4].public, 2).add(inner)
                                 .add(ed[5].public).build(3))
    leaf_sets = {
        "composite_and": [(ed[0], k1[0])],
        "composite_2of3": [(ed[1], ed[2]), (ed[1], k1[1]), (ed[2], k1[1])],
        "composite_nested": [(ed[4], k1[2]), (ed[4], ed[3]), (ed[4], ed[5])],
    }
    owner_kp = {
        "secp256k1": _keypair(ECDSA_SECP256K1_SHA256, b"single-k1", seed),
        "secp256r1": _keypair(ECDSA_SECP256R1_SHA256, b"single-r1", seed),
        "bls": _keypair(BLS_BLS12381, b"single-bls", seed),
    }
    if sphincs:
        owner_kp["sphincs"] = _keypair(SPHINCS256_SHA256, b"single-sphincs", seed)

    store = AttachmentStore()
    honest = store.put(ATTACHED_CASH_SOURCE)
    rogue = store.put(ROGUE_CASH_SOURCE)
    hostile = store.put(HOSTILE_SOURCE)

    counts = _counts(n, sphincs, bls, attachments)
    kinds = [k for k, c in counts.items() for _ in range(c)]
    rng.shuffle(kinds)
    for j, (name, _err) in enumerate(SERVICE_KINDS):
        kinds.insert((j + 1) * n // (len(SERVICE_KINDS) + 1), name)

    def owner_of(kind):
        if kind in trees or kind == "composite_threshold_short":
            return AnonymousParty(trees.get(kind, trees["composite_2of3"]).to_public_key())
        if kind == "forged_leaf_signature":
            return AnonymousParty(trees["composite_and"].to_public_key())
        base = "bls" if kind == "bls_wrong_message" else kind
        if base in owner_kp:
            return Party(CordaX500Name(f"Service {base}", "London", "GB"),
                         owner_kp[base].public)
        return alice

    def contract_of(kind):
        return {"attachment": (ATTACHED_CASH, HashAttachmentConstraint(honest)),
                "hash_constraint_broken": (ATTACHED_CASH, HashAttachmentConstraint(honest)),
                "hostile_attachment": ("attached.Hostile", None),
                "unknown_contract": ("attached.Missing", None)}.get(kind, (CASH_PROGRAM_ID, None))

    def builder():
        b = TransactionBuilder(notary=notary)
        b.set_privacy_salt(PrivacySalt(rng.randbytes(32)))
        return b

    ib = builder()
    for i, kind in enumerate(kinds):
        contract, constraint = contract_of(kind)
        ib.add_output_state(CashState(Amount(100 + i, token), owner_of(kind)), contract,
                            constraint=constraint)
    ib.add_command(Issue(), alice.owning_key)
    issue = ib.to_wire_transaction()

    wtxs = []
    for i, kind in enumerate(kinds):
        owner = owner_of(kind)
        contract, constraint = contract_of(kind)
        mb = builder()
        mb.add_input_state(issue.out_ref(i))
        mb.add_output_state(CashState(Amount(100 + i, token), bob), contract,
                            constraint=constraint)
        mb.add_command(Move(), owner.owning_key)
        carried = {"attachment": honest, "hash_constraint_broken": rogue,
                   "hostile_attachment": hostile}.get(kind)
        if carried is not None:
            mb.add_attachment(carried)
        wtxs.append(mb.to_wire_transaction())
    ids = compute_tx_ids(wtxs, device=device)

    # who signs each move: ed25519 jobs in one batch, the rest on the host
    signers: list[list] = []
    for i, kind in enumerate(kinds):
        if kind in leaf_sets:
            sets = leaf_sets[kind]
            signers.append(list(sets[i % len(sets)]))
        elif kind == "composite_threshold_short":
            signers.append([ed[1]])
        elif kind == "forged_leaf_signature":
            signers.append([ed[0], k1[0]])
        elif kind in owner_kp:
            signers.append([owner_kp[kind]])
        elif kind == "bls_wrong_message":
            signers.append([owner_kp["bls"]])
        else:
            signers.append([akp])
    jobs = [(kp, ids[i]) for i, kps in enumerate(signers) for kp in kps
            if kp.public.scheme_id == EDDSA_ED25519_SHA512]
    ed_sigs = iter(sign_tx_ids(jobs, device))
    stxs, expected, allowed = [], [], []
    for i, (kind, kps) in enumerate(zip(kinds, signers)):
        sigs = []
        for kp in kps:
            if kp.public.scheme_id == EDDSA_ED25519_SHA512:
                sigs.append(next(ed_sigs))
            elif kind == "bls_wrong_message":
                sigs.append(sign_tx_id(kp.private, kp.public, ids[i - 1]))
            else:
                sigs.append(sign_tx_id(kp.private, kp.public, ids[i]))
        if kind == "forged_leaf_signature":
            s = sigs[0]
            sigs[0] = dataclasses.replace(
                s, signature=s.signature[:9] + bytes([s.signature[9] ^ 4]) + s.signature[10:])
        if kind == "composite_as_signer":
            ck = trees["composite_and"].to_public_key()
            sigs.append(TransactionSignature(bytes(64), ck,
                                             SignatureMetadata(1, COMPOSITE_KEY)))
        stxs.append(SignedTransaction.create(wtxs[i], sigs))
        allowed.append({notary.owning_key})
        err = dict(SERVICE_KINDS).get(kind)
        keys = {
            "composite_threshold_short": trees["composite_2of3"].to_public_key(),
            "forged_leaf_signature": ed[0].public,
            "bls_wrong_message": owner_kp["bls"].public,
        }.get(kind)
        expected.append(None if err is None else (
            err, frozenset() if keys is None else frozenset({(keys.scheme_id, keys.encoded)})))
    return ServiceStream(stxs=stxs, kinds=kinds, allowed=allowed, expected=expected,
                         resolve=state_resolver(issue), store=store, issue=issue,
                         notary=notary)
