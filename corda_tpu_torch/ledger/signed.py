"""SignedTransaction: a wire transaction plus signatures over its id (copy of
corda_tpu/ledger/signed.py).

Capability parity with the reference's ``SignedTransaction``
(core/.../transactions/SignedTransaction.kt:37-209) and
``TransactionWithSignatures`` (TransactionWithSignatures.kt:29-63):
signature-set validation (every sig cryptographically valid) is separated
from signer-set validation (the required keys are all covered, with
composite-key fulfilment and an allowed-to-be-missing set for notary /
partially-signed protocol steps).

The per-signature crypto check is host-loop here; the bulk path routes the
(key, sig, signable) triples of many transactions into one batch on the
card through ``verifier/batch.py``: ``signature_triples()`` is that feed.
"""

from __future__ import annotations

import dataclasses

from ..crypto import (
    PublicKey,
    SecureHash,
    TransactionSignature,
    is_fulfilled_by,
)
from ..serialization import deserialize, register_custom, serialize

from .states import TransactionVerificationException
from .wire import WireTransaction


class SignatureException(Exception):
    pass


class SignaturesMissingException(SignatureException):
    def __init__(self, missing: set, tx_id):
        self.missing = missing
        self.tx_id = tx_id
        super().__init__(
            f"missing signatures for {len(missing)} key(s) on tx {tx_id}"
        )


@dataclasses.dataclass(frozen=True)
class SignedTransaction:
    """wire bytes + signatures; id is derived from the bytes, so a signature
    always covers exactly what travels (reference stores SerializedBytes the
    same way, SignedTransaction.kt:37-55)."""

    tx_bits: bytes
    sigs: tuple  # tuple[TransactionSignature, ...]

    def __post_init__(self):
        if not self.sigs:
            raise ValueError("tried to build a SignedTransaction without signatures")

    @staticmethod
    def create(wtx: WireTransaction, sigs: list[TransactionSignature]) -> "SignedTransaction":
        return SignedTransaction(serialize(wtx), tuple(sigs))

    @property
    def tx(self) -> WireTransaction:
        cached = self.__dict__.get("_tx")
        if cached is None:
            cached = deserialize(self.tx_bits)
            if not isinstance(cached, WireTransaction):
                raise TransactionVerificationException(
                    None, "tx_bits does not decode to a WireTransaction"
                )
            self.__dict__["_tx"] = cached
        return cached

    @property
    def id(self) -> SecureHash:
        return self.tx.id

    @property
    def notary(self):
        return self.tx.notary

    @property
    def inputs(self):
        return self.tx.inputs

    @property
    def required_signing_keys(self) -> set:
        return self.tx.required_signing_keys | (
            {self.tx.notary.owning_key} if self.tx.notary and self.tx.inputs else set()
        )

    # ------------------------------------------------------------- checks
    def check_signatures_are_valid(self) -> None:
        """Every attached signature must verify over the id (reference:
        TransactionWithSignatures.checkSignaturesAreValid, :63)."""
        for sig in self.sigs:
            sig.verify(self.id)

    def get_missing_signers(self) -> set:
        """Required keys not fulfilled by present signatures (composite keys
        count as fulfilled when their threshold is met)."""
        signed_by = {s.by for s in self.sigs}
        return {
            k
            for k in self.required_signing_keys
            if not is_fulfilled_by(k, signed_by)
        }

    def verify_required_signatures(self) -> None:
        self.verify_signatures_except(set())

    def verify_signatures_except(self, allowed_missing: set) -> None:
        """Reference: verifySignaturesExcept (SignedTransaction.kt:118-134) —
        all sigs valid AND every required key outside ``allowed_missing``
        covered."""
        self.check_signatures_are_valid()
        missing = self.get_missing_signers() - set(allowed_missing)
        if missing:
            raise SignaturesMissingException(missing, self.id)

    # ------------------------------------------------------------- builders
    def plus(self, extra: "list[TransactionSignature]") -> "SignedTransaction":
        return dataclasses.replace(self, sigs=self.sigs + tuple(extra))

    def with_additional_signature(self, sig: TransactionSignature) -> "SignedTransaction":
        return self.plus([sig])

    # ------------------------------------------------------------- batch feed
    def signature_triples(self) -> list[tuple[PublicKey, bytes, bytes]]:
        """(key, signature, signable-bytes) rows for bucketed device
        dispatch; the signable payload binds id + scheme + platform version
        (crypto/signatures.py)."""
        tid = self.id
        return [(s.by, s.signature, s.signable_for(tid)) for s in self.sigs]

    def __str__(self):
        return f"SignedTransaction({self.id}, {len(self.sigs)} sigs)"


register_custom(
    SignedTransaction, "ledger.SignedTransaction",
    to_fields=lambda s: {"tx_bits": s.tx_bits, "sigs": list(s.sigs)},
    from_fields=lambda d: SignedTransaction(d["tx_bits"], tuple(d["sigs"])),
)
