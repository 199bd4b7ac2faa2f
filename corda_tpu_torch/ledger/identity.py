"""Identity model: X.500 names, parties, anonymous parties (copy of corda_tpu/ledger/identity.py).

Capability parity with the reference's identity layer (core/.../identity/:
``CordaX500Name``, ``Party``, ``AnonymousParty``, ``AbstractParty``,
``PartyAndCertificate``). Certificates here are a lightweight signed
name→key binding rather than full X.509 (the JCA/PKI machinery is a JVM
idiom, not a capability): a certificate chain rooted in a network trust root
still proves the same thing — that a well-known identity vouches for a key.
"""

from __future__ import annotations

import dataclasses

from ..crypto import PublicKey, sign as _sign, is_valid as _is_valid
from ..crypto.keys import PrivateKey
from ..serialization import register_custom

_MANDATORY = ("organisation", "locality", "country")
# ISO 3166-1 alpha-2 subset + reference's pseudo-country codes
_COUNTRIES = None  # lazily built full alpha-2 set


def _country_ok(c: str) -> bool:
    return len(c) == 2 and c.isalpha() and c.isupper() or c in ("ZZ",)


@dataclasses.dataclass(frozen=True, order=True)
class CordaX500Name:
    """Validated X.500-style legal name (reference: CordaX500Name.kt).

    Attribute support: O (organisation), L (locality), C (country) mandatory;
    OU (organisationUnit), CN (commonName), ST (state) optional — same
    attribute set and length limits as the reference.
    """

    organisation: str
    locality: str
    country: str
    organisation_unit: str | None = None
    common_name: str | None = None
    state: str | None = None

    _MAX = {
        "organisation": 128, "locality": 64, "country": 2,
        "organisation_unit": 64, "common_name": 64, "state": 64,
    }

    def __post_init__(self):
        for field, limit in self._MAX.items():
            v = getattr(self, field)
            if v is None:
                continue
            if not isinstance(v, str) or not v or len(v) > limit:
                raise ValueError(f"{field} must be a non-empty string ≤ {limit} chars")
            if any(ord(ch) < 0x20 or ch in ',=$"\\' for ch in v):
                raise ValueError(f"{field} contains forbidden characters: {v!r}")
        if not _country_ok(self.country):
            raise ValueError(f"invalid country code {self.country!r}")

    def __str__(self) -> str:
        parts = []
        if self.common_name:
            parts.append(f"CN={self.common_name}")
        if self.organisation_unit:
            parts.append(f"OU={self.organisation_unit}")
        parts.append(f"O={self.organisation}")
        parts.append(f"L={self.locality}")
        if self.state:
            parts.append(f"ST={self.state}")
        parts.append(f"C={self.country}")
        return ", ".join(parts)

    @staticmethod
    def parse(s: str) -> "CordaX500Name":
        kv: dict[str, str] = {}
        for part in s.split(","):
            if "=" not in part:
                raise ValueError(f"malformed X.500 name component {part!r}")
            k, v = part.split("=", 1)
            kv[k.strip().upper()] = v.strip()
        mapping = {"O": "organisation", "L": "locality", "C": "country",
                   "OU": "organisation_unit", "CN": "common_name", "ST": "state"}
        kwargs = {}
        for k, v in kv.items():
            if k not in mapping:
                raise ValueError(f"unsupported X.500 attribute {k}")
            kwargs[mapping[k]] = v
        return CordaX500Name(**kwargs)


@dataclasses.dataclass(frozen=True)
class AnonymousParty:
    """A party known only by key (confidential identities)."""

    owning_key: PublicKey

    def __str__(self) -> str:
        return f"Anonymous({self.owning_key.to_string_short()})"


@dataclasses.dataclass(frozen=True)
class Party:
    """A well-known party: legal name + owning key (reference: Party.kt)."""

    name: CordaX500Name
    owning_key: PublicKey

    def anonymise(self) -> AnonymousParty:
        return AnonymousParty(self.owning_key)

    def __str__(self) -> str:
        return str(self.name)


AbstractParty = Party | AnonymousParty


@dataclasses.dataclass(frozen=True)
class NameKeyCertificate:
    """Signed binding of (name, key) by an issuer key — the capability core
    of the reference's PartyAndCertificate X.509 path without JCA PKI."""

    name: CordaX500Name
    subject_key: PublicKey
    issuer_key: PublicKey
    signature: bytes

    def _payload(self) -> bytes:
        from ..serialization import encode

        return b"CTCERT" + encode(
            {"name": str(self.name), "key": self.subject_key}
        )

    def verify(self) -> bool:
        try:
            return _is_valid(self.issuer_key, self.signature, self._payload())
        except Exception:
            return False

    @staticmethod
    def issue(
        name: CordaX500Name, subject_key: PublicKey,
        issuer_key: PublicKey, issuer_private: PrivateKey,
    ) -> "NameKeyCertificate":
        cert = NameKeyCertificate(name, subject_key, issuer_key, b"")
        return dataclasses.replace(
            cert, signature=_sign(issuer_private, cert._payload())
        )


@dataclasses.dataclass(frozen=True)
class PartyAndCertificate:
    """A party plus its certificate path back to a trust root
    (reference: PartyAndCertificate.kt)."""

    party: Party
    cert_path: tuple  # tuple[NameKeyCertificate, ...] leaf-first

    def verify(self, trust_root_key: PublicKey) -> bool:
        """Leaf binds the party's name/key; each link is signed by the next
        issuer; the last issuer must be the trust root."""
        if not self.cert_path:
            return False
        leaf = self.cert_path[0]
        if leaf.name != self.party.name or leaf.subject_key != self.party.owning_key:
            return False
        for i, cert in enumerate(self.cert_path):
            if not cert.verify():
                return False
            nxt = (
                self.cert_path[i + 1].subject_key
                if i + 1 < len(self.cert_path)
                else trust_root_key
            )
            if cert.issuer_key != nxt:
                return False
        return True


register_custom(
    CordaX500Name, "identity.CordaX500Name",
    to_fields=lambda n: {"s": str(n)},
    from_fields=lambda d: CordaX500Name.parse(d["s"]),
)
register_custom(
    Party, "identity.Party",
    to_fields=lambda p: {"name": p.name, "key": p.owning_key},
    from_fields=lambda d: Party(d["name"], d["key"]),
)
register_custom(
    AnonymousParty, "identity.AnonymousParty",
    to_fields=lambda p: {"key": p.owning_key},
    from_fields=lambda d: AnonymousParty(d["key"]),
)
register_custom(
    NameKeyCertificate, "identity.NameKeyCertificate",
    to_fields=lambda c: {
        "name": c.name, "subject_key": c.subject_key,
        "issuer_key": c.issuer_key, "signature": c.signature,
    },
    from_fields=lambda d: NameKeyCertificate(
        d["name"], d["subject_key"], d["issuer_key"], d["signature"]
    ),
)
register_custom(
    PartyAndCertificate, "identity.PartyAndCertificate",
    to_fields=lambda p: {"party": p.party, "path": list(p.cert_path)},
    from_fields=lambda d: PartyAndCertificate(d["party"], tuple(d["path"])),
)
