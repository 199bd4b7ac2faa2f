"""Identity and key-management services
(counterpart of corda_tpu/node/identity.py, copied whole).

Parity with the reference's node/.../services/identity/
(``InMemoryIdentityService``/``PersistentIdentityService`` — cert-validating
name↔key registry, anonymous-identity resolution) and node/.../services/keys/
(``KeyManagementService`` — fresh-key issuance, signing by owned key;
``freshCertificate`` in KMSUtils.kt issuing a child certificate off the node
identity for confidential identities).
"""

from __future__ import annotations

import threading

from ..crypto import (
    DEFAULT_SIGNATURE_SCHEME,
    CryptoError,
    KeyPair,
    PublicKey,
    SecureHash,
    SignatureMetadata,
    TransactionSignature,
    generate_keypair,
    sign_tx_id,
)
from ..ledger import (
    AnonymousParty,
    CordaX500Name,
    NameKeyCertificate,
    Party,
    PartyAndCertificate,
)


class UnknownAnonymousPartyError(Exception):
    pass


class IdentityService:
    """Well-known and confidential identity registry (reference:
    InMemoryIdentityService.kt / PersistentIdentityService.kt).

    Registration verifies the certificate path against the trust root when
    one is configured — an invalid chain is rejected, the property the
    reference enforces via CertPathValidator.
    """

    def __init__(self, trust_root_key: PublicKey | None = None,
                 well_known: list[PartyAndCertificate] | None = None):
        self._trust_root_key = trust_root_key
        self._lock = threading.RLock()
        self._by_key: dict[PublicKey, PartyAndCertificate] = {}
        self._by_name: dict[CordaX500Name, PartyAndCertificate] = {}
        # anonymous key → well-known party it belongs to
        self._anonymous: dict[PublicKey, Party] = {}
        self._anon_certs: dict[PublicKey, NameKeyCertificate] = {}
        for pc in well_known or []:
            self.register_identity(pc)

    def register_identity(self, pc: PartyAndCertificate) -> None:
        if self._trust_root_key is not None and not pc.verify(self._trust_root_key):
            raise CryptoError(f"certificate path for {pc.party} fails validation")
        with self._lock:
            self._by_key[pc.party.owning_key] = pc
            self._by_name[pc.party.name] = pc

    def register_anonymous_identity(
        self, anonymous: AnonymousParty, well_known: Party,
        certificate: NameKeyCertificate | None = None,
    ) -> None:
        """Bind a confidential key to its well-known owner. When a
        certificate is supplied it must be issued by the owner's key (the
        reference's swap-identities verification)."""
        if certificate is not None:
            if (certificate.subject_key != anonymous.owning_key
                    or certificate.issuer_key != well_known.owning_key
                    or certificate.name != well_known.name
                    or not certificate.verify()):
                raise CryptoError("anonymous identity certificate invalid")
        with self._lock:
            self._anonymous[anonymous.owning_key] = well_known
            if certificate is not None:
                self._anon_certs[anonymous.owning_key] = certificate

    def anonymous_binding(self, anonymous) -> tuple | None:
        """(anonymous, well_known, certificate) for a registered
        confidential key we hold the certificate for — the unit
        IdentitySyncFlow ships to counterparties."""
        with self._lock:
            well_known = self._anonymous.get(anonymous.owning_key)
            cert = self._anon_certs.get(anonymous.owning_key)
        if well_known is None or cert is None:
            return None
        return (anonymous, well_known, cert)

    def party_from_key(self, key: PublicKey) -> Party | None:
        with self._lock:
            pc = self._by_key.get(key)
            return pc.party if pc else None

    def party_from_name(self, name: CordaX500Name) -> Party | None:
        with self._lock:
            pc = self._by_name.get(name)
            return pc.party if pc else None

    def certificate_from_key(self, key: PublicKey) -> PartyAndCertificate | None:
        with self._lock:
            return self._by_key.get(key)

    def well_known_party_from_anonymous(self, party) -> Party | None:
        """Resolve AnonymousParty → Party (reference:
        IdentityService.wellKnownPartyFromAnonymous)."""
        if isinstance(party, Party):
            return self.party_from_key(party.owning_key) or party
        with self._lock:
            known = self._anonymous.get(party.owning_key)
        if known is not None:
            return known
        return self.party_from_key(party.owning_key)

    def require_well_known(self, party) -> Party:
        resolved = self.well_known_party_from_anonymous(party)
        if resolved is None:
            raise UnknownAnonymousPartyError(str(party))
        return resolved

    def all_identities(self) -> list[PartyAndCertificate]:
        with self._lock:
            return list(self._by_key.values())


class KeyManagementService:
    """Owns the node's signing keys (reference: KeyManagementService +
    E2ETestKeyManagementService / PersistentKeyManagementService).

    ``fresh_key_and_cert`` issues a new confidential key with a certificate
    signed by the node's identity key (reference: KMSUtils.freshCertificate)
    and registers it with the identity service.
    """

    def __init__(self, initial_keys: list[KeyPair] | None = None,
                 identity_service: IdentityService | None = None):
        self._lock = threading.RLock()
        self._keys: dict[PublicKey, KeyPair] = {}
        self._identity_service = identity_service
        for kp in initial_keys or []:
            self._keys[kp.public] = kp

    @property
    def keys(self) -> set[PublicKey]:
        with self._lock:
            return set(self._keys)

    def add_key(self, kp: KeyPair) -> None:
        with self._lock:
            self._keys[kp.public] = kp

    def fresh_key(self, scheme_id: int = DEFAULT_SIGNATURE_SCHEME) -> PublicKey:
        kp = generate_keypair(scheme_id)
        self.add_key(kp)
        return kp.public

    def fresh_key_and_cert(
        self, identity: PartyAndCertificate, identity_keypair: KeyPair,
        scheme_id: int = DEFAULT_SIGNATURE_SCHEME,
    ) -> tuple[AnonymousParty, NameKeyCertificate]:
        pub = self.fresh_key(scheme_id)
        cert = NameKeyCertificate.issue(
            identity.party.name, pub, identity_keypair.public,
            identity_keypair.private,
        )
        anon = AnonymousParty(pub)
        if self._identity_service is not None:
            self._identity_service.register_anonymous_identity(
                anon, identity.party, cert
            )
        return anon, cert

    def fresh_confidential_identity(
        self, identity: Party, scheme_id: int = DEFAULT_SIGNATURE_SCHEME,
    ) -> tuple[AnonymousParty, NameKeyCertificate]:
        """Mint a fresh anonymous key certified by ``identity``'s key,
        which must be one of ours (the public face of fresh_key_and_cert
        for swap-identities flows)."""
        kp = self._require(identity.owning_key)
        return self.fresh_key_and_cert(
            PartyAndCertificate(identity, ()), kp, scheme_id
        )

    def _require(self, key: PublicKey) -> KeyPair:
        with self._lock:
            kp = self._keys.get(key)
        if kp is None:
            raise CryptoError(f"no private key known for {key.to_string_short()}")
        return kp

    def sign(self, tx_id: SecureHash, key: PublicKey) -> TransactionSignature:
        kp = self._require(key)
        return sign_tx_id(kp.private, kp.public, tx_id)

    def sign_bytes(self, data: bytes, key: PublicKey) -> bytes:
        from ..crypto import sign as raw_sign

        return raw_sign(self._require(key).private, data)

    def filter_my_keys(self, candidates) -> list[PublicKey]:
        with self._lock:
            return [k for k in candidates if k in self._keys]
