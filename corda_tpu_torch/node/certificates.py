"""Node certificate provisioning for the secure fabric (the port's copy of
corda_tpu/node/certificates.py, import root changed).

Role parity with the reference's certificate story: every node owns an
identity certificate chaining to the network trust root, stored under
``<base>/certificates`` (reference: node/.../utilities/X509Utilities.kt +
KeyStoreUtilities.kt — keystores created by ``initCertificate``,
AbstractNode.kt:204), and in dev mode the certificates are auto-issued
from a WELL-KNOWN dev CA whose private key ships with the platform
(reference: the published dev certificates behind ``devMode``,
NodeConfiguration.kt:25 — explicitly not a secret, exactly like here).

Production mode (``dev_mode = false``) refuses to auto-provision: the
operator must place ``identity.cbe`` and ``truststore.cbe`` (issued by the
real network operator's root) in the certificates directory.
"""

from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path

from corda_tpu_torch.crypto import KeyPair, PublicKey, derive_keypair_from_entropy
from corda_tpu_torch.ledger import CordaX500Name, Party
from corda_tpu_torch.ledger.identity import NameKeyCertificate, PartyAndCertificate
from corda_tpu_torch.serialization import deserialize, serialize

# The dev-mode network root: deterministic, public, NOT a secret — any peer
# accepting it accepts dev-tier security, the same trust model as the
# reference's checked-in dev CA keystores.
_DEV_ROOT_ENTROPY = hashlib.sha256(b"corda-tpu dev network root CA v1").digest()


def dev_trust_root() -> KeyPair:
    from corda_tpu_torch.crypto.schemes import EDDSA_ED25519_SHA512

    return derive_keypair_from_entropy(EDDSA_ED25519_SHA512, _DEV_ROOT_ENTROPY)


@dataclasses.dataclass(frozen=True)
class NodeIdentity:
    """A node's fabric credentials: certified identity + signing key +
    the trust root it (and every peer it accepts) chains to."""

    certificate: PartyAndCertificate
    keypair: KeyPair
    trust_root: PublicKey

    @property
    def party(self) -> Party:
        return self.certificate.party


def issue_identity(
    name: CordaX500Name | str, keypair: KeyPair, ca: KeyPair | None = None
) -> NodeIdentity:
    """Issue a root-signed identity certificate (dev CA by default)."""
    if isinstance(name, str):
        name = CordaX500Name.parse(name)
    ca = ca or dev_trust_root()
    leaf = NameKeyCertificate.issue(name, keypair.public, ca.public, ca.private)
    cert = PartyAndCertificate(Party(name, keypair.public), (leaf,))
    return NodeIdentity(cert, keypair, ca.public)


def save_identity(cert_dir: str | Path, ident: NodeIdentity) -> None:
    d = Path(cert_dir)
    d.mkdir(parents=True, exist_ok=True)
    (d / "identity.cbe").write_bytes(serialize({
        "certificate": ident.certificate,
        "public": ident.keypair.public,
        "private": ident.keypair.private,
    }))
    (d / "truststore.cbe").write_bytes(serialize({"root": ident.trust_root}))


def load_identity(cert_dir: str | Path) -> NodeIdentity:
    d = Path(cert_dir)
    ident = deserialize((d / "identity.cbe").read_bytes())
    trust = deserialize((d / "truststore.cbe").read_bytes())
    ni = NodeIdentity(
        ident["certificate"],
        KeyPair(ident["public"], ident["private"]),
        trust["root"],
    )
    if not ni.certificate.verify(ni.trust_root):
        raise ValueError(
            f"{d}/identity.cbe does not chain to {d}/truststore.cbe"
        )
    return ni


def node_certificates(
    base_directory: str | Path, legal_name: str, *, dev_mode: bool = True,
    keypair: KeyPair | None = None,
) -> NodeIdentity:
    """Load ``<base>/certificates``, or in dev mode provision it from the
    dev CA (reference: initCertificate under devMode, AbstractNode.kt:204).
    The issued keypair persists, so a restarted node keeps its identity."""
    cert_dir = Path(base_directory) / "certificates"
    if (cert_dir / "identity.cbe").exists():
        ident = load_identity(cert_dir)
        expected = CordaX500Name.parse(str(legal_name))
        if ident.party.name != expected:
            raise ValueError(
                f"certificates at {cert_dir} are for {ident.party.name}, "
                f"node is {expected}"
            )
        return ident
    if not dev_mode:
        raise FileNotFoundError(
            f"no identity at {cert_dir} and devMode is off — provision "
            "identity.cbe/truststore.cbe from the network operator"
        )
    from corda_tpu_torch.crypto import generate_keypair

    ident = issue_identity(legal_name, keypair or generate_keypair())
    save_identity(cert_dir, ident)
    return ident
