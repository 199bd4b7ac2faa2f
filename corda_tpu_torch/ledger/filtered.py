"""FilteredTransaction: Merkle tear-offs for selective disclosure (copy of
corda_tpu/ledger/filtered.py; the same bytes under the same CBE names).

Capability parity with the reference's ``FilteredTransaction``
(core/.../transactions/MerkleTransaction.kt:86-190): a filtered view reveals
a chosen subset of components (e.g. only commands for an oracle, only
inputs+timewindow for a non-validating notary) plus the Merkle proofs that
tie them to the original transaction id — the verifier of a tear-off learns
nothing about hidden components beyond their existence.

Structure: for each group with revealed components, a PartialMerkleTree over
that group's leaf row (revealed leaf indices included, sibling hashes for
the rest) plus the revealed components' bytes and nonces; for every group, a
claimed group root; the top-level tree over group roots reproduces the id.
"""

from __future__ import annotations

import dataclasses

from ..crypto import (
    MerkleTree,
    PartialMerkleTree,
    SecureHash,
    ZERO_HASH,
)
from ..serialization import decode, encode, register_custom

from .states import TransactionVerificationException
from .wire import (
    ComponentGroupType,
    NUM_GROUPS,
    WireTransaction,
    component_leaf_hash,
    component_nonce,
    group_merkle_root,
)


class FilteredTransactionVerificationException(TransactionVerificationException):
    pass


@dataclasses.dataclass(frozen=True)
class FilteredComponent:
    """One revealed component: bytes + its position + its nonce."""

    group: int
    index: int
    opaque_bytes: bytes
    nonce: SecureHash


@dataclasses.dataclass(frozen=True)
class FilteredGroup:
    """Revealed slice of one component group."""

    group: int
    components: tuple          # tuple[FilteredComponent, ...]
    partial_tree: PartialMerkleTree


@dataclasses.dataclass(frozen=True)
class FilteredTransaction:
    """Reference: FilteredTransaction.buildFilteredTransaction (:99) /
    verify (:176) / checkWithFun."""

    id: SecureHash
    group_roots: tuple         # tuple[SecureHash, ...] — one per group
    filtered_groups: tuple     # tuple[FilteredGroup, ...]

    # ------------------------------------------------------------ build
    @staticmethod
    def build(wtx: WireTransaction, predicate) -> "FilteredTransaction":
        """Reveal every component for which ``predicate(component, group)``
        is true."""
        roots = wtx.group_roots()
        fgroups = []
        for g in ComponentGroupType:
            comps = wtx.components(g)
            if not comps:
                continue
            keep = [
                i for i, c in enumerate(comps) if predicate(c, g)
            ]
            if not keep:
                continue
            leaves = wtx.group_leaf_hashes(g)
            tree = MerkleTree.build(leaves)
            fgroups.append(
                FilteredGroup(
                    group=int(g),
                    components=tuple(
                        FilteredComponent(
                            int(g), i, encode(comps[i]),
                            component_nonce(wtx.privacy_salt, int(g), i),
                        )
                        for i in keep
                    ),
                    partial_tree=PartialMerkleTree.build(tree, keep),
                )
            )
        return FilteredTransaction(
            id=wtx.id, group_roots=tuple(roots), filtered_groups=tuple(fgroups)
        )

    # ------------------------------------------------------------ verify
    def verify(self) -> None:
        """Check every proof chains to ``id`` (reference:
        FilteredTransaction.verify, :176). Raises on any inconsistency —
        this runs on adversarial input (oracles, non-validating notaries)."""
        if len(self.group_roots) != NUM_GROUPS:
            raise FilteredTransactionVerificationException(
                self.id, f"expected {NUM_GROUPS} group roots"
            )
        top = MerkleTree.build(list(self.group_roots)).root
        if top != self.id:
            raise FilteredTransactionVerificationException(
                self.id, "group roots do not hash to the transaction id"
            )
        seen_groups = set()
        for fg in self.filtered_groups:
            if not (0 <= fg.group < NUM_GROUPS):
                raise FilteredTransactionVerificationException(
                    self.id, f"bad group ordinal {fg.group}"
                )
            if fg.group in seen_groups:
                raise FilteredTransactionVerificationException(
                    self.id, f"duplicate filtered group {fg.group}"
                )
            seen_groups.add(fg.group)
            if not fg.components:
                raise FilteredTransactionVerificationException(
                    self.id, f"filtered group {fg.group} reveals nothing"
                )
            # each revealed component's leaf hash must appear at its claimed
            # index in the partial tree
            claimed = dict(fg.partial_tree.included)
            if len(fg.components) != len(claimed):
                raise FilteredTransactionVerificationException(
                    self.id, "revealed components != proof leaves"
                )
            for comp in fg.components:
                if comp.group != fg.group:
                    raise FilteredTransactionVerificationException(
                        self.id, "component/group mismatch"
                    )
                leaf = component_leaf_hash(comp.nonce, comp.opaque_bytes)
                if claimed.get(comp.index) != leaf:
                    raise FilteredTransactionVerificationException(
                        self.id,
                        f"component {fg.group}/{comp.index} fails its proof",
                    )
            if self.group_roots[fg.group] == ZERO_HASH:
                raise FilteredTransactionVerificationException(
                    self.id, "revealed components in an empty group"
                )
            if self.group_roots[fg.group] != fg.partial_tree.compute_root():
                raise FilteredTransactionVerificationException(
                    self.id, f"group {fg.group} proof root mismatch"
                )

    # ------------------------------------------------------------ access
    def components_of(self, group: ComponentGroupType) -> list:
        """Decode revealed components of a group (verify() first!)."""
        for fg in self.filtered_groups:
            if fg.group == int(group):
                return [decode(c.opaque_bytes) for c in fg.components]
        return []

    def check_all_components_visible(self, group: ComponentGroupType) -> None:
        """Raise unless *every* component of the group is revealed
        (reference: checkAllComponentsVisible — notaries use this to insist
        the inputs group is complete)."""
        root = self.group_roots[int(group)]
        if root == ZERO_HASH:
            return  # group genuinely empty
        for fg in self.filtered_groups:
            if fg.group == int(group):
                recomputed = group_merkle_root(
                    [
                        component_leaf_hash(c.nonce, c.opaque_bytes)
                        for c in sorted(fg.components, key=lambda c: c.index)
                    ]
                )
                if recomputed == root:
                    return
                raise FilteredTransactionVerificationException(
                    self.id, f"group {int(group)} is only partially visible"
                )
        raise FilteredTransactionVerificationException(
            self.id, f"group {int(group)} is hidden"
        )


register_custom(
    FilteredComponent, "ledger.FilteredComponent",
    to_fields=lambda c: {
        "group": c.group, "index": c.index,
        "opaque_bytes": c.opaque_bytes, "nonce": c.nonce,
    },
    from_fields=lambda d: FilteredComponent(
        d["group"], d["index"], d["opaque_bytes"], d["nonce"]
    ),
)
register_custom(
    FilteredGroup, "ledger.FilteredGroup",
    to_fields=lambda g: {
        "group": g.group, "components": list(g.components),
        "partial_tree": g.partial_tree,
    },
    from_fields=lambda d: FilteredGroup(
        d["group"], tuple(d["components"]), d["partial_tree"]
    ),
)
register_custom(
    FilteredTransaction, "ledger.FilteredTransaction",
    to_fields=lambda t: {
        "id": t.id, "group_roots": list(t.group_roots),
        "filtered_groups": list(t.filtered_groups),
    },
    from_fields=lambda d: FilteredTransaction(
        d["id"], tuple(d["group_roots"]), tuple(d["filtered_groups"])
    ),
)
