"""Finance states, commands and contracts (counterpart of corda_tpu/finance):
Cash, with the fungible-asset verifier the validating notary runs."""

from .contracts import (
    CASH_PROGRAM_ID,
    Cash,
    CashState,
    Exit,
    Issue,
    Move,
    fungible_move_rows,
    verify_fungible_asset,
    verify_fungible_asset_batch,
)

__all__ = [
    "CASH_PROGRAM_ID", "Cash", "CashState", "Exit", "Issue", "Move",
    "fungible_move_rows", "verify_fungible_asset", "verify_fungible_asset_batch",
]
