"""Finance states, commands, contracts and flows (counterpart of
corda_tpu/finance): Cash, Commodity, CommercialPaper and Obligation, with
the fungible-asset verifier the validating notary and the back-chain
resolve run, and the Cash issue, payment and exit flows."""

from .contracts import (
    CASH_PROGRAM_ID,
    COMMODITY_PROGRAM_ID,
    CP_PROGRAM_ID,
    OBLIGATION_PROGRAM_ID,
    Cash,
    CashState,
    CommercialPaper,
    CommercialPaperState,
    Commodity,
    CommodityState,
    Exit,
    Issue,
    Move,
    Obligation,
    ObligationState,
    Redeem,
    Settle,
    fungible_move_rows,
    verify_fungible_asset,
    verify_fungible_asset_batch,
)
from .flows import CashExitFlow, CashIssueFlow, CashPaymentFlow, select_cash

__all__ = [
    "CASH_PROGRAM_ID", "COMMODITY_PROGRAM_ID", "CP_PROGRAM_ID", "OBLIGATION_PROGRAM_ID",
    "Cash", "CashState", "CommercialPaper", "CommercialPaperState", "Commodity",
    "CommodityState", "Exit", "Issue", "Move", "Obligation", "ObligationState", "Redeem",
    "Settle", "fungible_move_rows", "verify_fungible_asset", "verify_fungible_asset_batch",
    "CashExitFlow", "CashIssueFlow", "CashPaymentFlow", "select_cash",
]
